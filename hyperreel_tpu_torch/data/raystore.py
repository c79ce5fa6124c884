"""A memory-mapped ray store with a native C++ sampler (port of
hyperreel_tpu/data/raystore.py; SURVEY.md section 7, hard part 4: dynamic
scenes hold ~1e8 rays, which the reference keeps as resident torch tensors
and samples from Python).

The store is one float32 .npy on disk, rows [coords | rgb | weight],
opened with np.memmap; a batch is gathered by csrc/raystore.cpp in worker
threads, with replacement. The library is built with g++ at first use
into build/hyperreel_tpu_torch/ under the checkout root (git-ignored), and
again whenever the source is newer. There is no numpy sampler in its
place: a store whose library cannot be built or loaded raises, since
another sampler would draw other rows for the same seed.
"""

import ctypes
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "raystore.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / \
    "hyperreel_tpu_torch"
LIB_NAME = "libraystore.so"
CXX = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]
CREATE_CHUNK = 1 << 22      # rows written at a time by MmapRayStore.create

_LOADED = {}     # library path -> ctypes.CDLL


def load_library(build_dir=None, cxx=None):
    """The sampler's library in `build_dir` (BUILD_DIR), compiled with
    `cxx` (CXX) when it is missing or older than the source. A failed
    compile or load raises."""
    build_dir = Path(build_dir or BUILD_DIR)
    out = build_dir / LIB_NAME
    if str(out) in _LOADED:
        return _LOADED[str(out)]
    if not out.exists() or out.stat().st_mtime < SOURCE.stat().st_mtime:
        build_dir.mkdir(parents=True, exist_ok=True)
        # compiled beside its target, then renamed over it: another
        # process loading the library meanwhile sees the old one or the
        # new one whole
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
        os.close(fd)
        try:
            res = subprocess.run([*(cxx or CXX), str(SOURCE), "-o", tmp],
                                 capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"building the ray store's sampler "
                                   f"failed ({res.returncode}):\n"
                                   f"{res.stdout}{res.stderr}")
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    lib = ctypes.CDLL(str(out))
    lib.raystore_sample.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint64, ctypes.c_int]
    lib.raystore_sample.restype = None
    lib.raystore_gather.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int]
    lib.raystore_gather.restype = None
    _LOADED[str(out)] = lib
    return lib


class MmapRayStore:
    """A disk-backed [N, C] float32 ray store with native batch sampling.
    `n_threads`: the sampler's worker threads (min(cores, 8) by default);
    each draws its own slice of a batch from its own generator, so the
    rows of a seed depend on it."""

    def __init__(self, path, coords_width, n_threads=None):
        self.path = path
        self.data = np.load(path, mmap_mode="r")
        if self.data.dtype != np.float32 or self.data.ndim != 2:
            raise ValueError(f"{path}: a ray store is a 2-D float32 array, "
                             f"not {self.data.dtype} {self.data.shape}")
        self.coords_width = coords_width
        self.n_threads = n_threads or min(os.cpu_count() or 1, 8)
        self._lib = load_library()

    @classmethod
    def create(cls, path, dataset, n_threads=None):
        """Write a RayDataset's rows to `path` (.npy added where missing),
        CREATE_CHUNK rows at a time (the file is the JAX package's, which
        concatenates them in memory first), and open it."""
        path = path if path.endswith(".npy") else path + ".npy"
        cw = dataset.all_coords.shape[-1]
        rows = np.lib.format.open_memmap(
            path, mode="w+", dtype=np.float32,
            shape=(dataset.num_rays, cw + 4))
        for s in range(0, dataset.num_rays, CREATE_CHUNK):
            sl = slice(s, s + CREATE_CHUNK)
            rows[sl, :cw] = dataset.all_coords[sl]
            rows[sl, cw:cw + 3] = dataset.all_rgb[sl]
            rows[sl, cw + 3:] = dataset.all_weights[sl]
        rows.flush()
        del rows
        return cls(path, cw, n_threads)

    @property
    def num_rays(self):
        return self.data.shape[0]

    def sample(self, batch_size, seed):
        """`batch_size` rows drawn with replacement, a function of `seed`
        and n_threads."""
        out = np.empty((batch_size, self.data.shape[1]), np.float32)
        self._lib.raystore_sample(
            self.data.ctypes.data, self.data.shape[0], self.data.shape[1],
            out.ctypes.data, batch_size, np.uint64(seed), self.n_threads)
        return self._split(out)

    def gather(self, indices):
        """The rows at `indices` (each in [0, num_rays))."""
        indices = np.ascontiguousarray(indices, np.int64)
        if len(indices) and (indices.min() < 0
                             or indices.max() >= self.num_rays):
            raise IndexError(f"ray store of {self.num_rays} rows: indices "
                             f"in [{indices.min()}, {indices.max()}]")
        out = np.empty((len(indices), self.data.shape[1]), np.float32)
        self._lib.raystore_gather(
            self.data.ctypes.data, self.data.shape[0], self.data.shape[1],
            indices.ctypes.data, out.ctypes.data, len(indices),
            self.n_threads)
        return self._split(out)

    def _split(self, rows):
        cw = self.coords_width
        return {
            "rays": rows[:, :cw],
            "rgb": rows[:, cw:cw + 3],
            "weights": rows[:, cw + 3:cw + 4],
        }

    def batch_iterator(self, batch_size, seed=0):
        """Infinite sampler: batch k of `seed` is sample(batch_size, seed *
        1,000,003 + k)."""
        step = 0
        while True:
            yield self.sample(batch_size, seed * 1_000_003 + step)
            step += 1
