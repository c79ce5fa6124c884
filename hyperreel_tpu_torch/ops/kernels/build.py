"""Build and load the port's CUDA kernels (csrc/*.cu) on first use.

Each source of csrc/ is compiled by its own `nvcc -gencode
arch=compute_90a,code=sm_90a -std=c++17 -O3 -c -Xcompiler -fPIC` process,
all started together, and the objects are linked into one shared library
with a plain C interface, which ctypes loads. The library goes to
build/hyperreel_tpu_torch/ under the checkout root (listed in .gitignore)
and is rebuilt whenever a source or header (csrc/*.cuh) is newer than it.
Nothing here runs at import time.
"""

import ctypes
import os
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / \
    "hyperreel_tpu_torch"
LIB_NAME = "libhyperreel_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]


class ActLeaf(ctypes.Structure):
    """Mirror of csrc/pack_build.cuh ActLeaf."""
    _fields_ = [("kind", ctypes.c_int)] + [
        (n, ctypes.c_float) for n in ("inner", "outer", "shift", "a")]


PACK_ACT_LEAVES = 2


class Act(ctypes.Structure):
    """Mirror of csrc/pack_build.cuh PackAct."""
    _fields_ = [("n", ctypes.c_int), ("c0", ctypes.c_float),
                ("c", ctypes.c_float * PACK_ACT_LEAVES),
                ("f", ActLeaf * PACK_ACT_LEAVES)]


class MlpLayer(ctypes.Structure):
    _fields_ = [("w", ctypes.c_void_p), ("b", ctypes.c_void_p)] + [
        (n, ctypes.c_int) for n in ("k0", "k", "n", "act")]


PACK_MAX_LAYERS = 12
PACK_MAX_S = 64
PACK_MAX_SLABS = 96
PACK_MAX_STRIPS = 12
PACK_STRIP_CHANNELS = 6


class PackParams(ctypes.Structure):
    """Mirror of csrc/pack_build.cu PackParams."""
    _fields_ = [(n, ctypes.c_int) for n in
                ("B", "S", "P", "cin", "xcol", "n_layers", "bf16")] + [
        ("leaky", ctypes.c_float),
        ("layer", MlpLayer * PACK_MAX_LAYERS),
        ("foff", ctypes.c_int * 7), ("act", Act * 10),
                ("samples", ctypes.c_float * PACK_MAX_S),
                ("z_scale", ctypes.c_float * PACK_MAX_S),
                ("aabb_lo", ctypes.c_float * 3),
                ("aabb_inv", ctypes.c_float * 3),
                ("contract", ctypes.c_int), ("contract_samples", ctypes.c_int)
                ] + [(n, ctypes.c_float) for n in (
                    "c_start_r", "c_inv_end_r", "c_r_scale", "c_start_d",
                    "c_inv_end_d", "c_d_scale")] + [
        ("wt", ctypes.c_void_p), ("wt_rows", ctypes.c_int),
        ("n_slabs", ctypes.c_int),
        ("slab_rows", ctypes.c_int * PACK_MAX_SLABS),
        ("n_strips", ctypes.c_int),
        ("strip_fc", (ctypes.c_int * PACK_STRIP_CHANNELS) * PACK_MAX_STRIPS),
        ("strip_s", (ctypes.c_int * 2) * PACK_MAX_STRIPS),
        ("k", ctypes.c_int), ("stride", ctypes.c_int),
        ("far", ctypes.c_float), ("lact", Act), ("generic", ctypes.c_int),
        ("lpl", ctypes.c_int)]


# csrc/shade_core.cuh kMaxWb: the SH basis of degree 4 over K5's [8, 8, 8]
# appearance channels, [75, 24]
SHADE_MAX_WB = 1800


class ShadeParams(ctypes.Structure):
    """Mirror of csrc/shade_core.cuh ShadeParams."""
    _fields_ = [(n, ctypes.c_int) for n in
                ("B", "S", "W", "H", "TW", "TH", "C", "nd")] + [
        ("distance_scale", ctypes.c_float),
        ("wb", ctypes.c_float * SHADE_MAX_WB),
        ("rgb", ctypes.c_int), ("weights", ctypes.c_int),
        ("nb", ctypes.c_int)]


class PatchParams(ctypes.Structure):
    """Mirror of csrc/patch_core.cuh PatchParams."""
    _fields_ = [(n, ctypes.c_int) for n in
                ("B", "S", "W", "H", "C", "R", "px", "py", "phase_major",
                 "m0", "m1")]


PATCH_MAX_AXES = 3


class BlendPlane(ctypes.Structure):
    """Mirror of csrc/patch_blend.cu BlendPlane."""
    _fields_ = [("ptab", ctypes.c_void_p), ("feats", ctypes.c_void_p)] + [
        (n, ctypes.c_int) for n in ("W", "H", "C", "m0", "m1")]


class BlendParams(ctypes.Structure):
    """Mirror of csrc/patch_blend.cu BlendParams."""
    _fields_ = [(n, ctypes.c_int) for n in
                ("B", "S", "R", "px", "py", "phase_major", "na")] + [
        ("plane", BlendPlane * PATCH_MAX_AXES)]


class MultiAxis(ctypes.Structure):
    """Mirror of csrc/multi_core.cuh MultiAxis."""
    _fields_ = [("table", ctypes.c_void_p), ("line", ctypes.c_void_p)] + [
        (n, ctypes.c_int) for n in ("W", "H", "L", "TH")]


class MultiParams(ctypes.Structure):
    """Mirror of csrc/multi_core.cuh MultiParams."""
    _fields_ = [(n, ctypes.c_int) for n in ("B", "S")] + [
        ("distance_scale", ctypes.c_float), ("axis", MultiAxis * 3),
        ("ch", ctypes.c_int * 3), ("nd", ctypes.c_int * 3),
        ("wb", ctypes.c_float * SHADE_MAX_WB),
        ("rgb", ctypes.c_int), ("weights", ctypes.c_int),
        ("nb", ctypes.c_int)]


@dataclass
class KernelLibrary:
    lib: ctypes.CDLL
    build_seconds: float     # 0.0 when an up-to-date library was reused
    compiler_log: str
    # per multi-axis kernel (MULTI_KERNELS), the layouts it is built for:
    # each a tuple of (axis, C, density channels) per plane
    # (csrc/multi_core.cuh Layout844, Layout888 and PatchLayout own them)
    multi_layouts: dict


_LOADED = None
# the multi-axis kernels in the order of csrc/shade_multi.cu multi_layouts
MULTI_KERNELS = ("shade_multi", "shade_multi_preblended", "shade_multi_patch")


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "the machine with the card")
    return path


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _build(out):
    """Compile every source in its own nvcc process, all at once, then
    link; returns (seconds, the compilers' output)."""
    sources, _ = _sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    t0 = time.perf_counter()
    try:
        procs = [(src, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
             str(work / (src.stem + ".o")), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            for src in sources]
        log, failed = [], []
        for src, proc in procs:
            text = proc.communicate()[0]
            log.append(f"== {src.name}\n{text}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "".join(log))
        tmp = work / LIB_NAME
        res = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp),
             *(str(work / (src.stem + ".o")) for src in sources)],
            capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{res.stdout}\n{res.stderr}")
        os.replace(tmp, out)   # atomic: a concurrent build never sees half
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return time.perf_counter() - t0, "".join(log)


def load_library():
    """The loaded kernel library, built first if missing or stale."""
    global _LOADED
    if _LOADED is not None:
        return _LOADED
    out = BUILD_DIR / LIB_NAME
    newest = max(p.stat().st_mtime for group in _sources() for p in group)
    seconds, log = 0.0, ""
    if not out.exists() or out.stat().st_mtime < newest:
        seconds, log = _build(out)
    lib = ctypes.CDLL(str(out))
    vp = ctypes.c_void_p
    shade_p, patch_p = ctypes.POINTER(ShadeParams), ctypes.POINTER(PatchParams)
    multi_p = ctypes.POINTER(MultiParams)
    for fn, args in (
            (lib.pack_build_launch,
             [vp, vp, vp, ctypes.POINTER(PackParams), vp]),
            (lib.shade_launch, [vp, vp, vp, vp, vp, shade_p, vp]),
            (lib.shade_preblended_launch, [vp, vp, vp, vp, vp, shade_p, vp]),
            (lib.shade_patch_launch,
             [vp, vp, vp, vp, vp, vp, shade_p, patch_p, vp]),
            (lib.patch_blend_launch,
             [vp, vp, ctypes.POINTER(BlendParams), vp]),
            (lib.shade_multi_launch,
             [vp, vp, vp, multi_p, ctypes.POINTER(ctypes.c_int), vp]),
            (lib.shade_multi_preblended_launch, [vp, vp, vp, multi_p, vp]),
            (lib.shade_multi_patch_launch,
             [vp, vp, vp, vp, multi_p, patch_p, vp]),
            (lib.composite_launch, [vp, vp, vp, vp, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_float, vp])):
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.pack_rays_per_block.argtypes = [ctypes.POINTER(PackParams)]
    lib.pack_rays_per_block.restype = ctypes.c_int
    for fn, struct in ((lib.pack_params_size, PackParams),
                       (lib.shade_params_size, ShadeParams),
                       (lib.patch_params_size, PatchParams),
                       (lib.blend_params_size, BlendParams),
                       (lib.multi_params_size, MultiParams)):
        fn.argtypes = []
        fn.restype = ctypes.c_int
        if fn() != ctypes.sizeof(struct):
            raise RuntimeError(
                f"{struct.__name__}: C size {fn()} != ctypes size "
                f"{ctypes.sizeof(struct)}")
    lib.multi_layouts.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.multi_layouts.restype = ctypes.c_int
    layouts = {}
    for k, name in enumerate(MULTI_KERNELS):
        n = lib.multi_layouts(k, None)
        if n < 1:
            raise RuntimeError(f"multi_layouts({k}) returned {n}")
        c_nd = (ctypes.c_int * (6 * n))()
        lib.multi_layouts(k, c_nd)
        layouts[name] = tuple(
            tuple((a, c_nd[6 * i + 2 * a], c_nd[6 * i + 2 * a + 1])
                  for a in range(3)) for i in range(n))
    _LOADED = KernelLibrary(lib, seconds, log, layouts)
    return _LOADED


def check_launch(rc, name):
    """Raise on a non-zero cudaError_t returned by a C launcher."""
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {rc}")
