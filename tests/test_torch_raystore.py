"""The port's ray store (hyperreel_tpu_torch/data/raystore.py, its sampler
built from hyperreel_tpu_torch/csrc/raystore.cpp) against the JAX
package's on one .npy: the same seed and thread count draw the same rows,
gather and the batch iterator give the same rows, all to the bit. A
library that cannot be built raises; nothing samples with numpy in its
place."""

import sys

import numpy as np
import pytest

from hyperreel_tpu.data import raystore as jax_store
from hyperreel_tpu.data.base import RayDataset as JaxRays
from hyperreel_tpu_torch.data import raystore
from hyperreel_tpu_torch.data.base import RayDataset

N, CW = 5000, 8


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """The same rays written by both packages' create, each opened by its
    own store: (port store, JAX store)."""
    rng = np.random.default_rng(0)
    coords = rng.normal(size=(N, CW)).astype(np.float32)
    rgb = rng.uniform(size=(N, 3)).astype(np.float32)
    weights = rng.uniform(size=(N, 1)).astype(np.float32)
    d = tmp_path_factory.mktemp("stores")
    got = raystore.MmapRayStore.create(
        str(d / "port"), RayDataset(coords, rgb, weights), n_threads=3)
    want = jax_store.MmapRayStore.create(
        str(d / "jax.npy"), JaxRays(coords, rgb, weights))
    assert want._lib is not None          # the JAX store's native sampler
    np.testing.assert_array_equal(np.load(got.path), np.load(want.path))
    return got, want


def _same(a, b):
    assert sorted(a) == sorted(b) == ["rays", "rgb", "weights"]
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("n_threads", [1, 3, 8])
def test_sample_matches_the_jax_store(stores, n_threads):
    got, want = stores
    got.n_threads = want.n_threads = n_threads
    for seed in (0, 7, 2 ** 40 + 3):
        a, b = got.sample(1000, seed), want.sample(1000, seed)
        _same(a, b)
        # real rows of the store
        rows = np.concatenate([a["rays"], a["rgb"], a["weights"]], -1)
        idx = np.nonzero((got.data[None] == rows[:7, None]).all(-1))[1]
        np.testing.assert_array_equal(got.data[idx], rows[:7])
    assert not np.array_equal(got.sample(64, 1)["rays"],
                              got.sample(64, 2)["rays"])


def test_gather_and_batch_iterator_match_the_jax_store(stores):
    got, want = stores
    got.n_threads = want.n_threads = 3
    idx = np.random.default_rng(1).integers(0, N, 777)
    _same(got.gather(idx), want.gather(idx))
    np.testing.assert_array_equal(got.gather(idx)["rays"],
                                  np.load(got.path)[idx, :CW])
    for a, b, _ in zip(got.batch_iterator(300, seed=5),
                       want.batch_iterator(300, seed=5), range(3)):
        _same(a, b)
    with pytest.raises(IndexError):
        got.gather(np.array([0, N]))


def test_create_in_chunks_writes_the_jax_file(stores, tmp_path,
                                             monkeypatch):
    """create writes CREATE_CHUNK rows at a time; a chunk that does not
    divide the rows gives the same file as the JAX store's create."""
    monkeypatch.setattr(raystore, "CREATE_CHUNK", 777)
    src = stores[0]
    ds = RayDataset(*(src.data[:, s].copy() for s in (
        slice(0, CW), slice(CW, CW + 3), slice(CW + 3, CW + 4))))
    got = raystore.MmapRayStore.create(str(tmp_path / "chunked.npy"), ds)
    np.testing.assert_array_equal(np.load(got.path), np.load(stores[1].path))
    assert got.num_rays == N and got.coords_width == CW


def test_a_failed_build_raises_and_nothing_samples(stores, tmp_path,
                                                   monkeypatch):
    failing = [sys.executable, "-c", "import sys; sys.exit(3)"]
    with pytest.raises(RuntimeError, match="failed"):
        raystore.load_library(tmp_path / "a", cxx=failing)
    assert not (tmp_path / "a" / raystore.LIB_NAME).exists()
    # a store opened where the library cannot be built raises at once
    monkeypatch.setattr(raystore, "BUILD_DIR", tmp_path / "b")
    monkeypatch.setattr(raystore, "CXX", failing)
    with pytest.raises(RuntimeError, match="failed"):
        raystore.MmapRayStore(stores[0].path, CW)
    # and a library that cannot be loaded raises too
    (tmp_path / "c").mkdir()
    (tmp_path / "c" / raystore.LIB_NAME).write_text("not a library")
    with pytest.raises(OSError):
        raystore.load_library(tmp_path / "c")
