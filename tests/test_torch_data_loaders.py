"""The port's dataset loaders (hyperreel_tpu_torch/data/) against the JAX
package's on the same scene trees (tests/torch_data_fixtures.py): every
name of the JAX registry, both splits. The rays, colours, weights,
extras, dataset_info, image size and count, cameras, NDC parameters, camera
grid and a seeded batch are equal to the bit, except where the JAX loader
computes in jnp: technicolor's quaternions and the rotation vectors of
spaces and immersive, which the port computes in torch on the CPU (within
1e-6); and the colours of the
blob and hostile scenes, marched in torch (within 1e-5, as
tests/test_torch_train_step.py holds the blob scene's)."""

import numpy as np
import pytest

from hyperreel_tpu import data as jax_data
from hyperreel_tpu_torch import data as torch_data

from torch_data_fixtures import write_all

# the loaders whose rays go through a rotation computed in jnp (JAX) and
# torch (the port): their rays and poses within this
ROTATION_TOL = 1e-6
BLOB_RGB_TOL = 1e-5


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    return write_all(tmp_path_factory.mktemp("scenes"))


# name -> (scene, {split: loader kwargs}); the auxiliary datasets ("aux")
# are made from the llff scene's split, loaded by the same package; a scene
# of None is called with no directory (the synthetic datasets: their two
# cases are a static and a dynamic scene)
TECHNICOLOR = dict(img_wh=(32, 16), rows=2, cols=2, val_pairs=((1, 1),),
                   keyframe_step=2)
CASES = {
    "llff": ("llff", {"train": dict(downsample=1, val_skip=3),
                      "val": dict(downsample=1, val_skip=3)}),
    "blender": ("blender", {"train": dict(img_wh=(16, 16)),
                            "val": dict(img_wh=(16, 16))}),
    "donerf": ("donerf", {"train": dict(img_wh=(20, 20)),
                          "val": dict(img_wh=(20, 20), val_num=1)}),
    "technicolor": ("technicolor", {"train": TECHNICOLOR,
                                    "val": TECHNICOLOR}),
    "neural_3d": ("neural_3d", {
        "train": dict(img_wh=(32, 24), num_frames=5, keyframe_step=2),
        "val": dict(img_wh=(32, 24), num_frames=3)}),
    "immersive": ("immersive", {
        "train": dict(img_wh=(64, 48), num_frames=4, keyframe_step=1,
                      load_full_step=2, subsample_keyframe_step=3),
        "val": dict(img_wh=(64, 48), num_frames=2)}),
    "stanford": ("stanford", {
        "train": dict(rows=5, cols=5, step=2, val_pairs=((2, 2),)),
        "val": dict(rows=5, cols=5, step=2, val_pairs=((2, 2),))}),
    "shiny": ("llff", {"train": dict(downsample=2, val_skip=4),
                       "val": dict(downsample=2, val_skip=4)}),
    "spaces": ("spaces", {"train": dict(img_wh=(16, 12)),
                          "val": dict(img_wh=(16, 12))}),
    "eikonal": ("llff", {"train": dict(num_views=2, val_skip=3),
                         "val": dict(num_views=2, val_skip=3)}),
    "stanford_llff": ("llff", {"train": dict(downsample=1, val_skip=2),
                               "val": dict(downsample=1, val_skip=2)}),
    "dense_shiny": ("llff", {"train": dict(downsample=1, val_skip=5),
                             "val": dict(downsample=1, val_skip=5)}),
    "dense_blender": ("blender", {"train": dict(img_wh=(24, 24)),
                                  "val": dict(img_wh=(12, 12))}),
    "blender_lightfield": ("blender", {
        "train": dict(img_wh=(16, 16), rows=2, cols=2),
        "val": dict(img_wh=(8, 12), rows=1, cols=3, st_scale=0.5)}),
    "catacaustics": ("catacaustics", {"train": dict(img_wh=(24, 16)),
                                      "val": dict(img_wh=(12, 8))}),
    "video3d_static": ("video3d_static", {
        "train": dict(img_wh=(16, 16), val_skip=2),
        "val": dict(img_wh=(16, 16), val_skip=2, use_ndc=True)}),
    "video3d_time": ("video3d_time", {
        "train": dict(img_wh=(16, 16), keyframe_step=2),
        "val": dict(img_wh=(8, 8), use_reference=True)}),
    "video3d_ground_truth": ("video3d_static", {
        "train": dict(img_wh=(16, 16), val_skip=2),
        "val": dict(img_wh=(16, 16), val_skip=2, use_reference=True)}),
    "fourier": ("aux", {"train": {}, "val": {}}),
    "random_ray": ("aux", {"train": dict(n_rays=64, seed=1),
                           "val": dict(n_rays=32)}),
    "random_pixel": ("aux", {"train": dict(n_rays=64, seed=2),
                             "val": dict(n_rays=32)}),
    "synthetic_blobs": (None, {
        "train": dict(n_views=2, wh=(8, 6)),
        "val": dict(n_views=2, wh=(6, 4), dynamic=True, num_frames=3,
                    num_keyframes=2)}),
    "random": (None, {"train": dict(n_rays=100),
                      "val": dict(n_rays=70, dynamic=True, seed=3)}),
}
# further cases of one loader: neural_3d's importance subsampling;
# technicolor's keyframe subsampling at other fractions and offsets
EXTRA = {
    "neural_3d_importance": ("neural_3d", "neural_3d", dict(
        img_wh=(32, 24), num_frames=5, load_full_step=4,
        subsample_keyframe_step=2, subsample_mode="importance")),
    "immersive_importance": ("immersive", "immersive", dict(
        img_wh=(64, 48), num_frames=4, load_full_step=3,
        subsample_keyframe_step=2, subsample_mode="importance")),
    "technicolor_keyframes": ("technicolor", "technicolor", dict(
        TECHNICOLOR, load_full_step=4, subsample_keyframe_step=2,
        subsample_keyframe_frac=0.5, subsample_frac=0.25)),
    "technicolor_lightfield_step": ("technicolor", "technicolor", dict(
        TECHNICOLOR, val_pairs=(), lightfield_step=2)),
}
ROTATED = ("technicolor", "spaces", "immersive")


def _load(pkg, name, scene, split, kw, scenes):
    if name == "synthetic_blobs" and pkg is torch_data:
        kw = dict(kw, device="cpu")
    if scene is None:
        return pkg.get_dataset(name, **kw)
    if scene == "aux":
        base = pkg.get_dataset("llff", scenes["llff"], split=split,
                               downsample=1, val_skip=3)
        return pkg.get_dataset(name, base, **kw)
    return pkg.get_dataset(name, scenes[scene], split=split, **kw)


def _equal(got, want, tol, what):
    if want is None:
        assert got is None, what
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, what
    if tol:
        np.testing.assert_allclose(got, want, rtol=0, atol=tol,
                                   err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


def check_same(got, want, rot_tol=0.0, rgb_tol=0.0):
    _equal(got.all_coords, want.all_coords, rot_tol, "all_coords")
    _equal(got.all_rgb, want.all_rgb, rgb_tol, "all_rgb")
    _equal(got.all_weights, want.all_weights, 0, "all_weights")
    assert sorted(got.extras) == sorted(want.extras)
    for k in want.extras:
        _equal(got.extras[k], want.extras[k], 0, k)
    assert got.info() == want.info()
    assert tuple(got.img_wh) == tuple(want.img_wh)
    assert got.num_images == want.num_images
    _equal(got.poses, want.poses, rot_tol, "poses")
    _equal(got.intrinsics, want.intrinsics, 0, "intrinsics")
    assert got.ndc_params == want.ndc_params
    assert (got.num_rows, got.num_cols) == (want.num_rows, want.num_cols)
    a = next(got.batch_iterator(16, seed=3))
    b = next(want.batch_iterator(16, seed=3))
    assert sorted(a) == sorted(b)
    for k in b:
        _equal(a[k], b[k], rgb_tol if k == "rgb" else rot_tol, k)


def test_registry_names_equal_the_jax_registry():
    assert sorted(torch_data.dataset_dict) == sorted(jax_data.dataset_dict)
    assert sorted(CASES) == sorted(jax_data.dataset_dict)


@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_loader_matches_jax(scenes, name, split):
    scene, kws = CASES[name]
    kw = kws[split]
    want = _load(jax_data, name, scene, split, kw, scenes)
    got = _load(torch_data, name, scene, split, kw, scenes)
    assert want.num_rays > 0
    check_same(got, want,
               rot_tol=ROTATION_TOL if name in ROTATED else 0.0,
               rgb_tol=BLOB_RGB_TOL if name == "synthetic_blobs" else 0.0)


@pytest.mark.parametrize("case", sorted(EXTRA))
def test_loader_option_matches_jax(scenes, case):
    name, scene, kw = EXTRA[case]
    want = jax_data.get_dataset(name, scenes[scene], split="train", **kw)
    got = torch_data.get_dataset(name, scenes[scene], split="train", **kw)
    full = jax_data.get_dataset(name, scenes[scene], split="train",
                                **dict(kw, load_full_step=1))
    assert 0 < want.num_rays < full.num_rays     # the option subsampled
    check_same(got, want,
               rot_tol=ROTATION_TOL if name in ROTATED else 0.0)


@pytest.mark.parametrize("kw", [
    dict(n_views=2, wh=(8, 6)),
    dict(n_views=2, wh=(6, 4), dynamic=True, num_frames=3, num_keyframes=2,
         n_steps=128)], ids=["static", "dynamic"])
def test_hostile_scene_matches_jax(kw):
    """The hostile scene (not in the registry): its rays to the bit, its
    colours marched in torch within BLOB_RGB_TOL of the numpy march."""
    from hyperreel_tpu.data.synthetic import hostile_scene as jax_scene
    from hyperreel_tpu_torch.data.synthetic import hostile_scene

    check_same(hostile_scene(**kw, device="cpu"), jax_scene(**kw),
               rgb_tol=BLOB_RGB_TOL)
