"""The System of the port (hyperreel_tpu_torch/system.py) and its
visualizers (train/visualizers.py) against the JAX package's on
synthetic_blobs + tiny_static, both on the CPU from one set of weights
(the port's init, density redrawn, carried across by convert.py):
iters_per_epoch and the multiscale schedule, the render-path poses, the
spiral, validation with the visualizers, and a few-step fit across a grid
event resumed from a checkpoint of the same weights, the JAX steps' draws
injected (tests/torch_train_parity.py)."""

import copy
import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from hyperreel_tpu import config as JC
from hyperreel_tpu.system import System as JaxSystem
from hyperreel_tpu.train.checkpoint import save_checkpoint as jax_save
from hyperreel_tpu.train.trainer import TrainState as JaxState
from hyperreel_tpu.train import visualizers as JV
from hyperreel_tpu_torch import config as TC
from hyperreel_tpu_torch.convert import params_from_jax, params_to_jax
from hyperreel_tpu_torch.system import System
from hyperreel_tpu_torch.train import visualizers as TV
from hyperreel_tpu_torch.train.checkpoint import save_checkpoint
from hyperreel_tpu_torch.train.optim import tree_leaves
from hyperreel_tpu_torch.train.regularizers import tv_4000_defaults
from hyperreel_tpu_torch.train.trainer import TrainState

from torch_train_parity import (
    init_weights, jit_upsample, max_param_err, preset_cfg, record_jax_draws,
    training_cfg)

BASE = ["dataset.name=synthetic_blobs", "dataset.n_views=2",
        "dataset.wh=[12,12]", "model=tiny_static", "training.num_iters=10",
        "training.ray_chunk=64"]
VISUALIZERS = {
    "embedding": {"fields": ["points"]},
    "epipolar": {"v": 0.1, "t": 0.0, "H": 6},
    "focus": {"focal": -0.5, "ds": 0.5, "dt": 0.5, "aperture_samples": 2},
    "closest_view": {},
    "tensor": {}}


@pytest.fixture
def one_thread():
    """torch on one thread while the test runs: the System's many small
    CPU ops (the CLI's 128^3 density grid row by row, the fit's steps) run
    faster on one thread than on a pool, several times so where the
    suite's workers each spin a pool on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _systems(tmp_path, overrides=()):
    ov = BASE + list(overrides)
    jsys = JaxSystem(JC.load_config(overrides=ov + [
        f"params.save_dir={tmp_path / 'jax'}"]))
    tsys = System(TC.load_config(overrides=ov + [
        f"params.save_dir={tmp_path / 'port'}"]), device="cpu")
    return jsys, tsys


def _states(tsys, it=2000):
    """(JAX state, port state) on the port's init with the density grids
    redrawn uniform in [0, 1) (the init's are almost transparent)."""
    params = tsys.init_state().params
    rng = np.random.default_rng(1)
    for v in params["color"]["density"].values():
        v.copy_(torch.from_numpy(rng.uniform(0, 1, v.shape).astype(
            np.float32)))
    jp = jax.tree.map(jnp.asarray, params_to_jax(params))
    return JaxState(jp, None, it), TrainState(params, None, it)


def test_iters_per_epoch_and_multiscale_as_in_jax(tmp_path):
    for ov in ([], ["training.sample_with_replacement=false",
                    "training.batch_size=100"]):
        jsys, tsys = _systems(tmp_path, ov)
        assert tsys.iters_per_epoch == jsys.iters_per_epoch
        # the loader has no val split: train serves as val, as in JAX
        assert tsys.val_dataset is tsys.train_dataset
        assert jsys.val_dataset is jsys.train_dataset
    assert tsys.iters_per_epoch == 3          # ceil(288 / 100)
    jsys, tsys = _systems(tmp_path, [
        "training.multiscale=true", "training.scales=[2,1]",
        "training.scale_epochs=[0,5]"])
    for epoch in (0, 1, 5, 6, 9):
        assert tsys.update_data(epoch) == jsys.update_data(epoch), epoch
        assert tuple(tsys.train_dataset.img_wh) == \
            tuple(jsys.train_dataset.img_wh)
        np.testing.assert_array_equal(tsys.train_dataset.all_coords,
                                      jsys.train_dataset.all_coords)
    assert tuple(tsys.train_dataset.img_wh) == (12, 12)


def test_dataset_device_reaches_only_the_loaders_that_take_one():
    """get_dataset gives `device` to a loader whose signature takes one
    (the synthetic scenes march on it; the System passes its own) and not
    to one that only computes on the host: both load as the JAX
    package's."""
    from hyperreel_tpu.data import get_dataset as jax_get_dataset
    from hyperreel_tpu_torch.data import get_dataset
    for name, kw in (("synthetic_blobs", {"n_views": 1, "wh": (6, 4)}),
                     ("random", {"n_rays": 50})):
        want = jax_get_dataset(name, **kw)
        got = get_dataset(name, device="cpu", **kw)
        np.testing.assert_array_equal(got.all_coords, want.all_coords)
        assert np.abs(got.all_rgb - want.all_rgb).max() <= 1e-5


def test_render_path_poses_as_in_jax(tmp_path):
    jsys, tsys = _systems(tmp_path)
    for interpolate in (False, True):
        (wp, wk), (gp, gk) = (s.render_path_poses(6, interpolate)
                              for s in (jsys, tsys))
        assert np.abs(gp - wp).max() <= 1e-6 and np.abs(gk - wk).max() == 0
    # the dataset's poses: the spiral from their translations' percentiles
    rng = np.random.default_rng(0)
    poses = np.tile(np.eye(3, 4, dtype=np.float32), (4, 1, 1))
    poses[:, :, 3] = rng.normal(0, 0.3, (4, 3)).astype(np.float32)
    K = np.array([[10.0, 0, 6], [0, 10.0, 6], [0, 0, 1]], np.float32)
    for s in (jsys, tsys):
        s.train_dataset.poses, s.train_dataset.intrinsics = poses, K
    for interpolate in (False, True):
        (wp, wk), (gp, gk) = (s.render_path_poses(5, interpolate)
                              for s in (jsys, tsys))
        assert gp.shape[0] >= 5
        assert np.abs(gp - wp).max() <= 1e-6
        np.testing.assert_array_equal(gk, K)


def test_render_spiral_as_in_jax(tmp_path):
    jsys, tsys = _systems(tmp_path)
    js, ts = _states(tsys)
    want = jsys.render_spiral(js, n_poses=3)
    got, seconds = tsys.render_spiral(ts, n_poses=3)
    assert len(got) == len(want) == len(seconds) == 3
    for a, b in zip(want, got):
        assert b.dtype == np.uint8 and b.shape == a.shape == (12, 12, 3)
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    assert np.ptp(got[0]) > 10                # not a blank frame
    for s in (jsys, tsys):
        d = os.path.join(s.save_dir, "spiral")
        assert sorted(os.listdir(d)) == ["0000.png", "0001.png", "0002.png",
                                         "spiral.mp4"]
        assert os.path.getsize(os.path.join(d, "spiral.mp4")) > 0
    # no encoder: the frames stay, the video is skipped, as in JAX
    from hyperreel_tpu_torch.system import write_video
    assert write_video(str(tmp_path / "x.mp4"), [np.zeros((4, 4))]) is None


def test_validate_and_visualizers_as_in_jax(tmp_path):
    jsys, tsys = _systems(tmp_path)
    js, ts = _states(tsys)
    jsys.visualizers = JV.build_visualizers(copy.deepcopy(VISUALIZERS))
    tsys.visualizers = TV.build_visualizers(copy.deepcopy(VISUALIZERS))
    want = jsys.validate(js, save_images=True)
    got = tsys.validate(ts, save_images=True)
    assert set(got) == set(want) == {"psnr", "ssim"}
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-4, k
    files = sorted(os.listdir(os.path.join(tsys.save_dir, "val_images",
                                           str(ts.it))))
    assert files == sorted(os.listdir(os.path.join(
        jsys.save_dir, "val_images", str(js.it))))
    assert {"pred_000.png", "gt_001.png", "epi_pred.png",
            "focus_rgb_cone.png", "embedding_points.png",
            "closest_view.png", "tensor_density_plane_0.png"} <= set(files)

    # each visualizer's images, on a 2 x 1 light-field grid for the EPI's
    # ground truth
    rays = tsys.train_dataset.image(0)["rays"]
    for s in (jsys, tsys):
        s.train_dataset.num_rows, s.train_dataset.num_cols = 1, 2
    for (name, jv), (_, tv) in zip(jsys.visualizers, tsys.visualizers):
        a = jv.render(jsys, js, rays, (12, 12))
        b = tv.render(tsys, ts, rays, (12, 12))
        assert set(b) == set(a) and b, name
        for k in a:
            assert b[k].shape == a[k].shape, k
            assert np.abs(b[k] - np.asarray(a[k])).max() <= 1e-4, k


# The fit: histories within 1e-5 relative at every log point, the params
# within 1e-4, grid_size and aabb equal (tests/test_torch_train_static_fit.py);
# the validation metrics within 1e-4.
def test_fit_resumed_across_a_grid_event_as_in_jax(tmp_path, one_thread):
    # the alpha event at 10, whose shrink crops the grids; no upsample
    cfg = preset_cfg("tiny_static", events=True)
    cfg["color"]["net"]["upsamp_list"] = []
    ov = ["training.num_epochs=2", "training.val_every=1",
          "training.log_every=5", "training.steps_per_call=1"]
    jcfg = JC.load_config(overrides=BASE + ov + [
        f"params.save_dir={tmp_path / 'jax'}"])
    tcfg = TC.load_config(overrides=BASE + ov + [
        f"params.save_dir={tmp_path / 'port'}"])
    for c in (jcfg, tcfg):
        c["model"] = copy.deepcopy(cfg)
        c["training"].update({k: v for k, v in training_cfg().items()
                              if k != "steps_per_call"})
        c["regularizers"] = tv_4000_defaults()
    jsys, tsys = JaxSystem(jcfg), System(tcfg, device="cpu")
    # one scene for both: the packages' marches differ by ~1e-6 in rgb,
    # which Adam's normalized steps would carry into the params (the
    # loaders' own parity: tests/test_torch_data_*.py)
    jsys.train_dataset = jsys.val_dataset = tsys.train_dataset

    # one set of weights (the training parity tests' init_weights), saved
    # as each package's checkpoint at it 0
    pn = init_weights(tsys.model)
    ts = TrainState(params_from_jax(pn, device="cpu"), None, 0)
    ts.opt_state = tsys.trainer.make_optimizer(ts.params).init(ts.params)
    jp = jax.tree.map(jnp.asarray, pn)
    jt = jsys.trainer
    jsave = str(tmp_path / "jax_ckpt")
    jax_save(jsave, JaxState(jp, jt._make_optimizer(jp).init(jp), 0),
             jsys.model)
    tsave = save_checkpoint(str(tmp_path / "port_ckpt"), ts, tsys.model)
    # the JAX restore's template (its compiled init takes seconds on the
    # CPU): the same tree, the values come from the checkpoint
    jsys.model.init = lambda key: jp
    jit_upsample(jsys.model.color_net)
    draws = record_jax_draws(jt)
    jstate, jh = jsys.fit(resume_from=jsave)
    fit = tsys.trainer.fit
    tsys.trainer.fit = lambda *a, **k: fit(*a, draws=lambda it: draws[it],
                                          **k)
    tstate, th = tsys.fit(resume_from=tsave)

    assert tstate.it == jstate.it == 20
    assert [h["it"] for h in th] == [h["it"] for h in jh] == \
        list(range(5, 21, 5))
    for a, b in zip(jh, th):
        for k in ("loss", "image_loss", "psnr"):
            assert b[k] == pytest.approx(a[k], rel=1e-5), (a["it"], k)
    jnet, tnet = jsys.model.color_net, tsys.model.color_net
    assert tnet.grid_size == jnet.grid_size != [16, 16, 16]
    np.testing.assert_array_equal(tnet.aabb, jnet.aabb)
    assert tnet.aabb[0][0] > cfg["color"]["net"]["aabb"][0][0]   # cropped
    assert max(max_param_err(jstate.params, tstate.params).values()) <= 1e-4

    def lines(s, name):
        with open(os.path.join(s.save_dir, name)) as f:
            return [json.loads(line) for line in f]
    for name in ("metrics.jsonl", "metrics.txt"):
        a, b = lines(jsys, name), lines(tsys, name)
        assert [x["it"] for x in b] == [x["it"] for x in a]
        for x, y in zip(a, b):
            for k in x:
                assert y[k] == pytest.approx(x[k], rel=1e-5, abs=1e-4), k
    assert [x["it"] for x in lines(tsys, "metrics.txt")] == [10, 20]
    last = os.path.join(tsys.save_dir, "last")
    with open(os.path.join(last, "meta.json")) as f:
        meta = json.load(f)
    assert meta["it"] == 20 and meta["grid_size"] == tnet.grid_size
    saved = torch.load(os.path.join(last, "params.pt"))
    for path, v in tree_leaves(tstate.params):
        got = saved
        for p in path:
            got = got[p]
        assert torch.equal(got, v), path


CLI = ["--device", "cpu", "dataset.n_views=2", "dataset.wh=[12,12]",
       "training.num_iters=4", "training.num_epochs=2",
       "training.val_every=1", "training.batch_size=256",
       "training.log_every=2", "training.ray_chunk=100"]


def test_cli_trains_then_evaluates_renders_and_exports(tmp_path, one_thread):
    from hyperreel_tpu_torch.main import main
    ov = CLI + [f"params.save_dir={tmp_path}"]
    system, state, done = main(ov)
    run = tmp_path / "experiment"
    assert state.it == 8 and system.device.type == "cpu"
    assert done["fit"] > 0 and set(done["final"]) == {"psnr", "ssim"}
    assert [json.loads(x)["it"] for x in open(run / "metrics.txt")] == [4, 8]
    assert len(open(run / "metrics.jsonl").readlines()) == 4
    ckpt = str(run / "last")
    mesh = str(tmp_path / "mesh.ply")
    system, state, done = main(ov + ["--resume", ckpt, "--eval-only",
                                     "--render-only", "--export-mesh", mesh])
    assert state.it == 8
    assert set(done) == {"eval", "spiral", "mesh"}
    assert set(done["eval"]["metrics"]) == {"psnr", "ssim"}
    assert len(done["spiral"]["frame_seconds"]) == 30
    val = sorted(os.listdir(run / "val_images" / "8"))
    assert val == ["gt_000.png", "gt_001.png", "pred_000.png",
                   "pred_001.png"]
    spiral = sorted(os.listdir(run / "spiral"))
    assert len(spiral) == 31 and spiral[-1] == "spiral.mp4"
    with open(mesh) as f:
        head = [next(f) for _ in range(9)]
    nv, nf = (int(head[i].split()[-1]) for i in (2, 6))
    assert head[0] == "ply\n" and nv > 0 and nf > 0
    assert (done["mesh"]["verts"], done["mesh"]["faces"]) == (nv, nf)


def test_cli_flags_and_refusals(tmp_path, capsys):
    from hyperreel_tpu.main import main as jax_main
    from hyperreel_tpu_torch.main import main

    def flags(fn):
        with pytest.raises(SystemExit):
            fn(["--help"])
        return {w.rstrip(",") for w in capsys.readouterr().out.split()
                if w.startswith("--")}
    want = flags(jax_main)
    assert flags(main) == want | {"--device"}
    assert "--import-reference" in want and "--coherent-gather" in want
    with pytest.raises(NotImplementedError, match="ROADMAP.md: long tail"):
        main(CLI + ["--import-reference", "ref.ckpt"])
    with pytest.raises(NotImplementedError, match="ROADMAP.md: long tail"):
        main(CLI + ["model.color.net.type=tensor_vm_split_reflect"])
    with pytest.raises(ValueError, match="require --resume"):
        main(CLI + [f"params.save_dir={tmp_path}", "--eval-only"])
    # one device: data_parallel changes nothing, as in JAX on one device
    system, state, _ = main(CLI + [f"params.save_dir={tmp_path}",
                                   "training.data_parallel=true",
                                   "training.num_epochs=1"])
    assert state.it == 4
    if not torch.cuda.is_available():
        # the default device is the card: no card, no fallback
        with pytest.raises(RuntimeError, match="no CUDA card"):
            main(CLI[2:] + [f"params.save_dir={tmp_path}"])
