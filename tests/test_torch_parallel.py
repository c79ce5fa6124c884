"""Data parallelism of the port (hyperreel_tpu_torch/parallel/mesh.py)
against one process and against the JAX package's ShardedTrainer
(hyperreel_tpu/parallel/mesh.py) on a 2-device mesh of the virtual CPU
devices (tests/conftest.py):

two ranks over gloo (tests/_torch_dp_worker.py, one subprocess each, a
free port, at most 120 s) take 3 steps of tiny_static on 256-ray global
batches from one set of weights (rank 1 starts from other weights:
place_state gives it rank 0's), the JAX steps' draws injected. Held:
  * the first step's all-reduced gradients against the one-process
    step's on the whole batch (a summed gradient is twice as large, a
    dropped shard another batch's);
  * both ranks' params after 3 steps equal each other to the bit, and
    the one-process run's and the JAX ShardedTrainer's within the
    training tests' tolerance;
  * the sharded render against the one-process render;
  * the ranks' System.fit under training.data_parallel=true: one
    metrics.jsonl line per logged step and one checkpoint (rank 0
    writes; rank 1 writes nothing).
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from hyperreel_tpu.parallel.mesh import (
    ShardedTrainer as JaxSharded, make_mesh, shard_batch as jax_shard)
from hyperreel_tpu_torch.convert import params_to_jax
from hyperreel_tpu_torch.models.ctx import StepCtx
from hyperreel_tpu_torch.train.optim import tree_leaves
from hyperreel_tpu_torch.train.regularizers import tv_4000_defaults

from torch_train_parity import (
    BATCH, IPE, draws_of, max_param_err, preset_cfg, scene, start,
    training_cfg)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 3
IT_RENDER = 160
CLI = ["dataset.n_views=2", "dataset.wh=[12,12]", "training.num_iters=4",
       "training.num_epochs=1", "training.val_every=1",
       "training.batch_size=256", "training.log_every=2"]
# the all-reduced gradients: the same f32 sums in another order (each
# leaf within 1e-6 of its largest entry; a summed gradient is off by its
# whole size)
GRAD_TOL = 1e-6
# params after 3 Adam steps at lr up to 0.02: the one-process run within
# 1e-5 (reduction order only), the JAX package's within the training
# fits' 1e-4 (tests/test_torch_train_static_fit.py)
PARAM_TOL = 1e-5
JAX_PARAM_TOL = 1e-4


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The setup, both ranks' outputs, the one-process run and the JAX
    sharded run."""
    out = tmp_path_factory.mktemp("dp")
    cfg = preset_cfg("tiny_static")
    ds = scene("tiny_static")
    jt, js, tt, ts = start(cfg, ds)
    weights = jax.tree.map(np.asarray, js.params)
    it = ds.batch_iterator(BATCH, seed=0)
    batches = [next(it) for _ in range(STEPS)]
    keys = [jax.random.PRNGKey(10 + i) for i in range(STEPS)]
    draws = [draws_of(k) for k in keys]
    rays = ds.all_coords[:200]

    # the regularizers of `start`: tv_4000 on both sides
    setup = {"cfg": cfg, "info": ds.info(), "training": training_cfg(),
             "regs": tv_4000_defaults(), "ipe": IPE, "weights": weights,
             "batches": batches, "draws": draws, "render_rays": rays,
             "it": IT_RENDER, "cli": CLI}
    torch.save(setup, out / "setup.pt")
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "_torch_dp_worker.py"),
         str(out / "setup.pt"), str(out), str(r), "2", str(port)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, "\n".join(
            f"rank {i}: {lg[-2000:]}" for i, lg in enumerate(logs))
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False)
             for r in range(2)]

    # one process on the whole batch
    opt = tt.make_optimizer(ts.params)
    _, _, grads0 = tt.grads(ts.params, tt.to_device(batches[0]), StepCtx(
        it=0, training=True, draws=dict(draws[0])))
    for i, b in enumerate(batches):
        ts, _ = tt.step(ts, tt.to_device(b), opt, draws=draws[i])
    render1 = tt.model.apply(ts.params, torch.from_numpy(rays),
                             StepCtx(it=IT_RENDER))["rgb"]

    # the JAX ShardedTrainer over two devices
    mesh = make_mesh(2)
    sharded = JaxSharded(jt, mesh)
    st = sharded.place_state(js)
    step, _ = sharded.make_train_step(st.params)
    params, opt_state = st.params, st.opt_state
    for i, (b, k) in enumerate(zip(batches, keys)):
        params, opt_state, _ = step(
            params, opt_state,
            jax_shard({key: jnp.asarray(v) for key, v in b.items()}, mesh),
            jnp.asarray(i, jnp.int32), k)
    return {"ranks": ranks, "grads0": grads0, "params1": ts.params,
            "render1": render1, "jax_params": params, "out": out}


def test_allreduced_gradients_match_one_process(run):
    got = run["ranks"][0]["grads0"]
    for path, want in run["grads0"].items():
        scale = want.abs().max().item()
        assert scale > 0, path
        err = (got[path] - want).abs().max().item()
        assert err <= GRAD_TOL * scale, (path, err, scale)
    assert set(got) == set(run["grads0"])


def test_ranks_agree_and_match_one_process(run):
    a, b = (dict(tree_leaves(r["params"])) for r in run["ranks"])
    for path, v in a.items():
        assert torch.equal(v, b[path]), path
    errs = max_param_err(params_to_jax(run["params1"]),
                         run["ranks"][0]["params"])
    assert max(errs.values()) <= PARAM_TOL, errs


def test_ranks_match_jax_sharded_trainer(run):
    errs = max_param_err(run["jax_params"], run["ranks"][0]["params"])
    assert max(errs.values()) <= JAX_PARAM_TOL, errs


def test_sharded_render_matches_one_process(run):
    for r in run["ranks"]:
        assert r["rgb"].shape == run["render1"].shape == (200, 3)
        assert (r["rgb"] - run["render1"]).abs().max().item() <= 1e-6


def test_only_rank_zero_writes(run):
    root = run["out"] / "system"
    with open(root / "metrics.jsonl") as f:
        its = [int(line.split('"it": ')[1].split("}")[0].split(",")[0])
               for line in f]
    assert its == [2, 4]
    with open(root / "metrics.txt") as f:
        assert len(f.readlines()) == 1
    assert os.path.isdir(root / "last")


def test_ray_shard_draws_slice_the_global_draw():
    """A per-ray draw under a ray_shard is the global batch's draw sliced
    to the rank's rows; a 0-d draw is every rank's."""
    full = []
    for lo, hi in ((0, 3), (3, 6)):
        ctx = StepCtx(it=0, training=True,
                      gen=torch.Generator().manual_seed(5),
                      ray_shard=(lo, hi, 6))
        full.append(ctx.uniform("flow_jitter", (3, 1), "cpu", per_ray=True))
        assert ctx.uniform("background", (), "cpu").shape == ()
    one = torch.rand((6, 1), generator=torch.Generator().manual_seed(5))
    assert torch.equal(torch.cat(full), one)
    ctx = StepCtx(it=0, training=True, draws={"flow_jitter": one.numpy()},
                  ray_shard=(3, 6, 6))
    assert torch.equal(ctx.uniform("flow_jitter", (3, 1), "cpu",
                                   per_ray=True), one[3:])
