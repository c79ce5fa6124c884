"""The other colour nets (hyperreel_tpu_torch/models/tensorf_extra.py)
against the JAX package's on the CPU (tests/torch_colour_parity.py: the
same weights in both layouts by convert.py, the eval rgb within 1e-5 and one
training step's gradients leaf by leaf within 1e-5 + 1e-4 of the leaf's
largest): the joint-plane VM net, the CP net (its line lists through
convert), their upsample, the colour cascade across its wait and stop
iterations, and the standalone net's own march with the JAX step's jitter
injected. Configs from the JAX tests/test_net_variants.py."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from hyperreel_tpu.models.ctx import make_ctx
from hyperreel_tpu_torch.convert import params_from_jax, params_to_jax
from hyperreel_tpu_torch.models.ctx import StepCtx
from hyperreel_tpu_torch.models.tensorf import build_color_net
from hyperreel_tpu_torch.models.tensorf_extra import TensorCP, TensorVMJoint

from torch_colour_parity import BASE, check_net, net_pair, sample_fields

torch.set_num_threads(1)

VARIANTS = {"tensor_vm": {"n_lamb_sigma": 4, "n_lamb_sh": 8},
            "tensor_cp": {"n_lamb_sigma": 16, "n_lamb_sh": 16}}


@pytest.mark.parametrize("t", sorted(VARIANTS))
def test_variant_matches_jax(t):
    cfg = dict(BASE, type=t, **VARIANTS[t])
    jnet, tnet, jp, tp = check_net(cfg, sample_fields(seed=5))
    assert isinstance(tnet, TensorVMJoint if t == "tensor_vm" else TensorCP)
    assert not tnet.fused_eligible
    labels = tnet.param_groups(tp)
    assert labels["basis_mat"] == {"weight": "color_impl"}
    # the upsample of both packages on the same weights
    new = [20, 18, 22]
    jn = jax.jit(lambda p: jnet.upsample(p, new))(jp)
    tn = tnet.upsample(tp, new)
    assert tnet.grid_size == jnet.grid_size
    want = jax.tree.map(np.asarray, jn)
    got = params_to_jax(tn)
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        assert a.shape == b.shape and np.abs(a - b).max() <= 1e-6


def test_cp_lines_round_trip():
    """The JAX CP net's line lists are dicts {"0", "1", "2"} in the port,
    and back."""
    cfg = dict(BASE, type="tensor_cp", **VARIANTS["tensor_cp"])
    _, _, jp, tp = net_pair(cfg)
    assert sorted(tp["density_line"]) == ["0", "1", "2"]
    back = params_to_jax(tp)
    assert isinstance(back["app_line"], list) and len(back["app_line"]) == 3
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, jp)),
                    jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)


CASCADE = {"type": "multiple", "nets": [
    dict(BASE, type="tensor_vm_split_no_sample", wait_iters=0,
         stop_iters=100),
    dict(BASE, type="tensor_vm_split_no_sample", wait_iters=100,
         stop_iters=10 ** 9, scale=0.5,
         filter={"max_samples": 4, "weight_thresh": 0.1,
                 "wait_iters": 50})]}


@pytest.mark.parametrize("it", [120, 500])
def test_cascade_matches_jax(it):
    """Net 0 until 100, net 1 alone (at 0.5) from 100: at 120 it sees
    iteration 20, before its filter's wait; at 500, after."""
    check_net(CASCADE, sample_fields(seed=6), it=it)


def test_standalone_march_matches_jax():
    """Stratified samples between near and far, jittered in training by
    the step's draw (the JAX step's uniform of its key, injected)."""
    cfg = dict(BASE, type="tensor_vm_split", n_lamb_sigma=[4, 2, 2],
               n_lamb_sh=[4, 2, 2], near_far=[0.5, 3.5], nSamples=16)
    rng = np.random.default_rng(1)
    rays = np.concatenate([rng.uniform(-0.3, 0.3, (8, 3)),
                           rng.uniform(-0.2, 0.2, (8, 3))], -1)
    rays[:, 5] = 1.0
    rays[:, 2] -= 2.0
    check_net(cfg, rays.astype(np.float32), apply="march", draws={
        "standalone_jitter": lambda key: jax.random.uniform(key, (8, 16))})


def test_reflect_net_stays_long_tail():
    with pytest.raises(NotImplementedError, match="long tail"):
        build_color_net(dict(BASE, type="tensor_vm_split_reflect"))
