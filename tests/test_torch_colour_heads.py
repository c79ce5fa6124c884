"""The colour nets' shading and density heads, the top-k weight filter and
the colour transforms, against the JAX package on the CPU: each net built
by both packages from one config (tests/torch_colour_parity.py, the JAX
tests/test_net_variants.py BASE at 2 components per axis, f32 tables),
the same weights in both layouts, and the eval rgb (1e-5) and one training
step's gradients (each leaf within 1e-5 + 1e-4 of its largest) held to
the JAX net's. The static net takes RGBIdentity, MLP_Fea and the filter;
the dynamic net (4 keyframes of 12 frames) also RGBtLinear, RGBtFourier,
DensityLinear and DensityFourier; both the per-sample and the per-ray
colour transforms."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from hyperreel_tpu.models.embeddings import (
    ColorTransformEmbedding as JaxColorTransform)
from hyperreel_tpu.models.ctx import make_ctx
from hyperreel_tpu_torch.convert import params_from_jax
from hyperreel_tpu_torch.models.ctx import StepCtx
from hyperreel_tpu_torch.models.embeddings import ColorTransformEmbedding
from hyperreel_tpu_torch.models.tensorf import build_color_net

from torch_colour_parity import BASE, INFO, check_net, sample_fields

torch.set_num_threads(1)

MLP = {"shadingMode": "MLP_Fea", "view_pe": 2, "fea_pe": 2, "featureC": 16,
       "data_dim_color": 6}
FILTER = {"filter": {"max_samples": 4, "weight_thresh": 0.2,
                     "wait_iters": 50}}

# each head, the filter and each transform in some case; the filter's
# weights tie at the k-th largest (all ties stay: JAX's >= kth - 1e-8)
STATIC_CASES = {
    "rgb_identity_filter_transform": (
        {"shadingMode": "RGBIdentity", "data_dim_color": 3, **FILTER},
        "sample"),
    "mlp_fea_global_transform": (MLP, "global"),
}
DYNAMIC_CASES = {
    "rgbt_linear_density_linear_filter": (
        {"shadingMode": "RGBtLinear", "densityMode": "DensityLinear",
         **FILTER}, None),
    "rgbt_fourier_density_fourier_global_transform": (
        {"shadingMode": "RGBtFourier", "densityMode": "DensityFourier"},
        "global"),
    "mlp_fea_transform": (MLP, "sample"),
}


@pytest.mark.parametrize("case", sorted(STATIC_CASES))
def test_static_head_matches_jax(case):
    extra, transform = STATIC_CASES[case]
    cfg = dict(BASE, type="tensor_vm_split_no_sample", **extra)
    x = sample_fields(seed=1, transform=transform)
    x["weights"][:, 4:6] = x["weights"][:, 3:4]
    check_net(cfg, x)


@pytest.mark.parametrize("case", sorted(DYNAMIC_CASES))
def test_dynamic_head_matches_jax(case):
    extra, transform = DYNAMIC_CASES[case]
    cfg = dict(BASE, type="tensor_vm_split_time", **extra)
    x = sample_fields(seed=2, dynamic=True, transform=transform)
    x["weights"][:, 4:6] = x["weights"][:, 3:4]
    check_net(cfg, x, INFO)


@pytest.mark.parametrize("it", [10, 100])
def test_filter_waits_and_keeps_ties(it):
    """Before wait_iters the filter keeps every sample; after it, the
    samples whose predicted weight ties the k-th largest stay and the
    rest below it go."""
    cfg = dict(BASE, type="tensor_vm_split_no_sample", **FILTER)
    net = build_color_net(cfg)
    x = sample_fields(seed=3)
    w = torch.from_numpy(x["weights"][..., 0])
    w[:, 4:6] = w[:, 3:4]
    valid = torch.ones_like(w, dtype=torch.bool)
    kept = net.filter_valid(valid, w, StepCtx(it=it))
    if it < 50:
        assert kept.all()
    else:
        kth = torch.topk(w, 4, -1).values[..., -1:]
        assert torch.equal(kept, (w >= kth - 1e-8) & (w > 0.2))
        assert (kept.sum(-1) >= torch.clamp_max((w > 0.2).sum(-1), 4)).all()


def test_time_heads_force_the_colour_channels():
    """RGBtLinear and RGBtFourier fix data_dim_color as the JAX net does
    (6 and 3 (2 frames_per_keyframe + 1)); the fused route takes neither
    them nor a non-plain density head."""
    for mode, dim in (("RGBtLinear", 6), ("RGBtFourier", 21)):
        net = build_color_net(dict(BASE, type="tensor_vm_split_time",
                                   shadingMode=mode), INFO)
        assert net.app_dim == dim and not net.fused_eligible
    net = build_color_net(dict(BASE, type="tensor_vm_split_time",
                               densityMode="DensityLinear", bf16_tables=True),
                          INFO)
    assert not net.fused_eligible
    with pytest.raises(ValueError):
        build_color_net(dict(BASE, type="tensor_vm_split_no_sample",
                             shadingMode="RGBtLinear"))


@pytest.mark.parametrize("act", ["identity", "tanh"])
def test_color_transform_stage_matches_jax(act):
    """The per-camera transform and shift (under their activations),
    picked by each ray's camera index and broadcast to its samples, and
    their gradients; a camera index past the last view reads the last
    view's and passes it no gradient, as the JAX package's clamped gather
    and its transpose do."""
    cfg = {"type": "color_transform", "transform_activation": act,
           "shift_activation": act}
    jst = JaxColorTransform(cfg=dict(cfg), num_views=4)
    st = ColorTransformEmbedding(dict(cfg), num_views=4)
    rng = np.random.default_rng(4)
    jp = {"transform": jnp.asarray(rng.normal(0, 0.3, (4, 9)), jnp.float32),
          "shift": jnp.asarray(rng.normal(0, 0.3, (4, 3)), jnp.float32)}
    rays = np.concatenate([rng.uniform(-1, 1, (10, 6)),
                           rng.integers(0, 5, (10, 1)),
                           rng.uniform(0, 1, (10, 1))], -1).astype(np.float32)
    pts = np.zeros((10, 5, 3), np.float32)
    w = rng.normal(0, 1, (10, 5, 12)).astype(np.float32)

    def jloss(p):
        out = jst.apply(p, {"rays": jnp.asarray(rays),
                            "points": jnp.asarray(pts)}, make_ctx(0))
        return jnp.sum(jnp.concatenate([out["color_transform_global"],
                                        out["color_shift_global"]], -1) * w)

    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    for v in tp.values():
        v.requires_grad_()
    out = st.apply(tp, {"rays": torch.from_numpy(rays),
                        "points": torch.from_numpy(pts)}, StepCtx())
    assert st.group == "color"
    assert out["color_transform_global"].shape == (10, 5, 9)
    loss = (torch.cat([out["color_transform_global"],
                       out["color_shift_global"]], -1)
            * torch.from_numpy(w)).sum()
    assert abs(loss.item() - float(jloss(jp))) <= 1e-4
    loss.backward()
    jg = jax.grad(jloss)(jp)
    for k in ("transform", "shift"):
        assert np.abs(tp[k].grad.numpy() - np.asarray(jg[k])).max() <= 1e-5


def test_density_head_alpha_grid_matches_jax():
    """The grid events' occupancy through a non-plain density head: the
    density basis's output decoded at time 0 and offset 0, the max over
    the keyframes (JAX compute_alpha_grid), on a small lattice."""
    from torch_colour_parity import net_pair
    cfg = dict(BASE, type="tensor_vm_split_time", densityMode="DensityFourier",
               alpha_mask_thre=0.01)
    jnet, tnet, jp, tp = net_pair(cfg, INFO)
    want = jnet.compute_alpha_grid(jp, (6, 5, 4))
    got = tnet.compute_alpha_grid(tp, (6, 5, 4))
    assert 0 < float(np.asarray(want[0]).mean()) < 1
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               atol=1e-6)
