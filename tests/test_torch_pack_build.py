"""K1 pack-build: the port's plain version (the CPU side of
hyperreel_tpu_torch/ops/kernels/pack_build.py) against the JAX Pallas
kernel hyperreel_tpu/ops/pallas/pack_build.py (interpret mode on the CPU):
the embedding tail alone (`mlp=None`, the same MLP output on both sides),
and the whole kernel with the prediction MLP inside it (the JAX default
HYPERREEL_PK_MLP route), fed the same encoded rays and weights."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from hyperreel_tpu.ops.pallas.pack_build import pack_build as jax_pack_build
from hyperreel_tpu_torch.ops.kernels import pack_build as PB
from hyperreel_tpu_torch.models.ctx import StepCtx
from hyperreel_tpu_torch.ops.kernels.layout import (
    JAX_PACK_ROWS, PACK_ROWS, check_pack, pack_from_smajor)
from hyperreel_tpu_torch.ops.kernels.shade import ShadeSpec, shade

from torch_parity import entry_rays, flagship_cfg, models, weights

B = 256          # two 128-ray tiles of the JAX kernel


def _inputs(S, P, seed):
    """Field-major MLP output [B, P*S] and ray rows [B, 8] (o, d, dt, tn)."""
    rng = np.random.default_rng(seed)
    mlp = rng.normal(0.0, 1.0, (B, P * S)).astype(np.float32)
    o = rng.uniform(-0.5, 0.5, (B, 3)).astype(np.float32)
    o[:, 2] -= 1.5
    d = rng.uniform(-0.3, 0.3, (B, 3)).astype(np.float32)
    d[:, 2] = 1.0
    d[:4, 2] = 0.0                   # the |d_z| < 1e-5 guard
    dt = rng.uniform(-0.1, 0.1, (B, 1)).astype(np.float32)
    tn = rng.uniform(-1, 1, (B, 1)).astype(np.float32)
    return mlp, np.concatenate([o, d, dt, tn], 1)


def _jax_pack(jm, mlp, rays, it, mlp_spec=None):
    """The JAX kernel on the same inputs, as models/fused_eval.py calls
    it on the quad route: `mlp` is the field-major MLP output [B, P*S]
    (mlp_spec None), or None with the in-kernel MLP's `mlp_spec`."""
    cf = jm._cf_eval
    pred, isect = cf.pred, cf.isect
    S = cf.S
    acts = {n: pred.activations[pred.output_names.index(n)]
            for n in cf.field_offsets}
    pack, _ = jax_pack_build(
        None if mlp is None else jnp.asarray(mlp.T), jnp.asarray(rays.T),
        it, S=S, k=S, tile=128,
        samples=np.broadcast_to(np.asarray(isect.samples).reshape(-1), (S,)),
        z_scale=np.broadcast_to(np.asarray(isect.z_scale).reshape(-1), (S,)),
        field_offsets=cf.field_offsets, field_acts=acts,
        isect_act=isect.activation,
        flow_act=cf.flow.spatial_flow_activation, po_act=cf.po.activation,
        has_sigma=True, has_flow=True, po_use_sigma=True,
        po_sigma_field=cf.po.in_density_field, far_sentinel=None,
        aabb=np.asarray(cf.net.aabb, np.float32),
        axis_specs=[(1, 1, 0, 1)], emit_idx=False, mlp=mlp_spec)
    return np.array(pack)


# `it=0` alone checks little: sigma and point_sigma ease from 1.0, so
# (1 - sigma) zeroes the predicted z and the offsets; it=20000 is past
# both windows (12000 and 4000 + 12000 iterations).
@pytest.mark.parametrize("tiny", [True, False],
                         ids=["tiny_S8", "flagship_S32"])
@pytest.mark.parametrize("it", [0, 20000])
def test_plain_pack_matches_jax_kernel(tiny, it):
    jm, tm = models(flagship_cfg(tiny=tiny), bf16=False)
    spec = tm._cf_eval.spec
    assert spec.S == (8 if tiny else 32) and spec.P == 15
    mlp, rays = _inputs(spec.S, spec.P, seed=it + spec.S)
    want = pack_from_smajor(torch.from_numpy(_jax_pack(jm, mlp, rays, it)),
                            spec.S, 128)
    got = PB.tail_plain(torch.from_numpy(mlp), torch.from_numpy(rays),
                        spec, it)
    assert got.shape == (PACK_ROWS, B * spec.S)
    # f32 elementwise math on both sides, same operation order: 1e-5
    err = (got - want).abs().max().item()
    assert err <= 1e-5, err
    # each ray's distances come out sorted
    assert (got[3].reshape(B, -1).diff(dim=1) >= 0).all()


def _encoded(tm, rays, it):
    cf = tm._cf_eval
    r = torch.from_numpy(rays)
    return (cf.pred.net_input(r, StepCtx(it=it)).float().contiguous(),
            cf.ray_pack(r))


# The whole K1 at flagship width under the bench's bf16 policy, against
# the JAX kernel with its in-kernel MLP (_mlp_rows). Both round the same
# operands to bf16 and sum exact products in f32, in another order; a
# hidden value that lands on the other side of a bf16 rounding boundary
# moves one bf16 ulp (2^-8 relative) into the next layer, which moves the
# MLP output by up to ~2e-4 and the pack, whose points scale the z and
# offset fields by |d|/d_z * aabb_inv, by several times that: hence 1e-3,
# where a wrong layout, weight block or field is O(1). On these 256 rays
# no rounding flips and the two agree to 1.2e-7.
@pytest.mark.parametrize("it", [0, 20000])
def test_plain_pack_with_mlp_matches_jax_kernel(it):
    jm, tm = models(flagship_cfg(), bf16=True)
    jp, tp = weights(jm, seed=5)
    cf = tm._cf_eval
    x0, rp = _encoded(tm, entry_rays(B, seed=11), it)
    mlp_spec = jm._cf_eval._mlp_kernel_spec(
        jp["embedding"]["ray_prediction_0"]["net"], jnp.asarray(x0.numpy().T))
    want = pack_from_smajor(torch.from_numpy(
        _jax_pack(jm, None, rp.numpy(), it, mlp_spec)), cf.S, 128)
    got = PB.pack_build(x0, cf.prepare(tp)["mlp"], rp, cf.spec, it)
    err = (got - want).abs().max().item()
    assert err <= 1e-3, err
    # the same kernel under the f32 policy: nothing is rounded, so the
    # MLP output agrees with the general path's f32 MLP to 1e-5
    _, tm32 = models(flagship_cfg(), bf16=False)
    cf32 = tm32._cf_eval
    tabs = cf32.prepare(tp)["mlp"]
    net = cf32.pred.net
    ref = net.apply(tp["embedding"]["ray_prediction_0"]["net"], x0)
    perm = np.arange(cf.S * cf.P).reshape(cf.S, cf.P).T.reshape(-1)
    mo = PB.mlp_plain(x0, tabs)[:, :cf.S * cf.P]
    assert (mo - ref[:, perm]).abs().max().item() <= 1e-5


def test_pack_from_smajor_reorders_tiles():
    """JAX lane s*tile + r of tile block b holds ray b*tile + r, sample s;
    the port's column (b*tile + r)*S + s."""
    S, tile, nb = 4, 8, 3
    Bn = tile * nb
    r = np.arange(Bn)[:, None]
    s = np.arange(S)[None, :]
    code = (r * 100 + s).astype(np.float32)          # [B, S] ray-major
    smajor = code.reshape(nb, tile, S).transpose(0, 2, 1).reshape(-1)
    pack16 = np.stack([smajor + 1000 * i for i in range(16)])
    got = pack_from_smajor(torch.from_numpy(pack16), S, tile).numpy()
    want = np.stack([code.reshape(-1) + 1000 * i for i in JAX_PACK_ROWS])
    np.testing.assert_array_equal(got, want)


def _tiny_k1(seed):
    jm, tm = models(flagship_cfg(tiny=True), bf16=True)
    _, tp = weights(jm, seed=seed)
    cf = tm._cf_eval
    x0, rp = _encoded(tm, entry_rays(B, seed=seed), 20000)
    return cf, cf.prepare(tp)["mlp"], x0, rp


def test_cpu_tensors_take_the_plain_version():
    cf, tabs, x0, rp = _tiny_k1(3)
    before = PB.pack_build.launches
    got = PB.pack_build(x0, tabs, rp, cf.spec, 20000)
    plain = PB.pack_build_plain(x0, tabs, rp, cf.spec, 20000)
    assert PB.pack_build.launches == before
    assert torch.equal(got, plain)


def test_layout_mismatch_fails_loudly():
    """A pack of another sample count, or a transposed one, is refused
    instead of compositing the wrong lanes; so are encoded rays of the
    wrong width and a ray pack of the wrong length."""
    cf, tabs, x0, rp = _tiny_k1(4)
    spec = cf.spec
    pack = PB.pack_build(x0, tabs, rp, spec, 20000)
    with pytest.raises(ValueError):
        check_pack(pack.t().contiguous(), spec.S)
    with pytest.raises(ValueError):
        check_pack(pack[:, :-1].contiguous(), 3)
    with pytest.raises(ValueError):
        PB.pack_build(x0[:, :-1].contiguous(), tabs, rp, spec, 0)
    with pytest.raises(ValueError):
        PB.pack_build(x0, tabs, rp[:-1].contiguous(), spec, 0)
    sspec = ShadeSpec(S=3, W=2, H=2, TW=2, TH=0, C=8, nd=4, deg=2,
                      distance_scale=16.0)
    with pytest.raises(ValueError):
        shade(torch.zeros(9, 32, dtype=torch.bfloat16), pack[:, :-1], rp,
              torch.zeros(2, 8), torch.zeros(27, 8), sspec)
    sspec = ShadeSpec(S=spec.S, W=2, H=2, TW=2, TH=0, C=8, nd=4, deg=2,
                      distance_scale=16.0)
    with pytest.raises(ValueError):
        shade(torch.zeros(9, 32, dtype=torch.bfloat16), pack, rp[:-1],
              torch.zeros(2, 8), torch.zeros(27, 8), sspec)
