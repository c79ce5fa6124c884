"""K1 pack-build: the port's plain version (the CPU side of
hyperreel_tpu_torch/ops/kernels/pack_build.py) against the JAX Pallas
kernel hyperreel_tpu/ops/pallas/pack_build.py (interpret mode on the CPU):
the embedding tail alone (`mlp=None`, the same MLP output on both sides),
and the whole kernel with the prediction MLP inside it (the JAX default
HYPERREEL_PK_MLP route), fed the same encoded rays and weights."""

import dataclasses

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
from hyperreel_tpu_torch.ops.kernels.shade_multi import (
    AxisSpec, MultiSpec, shade_multi)

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


def _jax_pack(jm, mlp, rays, it, mlp_spec=None, k=None, stride=None,
              far_sentinel=None):
    """The JAX kernel on the same inputs, as models/fused_eval.py calls
    it on the quad route: `mlp` is the field-major MLP output [B, P*S]
    (mlp_spec None), or None with the in-kernel MLP's `mlp_spec`; k of
    the S samples kept (the first k, or every stride-th), invalid
    distances set to far_sentinel (None: 0)."""
    cf = jm._cf_eval
    pred, isect = cf.pred, cf.isect
    S = cf.S
    acts = {n: pred.activations[pred.output_names.index(n)]
            for n in cf.field_offsets}
    pack, _ = jax_pack_build(
        None if mlp is None else jnp.asarray(mlp.T), jnp.asarray(rays.T),
        it, S=S, k=k or S, tile=128,
        samples=np.broadcast_to(np.asarray(isect.samples).reshape(-1), (S,)),
        z_scale=np.broadcast_to(np.asarray(isect.z_scale).reshape(-1), (S,)),
        field_offsets=cf.field_offsets, field_acts=acts,
        isect_act=isect.activation,
        flow_act=cf.flow.spatial_flow_activation, po_act=cf.po.activation,
        has_sigma=True, has_flow=True, po_use_sigma=True,
        po_sigma_field=cf.po.in_density_field, far_sentinel=far_sentinel,
        aabb=np.asarray(cf.net.aabb, np.float32),
        axis_specs=[(1, 1, 0, 1)], emit_idx=False, mlp=mlp_spec,
        stride=stride)
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


def test_sentinel_flips_align_a_sample_at_distance_zero():
    """Two packs of one chain under invalid_sort_far whose ray 10 has its
    nearest sample 2e-6 in front of the origin on one side and 2e-6
    behind it on the other (the ray's o_z moved by 4e-6, as a bf16 sum in
    another order moves a predicted z): `pack_error` sees the sentinel
    against a valid sample, `sentinel_flips` finds ray 10 alone and holds
    it shifted by one position to 1e-5. A sample dropped at a distance
    that is not ~0 is not excused."""
    _, tm = models(flagship_cfg(tiny=True), bf16=False)
    spec = dataclasses.replace(tm._cf_eval.spec,
                               far_sentinel=PB.FAR_SENTINEL)
    mlp, rays = _inputs(spec.S, spec.P, seed=7)
    mlp, rays = torch.from_numpy(mlp), torch.from_numpy(rays)
    ref = PB.tail_plain(mlp, rays, spec, 20000)
    d0 = ref[3].reshape(B, -1)[10, 0].item()
    assert 0.0 < d0 < PB.FAR_SENTINEL and rays[10, 5] == 1.0
    r_in, r_out = rays.clone(), rays.clone()
    r_in[10, 2] += d0 - 2e-6
    r_out[10, 2] += d0 + 2e-6
    ref, pack = (PB.tail_plain(mlp, r, spec, 20000) for r in (r_in, r_out))
    assert PB.pack_error(pack, ref)[0] > 1e8
    flips, err = PB.sentinel_flips(pack, ref, r_in, spec, 1e-5)
    assert flips.nonzero().flatten().tolist() == [10] and err <= 1e-5, err
    assert PB.pack_error(pack, ref, skip=flips)[0] <= 1e-5
    assert PB.sentinel_flips(ref, pack, r_in, spec, 1e-5)[1] <= 1e-5
    # ray 20 loses its nearest sample, which lies well in front
    bad = ref.clone().reshape(-1, B, spec.S)
    bad[:4, 20] = torch.cat([bad[:4, 20, 1:], bad[:4, 20, -1:]], 1)
    bad[3, 20, -1] = PB.FAR_SENTINEL
    flips, err = PB.sentinel_flips(bad.reshape(ref.shape), ref, r_in, spec,
                                   1e-5)
    assert flips[20] and err > 1e-3, err


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
    wrong width, a ray pack of the wrong length, and a pack without the
    weights row given to a launch that reads it (K2, K5) or the reverse."""
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
    # a pack without the weights row given to a weights-row launch, and the
    # reverse (the static net's own fused route packs 11 rows)
    wspec = dataclasses.replace(sspec, weights=True)
    pack11 = torch.cat([pack, torch.ones_like(pack[:1])]).contiguous()
    for p, sp in ((pack, wspec), (pack11, sspec)):
        with pytest.raises(ValueError):
            shade(torch.zeros(9, 32, dtype=torch.bfloat16), p, rp,
                  torch.zeros(2, 8), torch.zeros(27, 8), sp)
    check_pack(pack11, spec.S, weights=True)
    mspec = MultiSpec(S=spec.S, axes=(AxisSpec(0, 2, 2, 2, 8, 4),),
                      deg=0, distance_scale=8.0, shading="rgb")
    for p, sp in ((pack, dataclasses.replace(mspec, weights=True)),
                  (pack11, mspec)):
        with pytest.raises(ValueError):
            shade_multi([torch.zeros(9, 32, dtype=torch.bfloat16)],
                        [torch.zeros(2, 8)], p, rp, torch.zeros(3, 4), sp)


# ---- the bf16 kernel's weight slabs (csrc/pack_build.cu pack_build_wgmma)


def _port_chain(family, S):
    """A port model of one K1 chain under the bf16 policy, its weights from
    torch.Generator seed S: the flagship's (flow, no contraction), llff's
    (no flow, mipnerf contraction) or neural_3d's (both); full widths
    (6x256 MLP) and the tiny presets' (4x64)."""
    from hyperreel_tpu_torch.configs.presets import (
        convert_epochs_to_iters, llff_z_plane, neural_3d_z_plane,
        technicolor_z_plane, tiny_dynamic, tiny_neural_3d, tiny_static)
    from hyperreel_tpu_torch.models.model import build_model
    make = {"flagship": technicolor_z_plane, "llff": llff_z_plane,
            "n3d": neural_3d_z_plane, "tiny_flagship": tiny_dynamic,
            "tiny_llff": tiny_static, "tiny_n3d": tiny_neural_3d}[family]
    cfg = convert_epochs_to_iters(make(z_channels=S), 4000)
    cfg["color"]["net"].update(fused_render=True, bf16_tables=True,
                               n_lamb_sigma=[8, 4, 4], n_lamb_sh=[8, 4, 4])
    info = {"num_keyframes": 12, "num_frames": 50, "num_views": 16}
    tm = build_model(cfg, dataset_info=info, compute_dtype=torch.bfloat16)
    params = tm.init(torch.Generator().manual_seed(S), "cpu")
    return tm._cf_eval, params


def _walk_slabs(tabs, spec):
    """Un-tile `tabs.tiled` in the kernel's consumption order: per hidden
    layer (its hidden rows [H, n] or None, its encoded-ray rows [64, n] or
    None), each gathered from the column blocks, and per strip of the last
    layer its [H, width] columns."""
    H = tabs.layers[0].w.shape[1]
    hb = min(H, PB.HIDDEN_BLOCK)
    rows = iter(tabs.tiled.split(
        [hb] * sum(H // hb * ((l.k0 == 0) * (H // 64)
                              + (l.k0 + l.w.shape[0] > tabs.xcol))
                   for l in tabs.layers[:-1])
        + [len(c) for c in PB.strip_columns(spec) for _ in range(H // 64)]))
    hidden = []
    for l in tabs.layers[:-1]:
        hs, xs = [], []
        for _ in range(H // hb):
            if l.k0 == 0:
                hs.append(torch.cat([next(rows).t() for _ in range(H // 64)]))
            if l.k0 + l.w.shape[0] > tabs.xcol:
                xs.append(next(rows).t())
        hidden.append((torch.cat(hs, 1) if hs else None,
                       torch.cat(xs, 1) if xs else None))
    strips = [torch.cat([next(rows).t() for _ in range(H // 64)])
              for _ in PB.strip_columns(spec)]
    assert next(rows, None) is None
    return hidden, strips


@pytest.mark.parametrize("family,S", [
    ("flagship", 32), ("llff", 32), ("n3d", 64), ("tiny_flagship", 8),
    ("tiny_llff", 64), ("tiny_n3d", 8)])
def test_tiled_weights_untile_to_linear_weights(family, S):
    """The slabs that mlp_tables lays out, turned back by a plain
    un-tiler, are the nn.Linear weights (bf16) in the kernel's order: the
    hidden layers' hidden and encoded-ray rows, the last layer's strips
    (z and sigma first) column by column; pad rows and columns are zero."""
    cf, params = _port_chain(family, S)
    spec, tabs = cf.spec, cf.prepare(params)["mlp"]
    net = params["embedding"]["ray_prediction_0"]["net"]
    cin, skips = cf.pred.net.in_channels, cf.pred.net.skips
    hidden, strips = _walk_slabs(tabs, spec)
    for i, (h, x) in enumerate(hidden):
        w = net[f"layer_{i}"]["weight"].to(torch.bfloat16).t()   # [in, out]
        if i == 0:
            assert h is None and torch.equal(x[:cin], w)
        elif i in skips:
            assert torch.equal(h, w[cin:]) and torch.equal(x[:cin], w[:cin])
        else:
            assert x is None and torch.equal(h, w)
        if x is not None:
            assert not x[cin:].any()
    w = net[f"layer_{len(hidden)}"]["weight"].to(torch.bfloat16)  # [out, in]
    layout = PB.kernel_strips(S)
    assert layout[0] == ([("z", 0), ("sigma", 0)], 0, S)
    seen = set()
    for (chans, s0, ns), cols, ws in zip(layout, PB.strip_columns(spec),
                                         strips):
        assert ws.shape == (w.shape[1], len(cols)) and len(cols) % 32 == 0
        for n, c in enumerate(cols):
            if c < 0:
                assert not ws[:, n].any()
                continue
            f, comp = chans[n // ns]
            s = s0 + n % ns
            assert f in spec.foff and c == (spec.foff[f] + comp) * S + s
            # the MLP's own column of sample s, field f, component comp
            assert torch.equal(ws[:, n], w[s * spec.P + spec.foff[f] + comp])
            seen.add(c)
    # every column of the chain's fields, once
    assert seen == {(spec.foff[f] + c) * S + s for f in spec.foff
                    for c in range({"flow": 3, "poff": 3, "cs": 3,
                                    "csh": 3}.get(f, 1)) for s in range(S)}


@pytest.mark.parametrize("family,S", [
    ("tiny_flagship", 8), ("tiny_flagship", 64), ("tiny_llff", 8),
    ("tiny_llff", 64), ("tiny_n3d", 8), ("tiny_n3d", 64)])
def test_kernel_slab_order_reproduces_the_plain_pack(family, S):
    """The bf16 kernel's MLP walked slab by slab (f32 sums of the bf16
    products, the last layer strip by strip into the field-major columns)
    gives the plain version's MLP output, and the plain tail on it the
    plain pack, with and without flow and contraction, at S = 8 and 64.
    2e-3: the two sum the same exact products in another order, and a
    hidden value may round to the neighbouring bf16 (chip_smoke.py
    PACK_TOL_BF16); a slab out of place is O(1)."""
    cf, params = _port_chain(family, S)
    spec, tabs = cf.spec, cf.prepare(params)["mlp"]
    x0, rp = _encoded_port(cf, entry_rays(128, seed=S))
    hidden, strips = _walk_slabs(tabs, spec)
    bf = lambda t: t.to(torch.bfloat16).float()          # noqa: E731
    cp = tabs.layers[0].w.shape[0]
    x = bf(torch.nn.functional.pad(x0, (0, cp - x0.shape[1])))
    h = None
    for (wh, wx), l in zip(hidden, tabs.layers):
        acc = 0.0
        if wh is not None:
            acc = acc + h @ wh.float()
        if wx is not None:
            acc = acc + x @ wx[:cp].float()
        y = acc + l.b
        h = bf(PB.apply_terms(y, tabs.layer_act.kernel_terms(20000))
               if l.act else y)
    last = tabs.layers[-1]
    out = torch.zeros(x0.shape[0], last.w.shape[1])
    for cols, ws in zip(PB.strip_columns(spec), strips):
        acc = h @ ws.float()
        for n, c in enumerate(cols):
            if c >= 0:
                out[:, c] = acc[:, n] + last.b[c]
    plain = PB.mlp_plain(x0, tabs)
    assert (out - plain).abs().max().item() <= 2e-3
    got = PB.tail_plain(out, rp, spec, 20000)
    want = PB.pack_build_plain(x0, tabs, rp, spec, 20000)
    assert (got - want).abs().max().item() <= 2e-3
    assert (got[3].reshape(128, S).diff(dim=1) >= 0).all()


@pytest.mark.parametrize("family,S", [
    ("flagship", 32), ("tiny_llff", 16), ("tiny_n3d", 64)])
def test_params_carry_the_slab_layout(family, S):
    """PackSpec.params hands the kernel the rows of every slab that
    mlp_tables laid out and the channels of every strip, which the launch
    plan (csrc/pack_build.cu plan_wgmma) checks against its own order."""
    cf, params = _port_chain(family, S)
    spec, tabs = cf.spec, cf.prepare(params)["mlp"]
    p = spec.params(1, tabs, 20000)
    assert p.n_slabs == len(tabs.slab_rows)
    assert list(p.slab_rows[:p.n_slabs]) == tabs.slab_rows
    assert sum(tabs.slab_rows) == p.wt_rows == tabs.tiled.shape[0]
    H = tabs.layers[0].w.shape[1]
    strips = PB.strip_columns(spec)
    assert tabs.slab_rows[-len(strips) * (H // 64):] == [
        len(c) for c in strips for _ in range(H // 64)]
    layout = PB.kernel_strips(S)
    assert p.n_strips == len(layout)
    for q, (chans, s0, ns) in enumerate(layout):
        want = [4 * PB.FIELDS.index(f) + c for f, c in chans]
        assert list(p.strip_fc[q]) == want + [-1] * (6 - len(want))
        assert list(p.strip_s[q]) == [s0, ns]


def _encoded_port(cf, rays):
    r = torch.from_numpy(rays)
    return (cf.pred.net_input(r, StepCtx(it=20000)).float().contiguous(),
            cf.ray_pack(r))
