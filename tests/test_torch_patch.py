"""The coherent patch-gather route's pieces against the JAX package: the
patch table, the anchors and the coverage witness (exact), the plain
versions of K4 (patch_blend), of K2 reading pre-blended features and of
K3 (shade_patch), each against its Pallas kernel in interpret mode on the
CPU, fed the same pack (the JAX kernels' S-major tile order) and each
package's tables built from the same weights."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from hyperreel_tpu.configs.presets import with_coherent_gather
from hyperreel_tpu.ops import patch_gather as JPG
from hyperreel_tpu.ops.pallas.patch_blend import (
    patch_anchor_idx, patch_blend as jax_patch_blend)
from hyperreel_tpu.ops.pallas.shade import fused_shade_composite
from hyperreel_tpu_torch.ops import patch_gather as PG
from hyperreel_tpu_torch.ops.kernels.layout import PACK_ROWS
from hyperreel_tpu_torch.ops.kernels.patch_blend import (
    PatchSpec, coverage_count, patch_anchors, patch_blend,
    patch_features_plain)
from hyperreel_tpu_torch.ops.kernels.shade import (
    ShadeSpec, premix_time, shade_preblended)
from hyperreel_tpu_torch.ops.kernels.shade_patch import shade_patch

from torch_parity import (
    flagship_cfg, jax_pack, jax_premix, models, smajor, weights)

B, TILE = 512, 32                 # B/TILE whole blocks of R in {4, 8}
PATCH = {4: (4, 3), 8: (5, 2)}    # the R=4 and the bench's R=8 shapes


def _coherent_pack(S, R, W, H, seed):
    """A port-layout pack [10, B*S] with the rays phase-major (ray R*j+p
    at position p*(B/R)+j) and a ray pack [B, 8]. Per (block, slot) the R
    rays sample points within 0.4 texel of each other, except one block
    in five whose rays spread over 3 texels (their footprints exit the
    patch); points partly outside the aabb, a few invalid (dist 0)
    samples, per-ray view directions, one t for every ray."""
    rng = np.random.default_rng(seed)
    J = B // R
    wide = rng.uniform(0, 1, (1, J, 1)) < 0.2
    xy = [rng.uniform(-1.05, 1.05, (1, J, S)) + rng.uniform(0, 1, (R, J, S))
          * np.where(wide, 3.0, spread) * 2.0 / (size - 1)
          for size, spread in ((W, 0.4), (H, 0.1))]
    xyz = np.stack(xy + [rng.uniform(-1.1, 1.1, (R, J, S))]).reshape(3, B, S)
    dist = np.sort(rng.uniform(0.0, 3.0, (B, S)), 1)
    dist[:, :2] *= rng.uniform(0, 1, (B, 1)) < 0.3
    cs = rng.normal(0, 0.1, (6, B, S))
    pack = np.concatenate([xyz, dist[None], cs], 0)
    vd = rng.normal(0, 1, (B, 3))
    vd /= np.linalg.norm(vd, axis=1, keepdims=True)
    rays = np.concatenate([rng.normal(0, 1, (B, 3)), vd,
                           rng.normal(0, 0.1, (B, 1)),
                           np.full((B, 1), rng.uniform(-1, 1))], 1)
    return (pack.reshape(PACK_ROWS, B * S).astype(np.float32),
            rays.astype(np.float32))


def _setup(tiny, R, cfg=None):
    """The model's tables in both packages (weights seed 1) and a
    coherent pack for them: the flagship or tiny_dynamic, or `cfg`."""
    px, py = PATCH[R]
    cfg = with_coherent_gather(cfg or flagship_cfg(tiny=tiny), px, py, R)
    jm, tm = models(cfg, bf16=False)
    jp, tp = weights(jm, seed=1)
    cf = tm._cf_eval
    prep = cf.prepare(tp)
    H, W, TH, TW, C, nd = prep["dims"]
    S = cf.S
    pack, rays = _coherent_pack(S, R, W, H, seed=S + R)
    spec = ShadeSpec(S=S, W=W, H=H, TW=TW, TH=0, C=C, nd=nd,
                     deg=cf.net.sh_deg, distance_scale=cf.net.distance_scale)
    pspec = PatchSpec(R=R, px=px, py=py, W=W, H=H, C=C, S=S,
                      phase_major=True)
    (_,), (ttab_t,), wb_t, (ptab_j,) = jm._cf_eval._plan_arrays(jp["color"])
    tn0 = float(rays[0, 7])
    return dict(jm=jm, prep=prep, spec=spec, pspec=pspec, pack=pack,
                rays=rays, ptab_j=ptab_j, ttab_t=ttab_t, wb_t=wb_t,
                ttab=premix_time(prep["ttab"], torch.tensor(tn0)),
                ttab_j=jax_premix(np.asarray(ttab_t), TH, C, tn0))


def _phase_major_rows(feats, S, R):
    """The port's features [B*S, C] (phase-major positions) -> the JAX
    blend's [R*C, J] layout: phase p's quarter, S-major, in rows p*C..."""
    C, J = feats.shape[1], B * S // R
    return smajor(feats.T, S, TILE).reshape(C, R, J).transpose(
        1, 0, 2).reshape(R * C, J)


def _jax_rows(d):
    """The JAX route's patch rows and anchors for the pack (fused_eval:
    patch_anchor_idx on the S-major pack, then the row gather)."""
    pk16 = jax_pack(d["pack"], d["rays"], d["spec"].S, TILE)
    ps = d["pspec"]
    pidx, anchors = patch_anchor_idx(jnp.asarray(pk16[0]),
                                     jnp.asarray(pk16[1]), ps.W, ps.H, R=ps.R)
    return pk16, d["ptab_j"][pidx], anchors


@pytest.mark.parametrize("px,py", [(4, 3), (5, 2)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_patch_table_matches_jax(px, py, dtype):
    plane = np.random.default_rng(0).normal(0, 1, (7, 9, 8)).astype(
        np.float32)
    jd, td = (jnp.float32, torch.float32) if dtype == "f32" \
        else (jnp.bfloat16, torch.bfloat16)
    want = np.asarray(JPG.build_patch_table_2d(
        jnp.asarray(plane).astype(jd), px, py).astype(jnp.float32))
    got = PG.build_patch_table_2d(torch.from_numpy(plane).to(td), px, py)
    assert got.dtype == td and got.shape == ((7 + 1) * (9 + 1), px * py * 8)
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_patch_gather_plain_functions_match_jax():
    """hat_weights, the plain blend and coverage_violations of
    ops/patch_gather.py against the JAX module."""
    rng = np.random.default_rng(1)
    R, px, py, C, n = 4, 4, 3, 8, 64
    rows = rng.normal(0, 1, (n // R, px * py * C)).astype(np.float32)
    u = rng.uniform(-1.5, px + 0.5, n).astype(np.float32)
    v = rng.uniform(-1.5, py + 0.5, n).astype(np.float32)
    np.testing.assert_array_equal(
        PG.hat_weights(torch.from_numpy(u), px).numpy(),
        np.asarray(JPG.hat_weights(jnp.asarray(u), px)))
    np.testing.assert_allclose(
        PG.patch_blend(torch.from_numpy(rows), torch.from_numpy(u),
                       torch.from_numpy(v), px, py, C).numpy(),
        np.asarray(JPG.patch_blend(jnp.asarray(rows), jnp.asarray(u),
                                   jnp.asarray(v), px, py, C)),
        rtol=1e-6, atol=1e-6)
    x = rng.uniform(0, 30, n).astype(np.float32)
    y = x + rng.uniform(0, 2, n).astype(np.float32)
    assert float(PG.coverage_violations(
        torch.from_numpy(x), torch.from_numpy(y), R, px, py)) == float(
        JPG.coverage_violations(jnp.asarray(x), jnp.asarray(y), R, px, py))


@pytest.mark.parametrize("R", [4, 8])
def test_anchors_and_witness_match_jax(R):
    """Anchors (patch_anchor_idx) exact; the coverage count equals the
    JAX route's witness (fused_eval patch_coverage_viol) on the same
    pack; the caller's ray order (phase-major or scanline) changes
    neither."""
    S, W, H = 8, 40, 24
    px, py = PATCH[R]
    pack, rays = _coherent_pack(S, R, W, H, seed=R)
    spec = PatchSpec(R=R, px=px, py=py, W=W, H=H, C=8, S=S,
                     phase_major=True)
    x0, y0, idx = patch_anchors(torch.from_numpy(pack), spec)
    jidx, janc = patch_anchor_idx(jnp.asarray(pack[0]), jnp.asarray(pack[1]),
                                  W, H, R=R)
    np.testing.assert_array_equal(idx.reshape(-1).numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(
        torch.stack([x0, y0]).reshape(2, -1).numpy(), np.asarray(janc))

    # the JAX witness (models/fused_eval.py:1096-1120) on the S-major pack
    pk16 = jax_pack(pack, rays, S, TILE)
    ok = ((np.abs(pk16[0]) <= 1) & (np.abs(pk16[1]) <= 1)
          & (np.abs(pk16[2]) <= 1) & (pk16[4] > 0))
    viol = np.zeros(B * S // R, bool)
    for m, size, budget in ((0, W, px), (1, H, py)):
        f = np.floor((pk16[m] + 1.0) * 0.5 * (size - 1))
        lo = np.where(ok, f, np.float32(3e38)).reshape(R, -1).min(0)
        hi = np.where(ok, f, np.float32(-3e38)).reshape(R, -1).max(0)
        with np.errstate(over="ignore"):      # -3e38 - 3e38 = -inf
            viol |= hi - lo > budget - 2
    count = int(coverage_count(torch.from_numpy(pack), [spec]))
    assert count == int(viol.sum()) and 0 < count < viol.size // 2

    # the same rays in scanline order give the same anchors and count
    scan = pack.reshape(PACK_ROWS, R, B // R, S).transpose(0, 2, 1, 3)
    scan = torch.from_numpy(np.ascontiguousarray(scan).reshape(
        PACK_ROWS, B * S))
    sspec = PatchSpec(**{**spec.__dict__, "phase_major": False})
    assert torch.equal(patch_anchors(scan, sspec)[2], idx)
    assert int(coverage_count(scan, [sspec])) == count


@pytest.mark.parametrize("R", [4, 8])
def test_plain_patch_blend_matches_jax_kernel(R):
    """K4: f32 features within 1e-5 (the same f32 terms, which XLA sums
    with fused multiply-adds: 2e-6 measured), the bf16 features the JAX
    route stores within one bf16 ulp of their value (plus that 1e-5)."""
    d = _setup(True, R)
    S, C = d["spec"].S, d["spec"].C
    pk16, rows, anchors = _jax_rows(d)
    J = B * S // R
    (got,), count = patch_blend([d["prep"]["patch"]],
                                torch.from_numpy(d["pack"]), [d["pspec"]])
    assert got.dtype == torch.bfloat16 and got.shape == (B * S, C)
    f32 = patch_features_plain(d["prep"]["patch"],
                               torch.from_numpy(d["pack"]), d["pspec"])
    for out_dtype, port, tol in ((jnp.float32, f32, 1e-5),
                                 (jnp.bfloat16, got.float(), None)):
        want = np.asarray(jax_patch_blend(
            rows, anchors, jnp.asarray(pk16), m0=0, m1=1, W=d["spec"].W,
            H=d["spec"].H, px=d["pspec"].px, py=d["pspec"].py, C=C,
            blkj=J // 4, out_dtype=out_dtype, interpret=True,
            R=R).astype(jnp.float32))                 # [R*C, J]
        mine = _phase_major_rows(port.numpy(), S, R)
        if tol is None:
            # one bf16 ulp of each feature's value, plus the f32
            # tolerance (f32 sums that differ by 2e-6 round apart)
            tol = 2.0 ** (np.floor(np.log2(np.maximum(
                np.abs(want), 2.0 ** -126))) - 7) + 1e-5
        assert (np.abs(mine - want) <= tol).all()
    assert np.abs(want).max() > 0.05                 # features are not 0
    assert count.dtype == torch.int32 and int(count) > 0


@pytest.mark.parametrize("R", [4, 8])
def test_plain_preblended_shade_matches_jax_kernel(R):
    """K2 reading pre-blended bf16 features (the two-kernel route) against
    the JAX kernel with preblended="phase_major", fed the same features;
    acc_dtype=f32, so f32 summation order is all that differs."""
    d = _setup(True, R)
    S = d["spec"].S
    pack = torch.from_numpy(d["pack"])
    (feats,), _ = patch_blend([d["prep"]["patch"]], pack, [d["pspec"]])
    fj = _phase_major_rows(feats.float().numpy(), S, R)
    want = np.asarray(fused_shade_composite(
        jnp.asarray(fj).astype(jnp.bfloat16),
        jnp.asarray(jax_pack(d["pack"], d["rays"], S, TILE)),
        jnp.asarray(d["ttab_j"]), d["wb_t"], S=S, W=d["spec"].W,
        H=d["spec"].H, TW=d["spec"].TW, TH=0, n_density=d["spec"].nd,
        n_basis=9, density_shift=0.0, distance_scale=d["spec"].distance_scale,
        tile=TILE, s_major=True, acc_dtype=jnp.float32,
        preblended="phase_major", patch_block=R))[:5].T
    got = shade_preblended(feats, pack, torch.from_numpy(d["rays"]),
                           d["ttab"], d["prep"]["wb"], d["spec"]).numpy()
    assert want[:, 3].max() > 0.5
    assert np.abs(got[:, :4] - want[:, :4]).max() <= 1e-5
    assert np.abs(got[:, 4] - want[:, 4]).max() <= 5e-5


@pytest.mark.parametrize("tiny,R", [(True, 4), (True, 8), (False, 8)],
                         ids=["tiny_S8_R4", "tiny_S8_R8", "flagship_S32_R8"])
def test_plain_shade_patch_matches_jax_kernel(tiny, R):
    """K3 against the JAX fused blend+shade kernel, acc_dtype=f32: the
    rgb/acc at 1e-5 and the depth at 5e-5, as K2's test holds them;
    out-of-patch blocks included."""
    d = _setup(tiny, R)
    S = d["spec"].S
    pk16, rows, anchors = _jax_rows(d)
    want = np.asarray(fused_shade_composite(
        rows, jnp.asarray(pk16), jnp.asarray(d["ttab_j"]), d["wb_t"], S=S,
        W=d["spec"].W, H=d["spec"].H, TW=d["spec"].TW, TH=0,
        n_density=d["spec"].nd, n_basis=9, density_shift=0.0,
        distance_scale=d["spec"].distance_scale, tile=TILE, s_major=True,
        acc_dtype=jnp.float32, preblended="fused_patch", anchors=anchors,
        patch_pxy=PATCH[R], m0=0, m1=1, patch_block=R))[:5].T
    got, count = shade_patch(d["prep"]["patch"], torch.from_numpy(d["pack"]),
                             torch.from_numpy(d["rays"]), d["ttab"],
                             d["prep"]["wb"], d["spec"], d["pspec"])
    assert got.shape == (B, 5) and int(count) > 0
    assert want[:, 3].max() > 0.5
    assert np.abs(got[:, :4] - want[:, :4]).max() <= 1e-5
    assert np.abs(got[:, 4] - want[:, 4]).max() <= 5e-5


def test_patch_wrappers_check_their_inputs():
    d = _setup(True, 8)
    pack = torch.from_numpy(d["pack"])
    ptab = d["prep"]["patch"]
    with pytest.raises(ValueError):            # not whole blocks of R
        patch_blend([ptab], pack[:, :-d["spec"].S].contiguous(),
                    [d["pspec"]])
    with pytest.raises(ValueError):            # f32 table
        patch_blend([ptab.float()], pack, [d["pspec"]])
    with pytest.raises(ValueError):            # patch shape of another spec
        patch_blend([ptab], pack, [PatchSpec(**{**d["pspec"].__dict__,
                                               "px": 4})])
    with pytest.raises(ValueError):            # ray pack of another size
        shade_patch(ptab, pack, torch.from_numpy(d["rays"][:-1]).contiguous(),
                    d["ttab"], d["prep"]["wb"], d["spec"], d["pspec"])
