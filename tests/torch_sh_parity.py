"""Shared set-up of the SH-degree parity tests (tests/test_torch_sh_*.py):
small tables of tiny_dynamic and tiny_static in both packages (weights from
the port's init, converted), packs of 128 rays at S = 8 in 32-ray tiles,
and a random SH basis of each degree in both packages' layouts."""

import functools

import numpy as np

import jax.numpy as jnp
import torch

from hyperreel_tpu.configs.presets import with_coherent_gather
from hyperreel_tpu.ops.pallas.patch_blend import patch_anchor_idx
from hyperreel_tpu.ops.pallas.shade import kmajor_perm
from hyperreel_tpu_torch.ops.kernels.layout import PACK_ROWS
from hyperreel_tpu_torch.ops.kernels.patch_blend import PatchSpec
from hyperreel_tpu_torch.ops.kernels.shade import ShadeSpec, premix_time

from torch_parity import (
    flagship_cfg, jax_premix, models, port_weights, smajor, static_cfg)

B, TILE, S, R = 128, 32, 8, 4
PATCH = (4, 3)
DEGREES = (0, 1, 3, 4)
TOL = 1e-5          # rgb/acc, f32 sums in another order; depth 5 TOL


def basis(deg, A, nd, seed):
    """A random SH basis [3K, nd + A], zero on the nd density columns
    (port rows c*K + k), and the JAX kernels' k-major rows of it."""
    K = (deg + 1) ** 2
    rng = np.random.default_rng(seed)
    wb = np.concatenate([np.zeros((3 * K, nd), np.float32),
                         rng.normal(0, 0.3, (3 * K, A)).astype(np.float32)],
                        1)
    return torch.from_numpy(wb), jnp.asarray(wb[kmajor_perm(3 * K)])


def close(got, want):
    got = np.asarray(got)
    assert want[:, 3].max() > 0.5          # the scene is not transparent
    assert np.abs(got[:, :4] - want[:, :4]).max() <= TOL
    assert np.abs(got[:, 4] - want[:, 4]).max() <= 5 * TOL


def coherent_pack(sizes, seed):
    """A port pack [10, B*S], rays phase-major (ray R*j + p at position
    p*(B/R) + j), and a ray pack [B, 8] with one t: per (block, slot) the
    R rays' points within 0.4 texel on the first two components (`sizes`
    their grid sizes) except one block in five spread over 3 texels;
    points partly outside the aabb, a few invalid (dist 0) samples."""
    rng = np.random.default_rng(seed)
    J = B // R
    wide = rng.uniform(0, 1, (1, J, 1)) < 0.2
    comps = [rng.uniform(-1.05, 1.05, (1, J, S)) + rng.uniform(
        0, 1, (R, J, S)) * np.where(wide, 3.0, spread) * 2.0 / (size - 1)
        for size, spread in zip(sizes, (0.4, 0.1, 0.1))]
    xyz = np.stack(comps).reshape(3, B, S)
    dist = np.sort(rng.uniform(0.0, 3.0, (B, S)), 1)
    dist[:, :2] *= rng.uniform(0, 1, (B, 1)) < 0.3
    pack = np.concatenate([xyz, dist[None], rng.normal(0, 0.1, (6, B, S))])
    vd = rng.normal(0, 1, (B, 3))
    vd /= np.linalg.norm(vd, axis=1, keepdims=True)
    rays = np.concatenate([rng.normal(0, 1, (B, 3)), vd,
                           rng.normal(0, 0.1, (B, 1)),
                           np.full((B, 1), rng.uniform(-1, 1))], 1)
    return (pack.reshape(PACK_ROWS, B * S).astype(np.float32),
            rays.astype(np.float32))


def jax_pack16(pack, rays):
    """The port's pack -> the JAX multi-axis kernels' 16-row pack (rows
    as tests/test_torch_multi.py lays them), S-major tiles."""
    p16 = np.zeros((16, B, S), np.float32)
    p16[[0, 1, 2, 4, 5, 6, 7, 8, 9, 10]] = pack.reshape(PACK_ROWS, B, S)
    p16[11:14] = rays[:, 3:6].T[:, :, None]
    return smajor(p16.reshape(16, B * S), S, TILE)


def phase_major_rows(feats):
    """The port's features [B*S, C] (phase-major) -> the JAX blend's [R*C,
    J] layout."""
    C, J = feats.shape[1], B * S // R
    return smajor(feats.T, S, TILE).reshape(C, R, J).transpose(
        1, 0, 2).reshape(R * C, J)


def quad_rows(table, pk16, m0, m1, W, H):
    """The quad-table rows of the JAX pack's samples (fused_eval's
    gather between the kernels)."""
    xi = (np.clip(np.floor((pk16[m0] + 1.0) * 0.5 * (W - 1)), -1, W - 1)
          + 1).astype(np.int32)
    yi = (np.clip(np.floor((pk16[m1] + 1.0) * 0.5 * (H - 1)), -1, H - 1)
          + 1).astype(np.int32)
    return jnp.asarray(np.asarray(table)[yi * (W + 1) + xi])


def patch_rows(ptab, pk16, m0, m1, W, H):
    """A plane's JAX patch rows and anchors for the pack."""
    pidx, anchors = patch_anchor_idx(jnp.asarray(pk16[m0]),
                                     jnp.asarray(pk16[m1]), W, H, R=R)
    return ptab[pidx], anchors


@functools.lru_cache(maxsize=None)
def single_tables():
    """tiny_dynamic's tables on the patch route in both packages: the
    port's prepared tables, the JAX plan arrays (quad, time, patch), the
    specs, and a coherent pack with the time planes premixed for its t."""
    cfg = with_coherent_gather(flagship_cfg(tiny=True), *PATCH, R)
    jm, tm = models(cfg, bf16=False)
    jp, tp = port_weights(tm, seed=1)
    cf = tm._cf_eval
    prep = cf.prepare(tp)
    H, W, TH, TW, C, nd = prep["dims"]
    assert cf.S == S
    pack, rays = coherent_pack((W, H, 8), seed=5)
    spec = ShadeSpec(S=S, W=W, H=H, TW=TW, TH=0, C=C, nd=nd, deg=2,
                     distance_scale=cf.net.distance_scale)
    pspec = PatchSpec(R=R, px=PATCH[0], py=PATCH[1], W=W, H=H, C=C, S=S,
                      phase_major=True)
    (qt,), (ttab_t,), _, (ptab_j,) = jm._cf_eval._plan_arrays(jp["color"])
    tn0 = float(rays[0, 7])
    return dict(prep=prep, spec=spec, pspec=pspec, pack=pack, rays=rays,
                qt=qt, ptab_j=ptab_j,
                ttab=premix_time(prep["ttab"], torch.tensor(tn0)),
                ttab_j=jax_premix(np.asarray(ttab_t), TH, C, tn0))


@functools.lru_cache(maxsize=None)
def multi_tables():
    """tiny_static's [8, 4, 4] tables on the patch route in both packages
    (density planes and lines in [0, 0.3)) and a coherent pack."""
    from hyperreel_tpu_torch.ops.kernels.shade_multi import MultiSpec
    cfg = with_coherent_gather(static_cfg(S=S), *PATCH, R)
    jm, tm = models(cfg, bf16=False)
    jp, tp = port_weights(tm, seed=1, density=0.3)
    cf = tm._cf_eval
    prep = cf.prepare(tp)
    tables, lines, _, ptabs = jm._cf_eval._plan_arrays(jp["color"])
    spec = MultiSpec(S=S, axes=prep["axes"], deg=2,
                     distance_scale=cf.net.distance_scale)
    axes = spec.axes
    pack, rays = coherent_pack((axes[0].W, axes[0].H, axes[1].H), seed=6)
    rays[:, 6:] = 0.0
    pspecs = cf.patch_specs([(a.W, a.H, a.C, a.m0, a.m1) for a in axes],
                            True)
    return dict(prep=prep, spec=spec, pspecs=pspecs, pack=pack, rays=rays,
                jtables=tables, jlines=lines, jptabs=ptabs)
