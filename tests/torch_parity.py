"""Shared set-up of the JAX-vs-PyTorch parity tests (tests/test_torch_*.py):
the same configs, weights and rays for hyperreel_tpu and
hyperreel_tpu_torch, made with numpy from fixed seeds."""

import copy
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from hyperreel_tpu.configs.presets import (
    convert_epochs_to_iters, llff_z_plane, technicolor_z_plane, tiny_dynamic,
    tiny_shiny, tiny_stanford_llff, tiny_static)
from hyperreel_tpu.models.model import build_model as build_jax
from hyperreel_tpu.ops.pallas import shade as jax_shade
from hyperreel_tpu_torch.convert import params_from_jax, params_to_jax
from hyperreel_tpu_torch.models.model import build_model as build_torch
from hyperreel_tpu_torch.ops.kernels.layout import JAX_PACK_ROWS, PACK_ROWS

# the flagship's dataset as __graft_entry__.entry() builds it
INFO = {"num_keyframes": 4, "num_frames": 50, "num_views": 16}
ITERS_PER_EPOCH = 4000


def flagship_cfg(tiny=False, fused=True, bf16_tables=True):
    """technicolor_z_plane at full width, or tiny_dynamic; `fused=False`
    selects the general stage chain in both packages (fused_render and
    fused_render_cf off, as tests/test_fused_cf.py builds it). The fused
    path requires bf16 tables."""
    cfg = convert_epochs_to_iters(
        tiny_dynamic() if tiny else technicolor_z_plane(), ITERS_PER_EPOCH)
    net = cfg["color"]["net"]
    net["fused_render"] = fused
    net["bf16_tables"] = bf16_tables
    if not fused:
        net["fused_render_cf"] = False
    return cfg


def static_cfg(S=8, comps=(8, 4, 4), full=False, fused=True,
               bf16_tables=True):
    """tiny_static (S samples, `comps` density and appearance components
    per axis; the llff_z_plane family's [8, 4, 4] by default) or, with
    `full`, llff_z_plane's 6x256 MLP on tiny_static's 32^3 grid; fused and
    bf16_tables as flagship_cfg takes them."""
    cfg = convert_epochs_to_iters(tiny_static(z_channels=S), ITERS_PER_EPOCH)
    if full:
        cfg["embedding"]["embeddings"]["ray_prediction_0"]["net"] = \
            llff_z_plane()["embedding"]["embeddings"]["ray_prediction_0"][
                "net"]
    net = cfg["color"]["net"]
    net.update(n_lamb_sigma=list(comps), n_lamb_sh=list(comps),
               fused_render=fused, bf16_tables=bf16_tables)
    if not fused:
        net["fused_render_cf"] = False
    return cfg


def rgb_cfg(family, S=8, cf=True, fused=True):
    """The static RGB families at test size: tiny_shiny (without its
    sample stages; [4, 4, 4] components) or tiny_stanford_llff ([4, 0,
    0]), with bf16 tables, which the fused routes need (the port's tiny
    presets set them). `cf=False` turns the channels-first route off (the
    net's own fused route then runs after the general chain), `fused=False`
    both fused routes."""
    cfg = tiny_shiny(z_channels=S, sample_stages=False) \
        if family == "shiny" else tiny_stanford_llff(z_channels=S)
    cfg = convert_epochs_to_iters(cfg, ITERS_PER_EPOCH)
    net = cfg["color"]["net"]
    net.update(bf16_tables=True, fused_render=fused)
    if not (cf and fused):
        net["fused_render_cf"] = False
    return cfg


def models(cfg, bf16, info=INFO):
    """(JAX model, port model) for one config, precision policy and
    dataset_info."""
    return (build_jax(copy.deepcopy(cfg), dataset_info=info,
                      compute_dtype=jnp.bfloat16 if bf16 else None),
            build_torch(copy.deepcopy(cfg), dataset_info=info,
                        compute_dtype=torch.bfloat16 if bf16 else None))


@pytest.fixture
def f32_acc(monkeypatch):
    """The JAX shade kernels with their accumulation in f32 (their
    acc_dtype, bf16 by default: a bf16 line and time lookup, ROADMAP.md 3),
    as the port's kernels accumulate, for tests that hold the nets' own
    fused routes against the JAX package's."""
    for name in ("fused_shade_composite", "fused_shade_composite_multi"):
        monkeypatch.setattr(jax_shade, name, functools.partial(
            getattr(jax_shade, name), acc_dtype=jnp.float32))


def weights(jax_model, seed=0, density=1.0):
    """JAX init weights with the density grids redrawn uniform in [0,
    density) (the relu init is a constant 1e-2, an almost transparent
    scene that would leave the compositing untested). Returns (jax params,
    port params)."""
    pn = jax.tree.map(np.asarray, jax_model.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 1)
    for k, v in pn["color"]["density"].items():
        pn["color"]["density"][k] = rng.uniform(0, density, v.shape).astype(
            np.float32)
    return jax.tree.map(jnp.asarray, pn), params_from_jax(pn, device="cpu")


def port_weights(port_model, seed=0, density=1.0):
    """`weights` from the port's init (a seeded torch.Generator; the JAX
    package's init takes seconds on the CPU): (jax params, port
    params)."""
    pn = params_to_jax(port_model.init(torch.Generator().manual_seed(seed),
                                       "cpu"))
    rng = np.random.default_rng(seed + 1)
    for k, v in pn["color"]["density"].items():
        pn["color"]["density"][k] = rng.uniform(0, density, v.shape).astype(
            np.float32)
    return jax.tree.map(jnp.asarray, pn), params_from_jax(pn, device="cpu")


def entry_rays(n, seed=0, t=None):
    """__graft_entry__.entry()'s ray recipe: origins around z=-1.5,
    directions with d_z = 1, a camera index and a time in [0, 1) (or the
    one time `t` for every ray)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    o[:, 2] -= 1.5
    d = rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32)
    d[:, 2] = 1.0
    cam = rng.integers(0, 16, (n, 1)).astype(np.float32)
    times = rng.uniform(0, 1, (n, 1)).astype(np.float32) if t is None \
        else np.full((n, 1), t, np.float32)
    return np.concatenate([o, d, cam, times], -1)


def static_rays(n, seed=0):
    """entry_rays' origins and directions (a static scene has no camera
    index or time column)."""
    return np.ascontiguousarray(entry_rays(n, seed)[:, :6])


def smajor(cols, S, tile):
    """[rows, B*S] columns in ray-major order -> the JAX kernels' S-major
    tile order (lane s*tile + r within each block of tile rays)."""
    rows, N = cols.shape
    return cols.reshape(rows, N // (S * tile), tile, S).transpose(
        0, 1, 3, 2).reshape(rows, N)


def scanline_inputs(pack, rays, feats, S, R):
    """A phase-major pack [rows, B*S], ray pack [B, 8] and per-sample rows
    [B*S, C] (ray R*j + p of coherent block j at position p*(B/R) + j),
    torch -> the same rays in scanline order (ray R*j + p at position
    R*j + p) and, per position of that order, the ray's phase-major
    position."""
    B = rays.shape[0]
    q = torch.arange(B)
    idx = (q % R) * (B // R) + q // R
    rows = (idx[:, None] * S + torch.arange(S)).reshape(-1)
    return pack[:, rows].contiguous(), rays[idx], [f[rows] for f in feats], \
        idx


def check_folded_patch_plains(folded, plain, want, args, order, idx, tol):
    """Hold a folded plain version (K6's or K5-pre's) against the JAX
    kernel's phase-major output `want` [B, 5] (rgb/acc within tol, depth
    within 10 tol) and against the plain version on the same inputs
    (`args`, in the delivered order whose rays sit at the phase-major
    positions idx, or None), with equal witness counts where they return
    one."""
    got, ref = folded(*args), plain(*args)
    if isinstance(got, tuple):
        assert int(got[1]) == int(ref[1]) > 0
        got, ref = got[0], ref[0]
    got, ref = got.numpy(), ref.numpy()
    if idx is not None:
        got_pm = np.empty_like(got)
        got_pm[idx.numpy()] = got
        got = got_pm
        ref_pm = np.empty_like(ref)
        ref_pm[idx.numpy()] = ref
        ref = ref_pm
    assert want[:, 3].max() > 0.5, order     # the scene is not transparent
    for other in (want, ref):
        assert np.abs(got[:, :4] - other[:, :4]).max() <= tol
        assert np.abs(got[:, 4] - other[:, 4]).max() <= 10 * tol


def jax_pack(pack, rays, S, tile):
    """Port pack [10, B*S] and ray pack [B, 8] -> the JAX kernels' 16-row
    pack in S-major tile order (tn in row 3, the view direction in rows
    11..13)."""
    B = rays.shape[0]
    p16 = np.zeros((16, B, S), np.float32)
    p16[list(JAX_PACK_ROWS)] = pack.reshape(PACK_ROWS, B, S)
    p16[3] = rays[:, 7:8]
    p16[11:14] = rays[:, 3:6].T[:, :, None]
    return smajor(p16.reshape(16, B * S), S, tile)


def jax_premix(ttab_t, TH, C, tn0):
    """hyperreel_tpu/models/fused_eval.py _premix (uniform time), numpy."""
    pt = (tn0 + 1.0) * 0.5 * (TH - 1)
    p0 = np.floor(pt)
    ft = pt - p0
    tb = int(np.clip(p0, -1.0, TH - 1.0) + 1.0)
    t_lo = float(0.0 <= p0 <= TH - 1.0)
    t_hi = float(0.0 <= p0 + 1.0 <= TH - 1.0)
    k = np.arange(TH + 2)
    mk = np.where(k == tb, (1.0 - ft) * t_lo, 0.0) \
        + np.where(k == tb + 1, ft * t_hi, 0.0)
    return np.tensordot(mk.astype(np.float32),
                        ttab_t.reshape(TH + 2, C, -1), axes=1)
