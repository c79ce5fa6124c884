"""The grid lookups' autograd Functions (hyperreel_tpu_torch/ops/
grid_sample.py) against jax.vjp of the JAX package's quad lookups with
their custom VJP (hyperreel_tpu/ops/grid_sample.py grid_sample_2d_cf_quad,
grid_sample_1d_cf_quad): the value, the grid gradient and the coordinate
gradient, on f32 and bf16 tables, with coordinates inside, on texel edges
and out of range."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from hyperreel_tpu.ops.grid_sample import (
    grid_sample_1d_cf_quad, grid_sample_2d_cf_quad)
from hyperreel_tpu_torch.ops.grid_sample import grid_sample_1d, grid_sample_2d

BF16_ULP = 2.0 ** -8     # bf16's relative spacing


def _coords(rng, n, sizes):
    """[n, len(sizes)] coordinates: a third uniform inside [-1, 1], a third
    exactly on texel centres (the lattice -1 + 2k/(size-1), where the
    floor's fraction is 0), a third out of range (|c| up to 3)."""
    m = n // 3
    cols = []
    for s in sizes:
        inside = rng.uniform(-1, 1, m)
        edges = -1.0 + 2.0 * rng.integers(0, s, m) / (s - 1)
        out = rng.uniform(1.0, 3.0, n - 2 * m) * rng.choice([-1, 1],
                                                             n - 2 * m)
        cols.append(np.concatenate([inside, edges, out]))
    return np.stack(cols, -1).astype(np.float32)


def _to_jax_layout(g, C):
    """[N, C] -> the quad lookups' word-major [C//2, N, 2]."""
    return g.reshape(-1, C // 2, 2).transpose(1, 0, 2)


def _vjp_both(jax_fn, port_fn, table, coords, g, dtype):
    """(jax value [N, C], grid grad, coord grad) and the port's, f32
    numpy; `table` is cast to `dtype` on both sides."""
    C = table.shape[-1]
    jt = jnp.asarray(table).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    out, vjp = jax.vjp(jax_fn, jt, jnp.asarray(coords))
    gj, cj = vjp(jnp.asarray(_to_jax_layout(g, C)))
    want = (np.asarray(out).transpose(1, 0, 2).reshape(-1, C),
            np.asarray(gj.astype(jnp.float32)), np.asarray(cj))
    tt = torch.from_numpy(table).to(dtype).requires_grad_(True)
    tc = torch.from_numpy(coords).requires_grad_(True)
    val = port_fn(tt, tc)
    gt, ct = torch.autograd.grad(val, (tt, tc), torch.from_numpy(g))
    assert gt.dtype == dtype
    got = (val.detach().numpy(), gt.float().numpy(), ct.numpy())
    return want, got


# Tolerances: the values run the same f32 products and sums (1e-6); the
# grid gradient sums the same f32 terms in another order (XLA's scatter
# into the padded quad layout and its fold, against one index_add_), 1e-5
# of its largest entry on f32 tables, and on bf16 tables the two f32 sums
# may round to neighbouring bf16 values: one bf16 ulp of each entry; the
# coordinate gradient is the same f32 contraction of the same texels
# (1e-5 of its largest entry).
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("dim", [2, 1])
def test_lookup_matches_jax_vjp(dtype, dim):
    rng = np.random.default_rng(dim)
    H, W, C, N = 7, 9, 8, 3000
    if dim == 2:
        table = rng.normal(size=(H, W, C)).astype(np.float32)
        coords = _coords(rng, N, (W, H))
        fns = (grid_sample_2d_cf_quad, grid_sample_2d)
    else:
        table = rng.normal(size=(W, C)).astype(np.float32)
        coords = _coords(rng, N, (W,))[:, 0]
        fns = (grid_sample_1d_cf_quad, grid_sample_1d)
    g = rng.normal(size=(N, C)).astype(np.float32)
    (v0, g0, c0), (v1, g1, c1) = _vjp_both(*fns, table, coords, g, dtype)
    assert np.abs(v1 - v0).max() <= 1e-6
    if dtype == torch.float32:
        assert np.abs(g1 - g0).max() <= 1e-5 * np.abs(g0).max()
    else:
        assert (np.abs(g1 - g0) <= BF16_ULP * np.abs(g0) + 1e-30).all()
    assert np.abs(c1 - c0).max() <= 1e-5 * np.abs(c0).max()
    # the out-of-range third has zero value and gradient where no corner
    # is in range (|c| > 1 + one texel)
    far = (np.abs(coords.reshape(N, -1)) > 1.3).any(-1)
    assert np.all(v1[far] == 0.0) and np.all(c1.reshape(N, -1)[far] == 0.0)


def test_bf16_grid_gradient_sums_in_f32():
    """Thousands of samples per texel: the Function's bf16 grid gradient is
    JAX's f32 sum rounded once (within a bf16 ulp), where autograd through
    a bf16 gather (`flat[idx]`) would scatter-add in bf16 and lose most of
    the sum."""
    rng = np.random.default_rng(7)
    H, W, C, N = 3, 3, 4, 40000
    table = rng.normal(size=(H, W, C)).astype(np.float32)
    coords = rng.uniform(-1, 1, (N, 2)).astype(np.float32)
    g = rng.uniform(0.5, 1.5, (N, C)).astype(np.float32)
    (_, g0, _), (_, g1, _) = _vjp_both(
        grid_sample_2d_cf_quad, grid_sample_2d, table, coords, g,
        torch.bfloat16)
    assert (np.abs(g1 - g0) <= BF16_ULP * np.abs(g0)).all()
    # the bf16 scatter that plain autograd would run
    tt = torch.from_numpy(table).to(torch.bfloat16).requires_grad_(True)
    x = (torch.from_numpy(coords[:, 0]) + 1) * 0.5 * (W - 1)
    y = (torch.from_numpy(coords[:, 1]) + 1) * 0.5 * (H - 1)
    x0, y0 = torch.floor(x), torch.floor(y)
    val = 0.0
    for yc, xc, w in ((y0, x0, (1 - (y - y0)) * (1 - (x - x0))),
                      (y0, x0 + 1, (1 - (y - y0)) * (x - x0)),
                      (y0 + 1, x0, (y - y0) * (1 - (x - x0))),
                      (y0 + 1, x0 + 1, (y - y0) * (x - x0))):
        ok = ((xc <= W - 1) & (yc <= H - 1)).float()
        idx = yc.clamp(0, H - 1).long() * W + xc.clamp(0, W - 1).long()
        val = val + tt.reshape(H * W, C)[idx].float() * (w * ok)[:, None]
    gb, = torch.autograd.grad(val, tt, torch.from_numpy(g))
    bf16_err = np.abs(gb.float().numpy() - g0).max() / np.abs(g0).max()
    assert bf16_err > 30 * BF16_ULP, bf16_err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("dim", [2, 1])
def test_eval_lookup_equals_the_function(dtype, dim):
    """Where autograd records nothing (no input requires grad, or under
    no_grad) the lookup is the plain per-corner forward, which keeps no
    residuals: its value equals the autograd Function's to the bit."""
    rng = np.random.default_rng(10 + dim)
    H, W, C, N = 7, 9, 8, 600
    shape = (H, W, C) if dim == 2 else (W, C)
    table = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
        dtype)
    coords = torch.from_numpy(_coords(rng, N, (W, H)[:dim]))
    if dim == 1:
        coords = coords[:, 0]
    fn = grid_sample_2d if dim == 2 else grid_sample_1d
    plain = fn(table, coords)
    with torch.no_grad():
        plain_ng = fn(table.clone().requires_grad_(True), coords)
    recorded = fn(table.clone().requires_grad_(True), coords)
    assert not plain.requires_grad and plain.grad_fn is None
    assert not plain_ng.requires_grad
    assert recorded.grad_fn is not None
    assert torch.equal(plain, recorded.detach())
    assert torch.equal(plain_ng, plain)


@pytest.mark.parametrize("dim", [2, 1])
def test_nan_coordinate_gives_nan_as_jax(dim):
    """A NaN coordinate (a diverged model's sample) gives that sample NaN
    features in both packages, the others unchanged: the JAX quad gather
    clamps its index; the port's reads texel 0 under a NaN weight, where
    a NaN index would read out of bounds (a device-side assert on the
    card, an IndexError here)."""
    rng = np.random.default_rng(5)
    sizes = (12, 9) if dim == 2 else (11,)
    table = rng.normal(size=sizes[::-1] + (8,)).astype(np.float32)
    coords = rng.uniform(-1, 1, (6, dim)).astype(np.float32)
    coords[2, 0] = np.nan
    if dim == 2:
        want = np.asarray(grid_sample_2d_cf_quad(jnp.asarray(table),
                                                 jnp.asarray(coords)))
        got = grid_sample_2d(torch.from_numpy(table),
                             torch.from_numpy(coords)).numpy()
    else:
        want = np.asarray(grid_sample_1d_cf_quad(
            jnp.asarray(table), jnp.asarray(coords[:, 0])))
        got = grid_sample_1d(torch.from_numpy(table),
                             torch.from_numpy(coords[:, 0])).numpy()
    want = want.transpose(1, 0, 2).reshape(-1, 8)
    assert np.isnan(got[2]).all() and np.isnan(want[2]).all()
    keep = np.arange(6) != 2
    np.testing.assert_allclose(got[keep], want[keep], rtol=0, atol=1e-6)
