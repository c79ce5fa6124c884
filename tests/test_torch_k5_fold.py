"""K5's folded SH colour in hyperreel_tpu_torch on the CPU. The kernels
fold the SH basis with each ray's view direction once per ray and take a
[3, A] product per sample; `fold_sh_basis` is the plain form of that fold
(held against the unfolded basis product at every SH degree), and
`shade_multi_folded_plain` the whole K5 function with it. Both are held
against the unfolded plain colour and against the JAX package's Pallas
kernel in interpret mode (fed the same pack in its S-major tile order and
tables built from the same weights), on the static llff layout at S = 8,
16 and 32 (also with the weights row) and on the dynamic one's time
planes at S = 8, 32 and 64."""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from hyperreel_tpu_torch.ops.kernels.shade import fold_sh_basis
from hyperreel_tpu_torch.ops.kernels.shade_multi import (
    shade_multi_folded_plain, shade_multi_plain)
from hyperreel_tpu_torch.ops.sh import eval_sh_bases

import test_torch_dynamic_multi as dyn
import test_torch_multi as static
from torch_parity import jax_pack, smajor

# f32 throughout: the fold only reorders the sums (1e-5 on rgb/acc, 5e-5
# on depth, the tolerances of the unfolded plain version against the JAX
# kernel at f32)
TOL = 1e-5


@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
def test_fold_is_the_basis_product(deg):
    """Per sample, M @ app equals sum_k Y_k (wb @ app)_k."""
    rng = np.random.default_rng(deg)
    n, A, K = 257, 16, (deg + 1) ** 2
    wb = torch.from_numpy(rng.normal(0, 0.3, (3 * K, A)).astype(np.float32))
    dirs = torch.from_numpy(rng.normal(0, 1, (n, 3)).astype(np.float32))
    dirs = dirs / dirs.norm(dim=1, keepdim=True)
    app = torch.from_numpy(rng.normal(0, 1, (n, A)).astype(np.float32))
    M = fold_sh_basis(wb, dirs, deg)
    assert M.shape == (n, 3, A)
    folded = (M @ app[..., None])[..., 0]
    Y = eval_sh_bases(deg, dirs)
    unfolded = ((app @ wb.t()).reshape(n, 3, K) * Y[:, None]).sum(-1)
    assert (folded - unfolded).abs().max() <= TOL


def _check(got, want):
    assert np.abs(got[:, :4] - want[:, :4]).max() <= TOL
    assert np.abs(got[:, 4] - want[:, 4]).max() <= 5 * TOL


@pytest.mark.parametrize("S,wrow", [(8, False), (16, False), (32, False),
                                   (8, True)],
                         ids=["S8", "S16", "S32", "S8-weights"])
def test_folded_colour_on_lines_matches_unfolded_and_jax(S, wrow):
    d = static._tables(S, 8)
    spec = d["spec"]
    pack, rays = static._pack(S, 8, spec.axes, seed=40 + S, coherent=False)
    pk16 = static._jax_pack16(pack, rays, S)
    if wrow:
        w = np.random.default_rng(S).uniform(0, 2, (1, static.B * S))
        pk16[14] = smajor(w.astype(np.float32), S, static.TILE)[0]
        pack = np.ascontiguousarray(np.concatenate([pack, w]).astype(
            np.float32))
        spec = dataclasses.replace(spec, weights=True)
    want = static._jax_multi(d, pk16, dyn._quad_rows(d, pk16), jnp.float32,
                             use_weights_row=wrow)
    pr = d["prep"]
    args = (pr["quads"], pr["lines"], torch.from_numpy(pack),
            torch.from_numpy(rays), pr["wb"], spec)
    folded = shade_multi_folded_plain(*args).numpy()
    assert want[:, 3].max() > 0.5          # the scene is not transparent
    _check(folded, shade_multi_plain(*args).numpy())
    _check(folded, want)


@pytest.mark.parametrize("S", [8, 32, 64])
def test_folded_colour_on_time_planes_matches_unfolded_and_jax(S):
    d = dyn._tables(S, 8)
    axes = d["spec"].axes
    assert [a.TH for a in axes] == [4, 4, 4]
    pack, rays = dyn._pack(S, 8, axes, seed=7)
    want = dyn._jax_multi(d, jax_pack(pack, rays, S, dyn.TILE),
                          dyn._quad_rows(d, jax_pack(pack, rays, S, dyn.TILE)),
                          d["jtimes"], [a.TH for a in axes], jnp.float32)
    pr = d["prep"]
    args = (pr["quads"], pr["lines"], torch.from_numpy(pack),
            torch.from_numpy(rays), pr["wb"], d["spec"])
    folded = shade_multi_folded_plain(*args).numpy()
    assert want[:, 3].max() > 0.5
    _check(folded, shade_multi_plain(*args).numpy())
    _check(folded, want)
