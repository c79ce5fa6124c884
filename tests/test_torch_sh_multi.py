"""SH of degree 0, 1, 3 and 4 in the multi-axis shade kernels' plain
versions (K5, K5 on pre-blended features, K6), against the JAX package's
Pallas kernel on the CPU: per degree a random basis [3 (deg + 1)^2, 16]
on tiny_static's [8, 4, 4] tables and a coherent pack of 128 rays at S =
8 (tests/torch_sh_parity.py), each port plain version (folded and
unfolded) against the kernel in interpret mode with f32 accumulation:
rgb/acc within 1e-5, depth 5e-5."""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from hyperreel_tpu.ops.pallas.shade import fused_shade_composite_multi
from hyperreel_tpu_torch.ops.kernels.patch_blend import patch_blend
from hyperreel_tpu_torch.ops.kernels.shade_multi import (
    shade_multi, shade_multi_folded_plain, shade_multi_preblended,
    shade_multi_preblended_folded_plain)
from hyperreel_tpu_torch.ops.kernels.shade_multi_patch import (
    shade_multi_patch, shade_multi_patch_folded_plain)

from torch_sh_parity import (
    DEGREES, PATCH, R, S, TILE, basis, close, jax_pack16, multi_tables,
    patch_rows, phase_major_rows, quad_rows)

torch.set_num_threads(1)


def _jax_multi(d, spec, wb_j, pk16, rows_list, **kw):
    return np.asarray(fused_shade_composite_multi(
        rows_list, jnp.asarray(pk16), d["jlines"], wb_j,
        axes=[a.index for a in spec.axes], S=S,
        grid_dims=[(a.W, a.H) for a in spec.axes],
        line_lens=[a.L for a in spec.axes], time_hs=[0, 0, 0],
        dens_c=[a.nd for a in spec.axes],
        app_c=[a.C - a.nd for a in spec.axes],
        n_basis=(spec.deg + 1) ** 2, density_shift=0.0,
        distance_scale=spec.distance_scale, tile=TILE, s_major=True,
        acc_dtype=jnp.float32, **kw))[:5].T


@pytest.mark.parametrize("deg", DEGREES)
def test_multi_axis_kernels_at_degree(deg):
    d = multi_tables()
    spec = dataclasses.replace(d["spec"], deg=deg)
    axes = spec.axes
    wb, wb_j = basis(deg, sum(a.C - a.nd for a in axes), 0, seed=10 + deg)
    pk16 = jax_pack16(d["pack"], d["rays"])
    t, tr = torch.from_numpy(d["pack"]), torch.from_numpy(d["rays"])
    pr = d["prep"]

    # K5 on the quad rows
    want = _jax_multi(d, spec, wb_j, pk16, [
        quad_rows(q, pk16, a.m0, a.m1, a.W, a.H)
        for a, q in zip(axes, d["jtables"])])
    for fn in (shade_multi, shade_multi_folded_plain):
        close(fn(pr["quads"], pr["lines"], t, tr, wb, spec), want)

    # K5 on K4's pre-blended features
    feats = patch_blend(pr["ptabs"], t, d["pspecs"])[0]
    want = _jax_multi(d, spec, wb_j, pk16, [
        jnp.asarray(phase_major_rows(f.float().numpy())).astype(jnp.bfloat16)
        for f in feats], preblended="phase_major", patch_block=R)
    for fn in (shade_multi_preblended, shade_multi_preblended_folded_plain):
        close(fn(feats, pr["lines"], t, tr, wb, spec), want)

    # K6
    rows, anchors = zip(*[patch_rows(p, pk16, a.m0, a.m1, a.W, a.H)
                          for a, p in zip(axes, d["jptabs"])])
    want = _jax_multi(d, spec, wb_j, pk16, list(rows),
                      preblended="fused_patch", anchors_list=list(anchors),
                      patch_pxy=PATCH, patch_block=R)
    for fn in (shade_multi_patch, shade_multi_patch_folded_plain):
        got, count = fn(pr["ptabs"], pr["lines"], t, tr, wb, spec,
                        d["pspecs"])
        assert int(count) > 0
        close(got, want)
