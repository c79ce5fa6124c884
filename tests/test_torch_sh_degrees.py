"""SH of degree 0, 1, 3 and 4 in the single-axis shade kernels' plain
versions (K2 on quad rows, K2 on pre-blended features, K3), against the
JAX package's Pallas kernel on the CPU.

The JAX net takes its SH degree from data_dim_color (3, 12, 27, 48, 75 ->
degree 0-4) and launches its shade kernels with n_basis = (deg + 1)^2 on
every fused route. Per degree a random basis [3 (deg + 1)^2, C], zero on
the density columns, goes to each port plain version (folded and
unfolded) and to the Pallas kernel in interpret mode with f32
accumulation, on tiny_dynamic's tables and a coherent pack of 128 rays at
S = 8 (tests/torch_sh_parity.py): rgb/acc within 1e-5, depth 5e-5 (only
f32 summation order differs). The multi-axis kernels are in
test_torch_sh_multi.py, the nets' routes in test_torch_sh_routes.py.
"""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from hyperreel_tpu.ops.pallas.shade import fused_shade_composite
from hyperreel_tpu_torch.ops.kernels import shade as SH
from hyperreel_tpu_torch.ops.kernels.patch_blend import patch_blend
from hyperreel_tpu_torch.ops.kernels.shade_patch import (
    shade_patch, shade_patch_folded_plain)

from torch_parity import jax_pack
from torch_sh_parity import (
    DEGREES, PATCH, R, S, TILE, basis, close, patch_rows, phase_major_rows,
    quad_rows, single_tables)

torch.set_num_threads(1)


@pytest.mark.parametrize("deg", DEGREES)
def test_single_axis_kernels_at_degree(deg):
    d = single_tables()
    spec = dataclasses.replace(d["spec"], deg=deg)
    C, nd = spec.C, spec.nd
    wb, wb_j = basis(deg, C - nd, nd, seed=deg)
    pack, rays = torch.from_numpy(d["pack"]), torch.from_numpy(d["rays"])
    pk16 = jax_pack(d["pack"], d["rays"], S, TILE)
    kw = dict(S=S, W=spec.W, H=spec.H, TW=spec.TW, TH=0, n_density=nd,
              n_basis=(deg + 1) ** 2, density_shift=0.0,
              distance_scale=spec.distance_scale, tile=TILE, s_major=True,
              acc_dtype=jnp.float32)
    ttab_j = jnp.asarray(d["ttab_j"])

    # K2 on the quad rows of the pack's samples
    want = np.asarray(fused_shade_composite(
        quad_rows(d["qt"], pk16, 0, 1, spec.W, spec.H), jnp.asarray(pk16),
        ttab_j, wb_j, **kw))[:5].T
    qt = d["prep"]["quad"]
    for fn in (SH.shade, SH.shade_folded_plain):
        close(fn(qt, pack, rays, d["ttab"], wb, spec), want)

    # K2 on K4's pre-blended features
    (feats,), _ = patch_blend([d["prep"]["patch"]], pack, [d["pspec"]])
    want = np.asarray(fused_shade_composite(
        jnp.asarray(phase_major_rows(feats.float().numpy())).astype(
            jnp.bfloat16), jnp.asarray(pk16), ttab_j, wb_j,
        preblended="phase_major", patch_block=R, **kw))[:5].T
    for fn in (SH.shade_preblended, SH.shade_preblended_folded_plain):
        close(fn(feats, pack, rays, d["ttab"], wb, spec), want)

    # K3
    prow, anchors = patch_rows(d["ptab_j"], pk16, 0, 1, spec.W, spec.H)
    want = np.asarray(fused_shade_composite(
        prow, jnp.asarray(pk16), ttab_j, wb_j, preblended="fused_patch",
        anchors=anchors, patch_pxy=PATCH, m0=0, m1=1, patch_block=R,
        **kw))[:5].T
    for fn in (shade_patch, shade_patch_folded_plain):
        got, count = fn(d["prep"]["patch"], pack, rays, d["ttab"], wb, spec,
                        d["pspec"])
        assert int(count) > 0
        close(got, want)


def test_single_axis_check_takes_every_degree():
    """The single-axis kernels' check takes SH of degree 0-4 and RGB and
    refuses degree 5 before any launch (the multi-axis check reads the
    built library's layouts, on the card: tests/test_torch_cuda.py)."""
    base = SH.ShadeSpec(S=8, W=5, H=5, TW=5, TH=0, C=16, nd=8, deg=2,
                        distance_scale=1.0)
    for deg in range(5):
        SH.check_kernel(dataclasses.replace(base, deg=deg), "shade")
    SH.check_kernel(dataclasses.replace(base, shading="rgb"), "shade")
    with pytest.raises(NotImplementedError, match="long tail"):
        SH.check_kernel(dataclasses.replace(base, deg=5), "shade")
