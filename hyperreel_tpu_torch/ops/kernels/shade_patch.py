"""Fused patch-blend + shade (K3): the coherent patch-gather route of the
flagship eval render in one kernel, from the per-sample pack and the
patch table to the per-ray colour; the space features never reach device
memory.

Replaces hyperreel_tpu/ops/pallas/shade.py:_shade_kernel_fused_patch
(the bench's default route, R = 8 with a (5, 2) patch) with the XLA
patch-row gather and patch_anchor_idx before it. CUDA source:
csrc/shade_patch.cuh (the warp prologue and the blend in
csrc/patch_core.cuh, the shading and the running composite in
csrc/shade_core.cuh). A thread per ray over its samples, the SH basis
folded with the ray's view direction once per ray; bound on the H100 by
device-memory bytes with that fold. See the sources for the design.

The features are K4's (ops/kernels/patch_blend.py, same grouping, anchors
and hat blend) kept in f32; everything after them is K2's math
(ops/kernels/shade.py `shade_features_plain`), up to the order of the
sums of the folded colour (`shade_patch_folded_plain`). Also returns the
coverage violation count, as K4 does.
"""

import torch

from hyperreel_tpu_torch.ops.kernels import build
from hyperreel_tpu_torch.ops.kernels.layout import check_ray_pack
from hyperreel_tpu_torch.ops.kernels.patch_blend import (
    check_patch, check_patch_kernel, coverage_count, patch_features_plain,
    patch_params)
from hyperreel_tpu_torch.ops.kernels.shade import (
    check_kernel, check_tables, shade_features_plain, shade_params)


def shade_patch_plain(ptab, pack, ray_pack, ttab, wb, spec, pspec):
    """Plain PyTorch version of the kernel (same inputs and outputs)."""
    feat = patch_features_plain(ptab, pack, pspec)
    return (shade_features_plain(feat, pack, ray_pack, ttab, wb, spec),
            coverage_count(pack, [pspec]))


def shade_patch_folded_plain(ptab, pack, ray_pack, ttab, wb, spec, pspec):
    """`shade_patch_plain` with the SH colour taken from the basis folded
    with each ray's view direction (shade.py `fold_sh_basis`), as the
    kernel takes it: the same function up to the order of the sums. RGB
    colour has nothing to fold."""
    feat = patch_features_plain(ptab, pack, pspec)
    return (shade_features_plain(feat, pack, ray_pack, ttab, wb, spec, True),
            coverage_count(pack, [pspec]))


def shade_patch(ptab, pack, ray_pack, ttab, wb, spec, pspec):
    """Run K3: returns (f32 [B, 5] = r, g, b, acc, depth per ray in the
    pack's order, coverage violations int32 [1]). `spec` is the
    ShadeSpec, `pspec` the PatchSpec. A CPU pack goes to
    `shade_patch_plain`; a CUDA pack launches the kernel or raises. Counts
    launches in `shade_patch.launches`."""
    B = check_patch(ptab, pack, pspec)
    check_ray_pack(ray_pack, B)
    check_tables(ttab, wb, spec, pack.device)
    if ray_pack.device != pack.device:
        raise ValueError("ray_pack and pack lie on different devices")
    if (spec.S, spec.W, spec.H, spec.C) != (pspec.S, pspec.W, pspec.H,
                                            pspec.C):
        raise ValueError(f"ShadeSpec {spec} and PatchSpec {pspec} differ")
    if pack.device.type == "cpu":
        return shade_patch_plain(ptab, pack, ray_pack, ttab, wb, spec, pspec)
    if pack.device.type != "cuda":
        raise ValueError(f"shade_patch has no kernel for {pack.device}")
    check_kernel(spec, "shade_patch", weights=False)
    check_patch_kernel([ptab], [pspec], "shade_patch")
    if spec.shading != "rgb" and 2 * spec.nd != spec.C:
        raise NotImplementedError(
            f"shade_patch kernel: SH colour with {spec.nd} of {spec.C} "
            "channels for density not built (C / 2, every preset's)")
    if ttab.data_ptr() % 16:
        raise ValueError("shade_patch: ttab must be 16-byte aligned")
    out = torch.empty((B, 5), dtype=torch.float32, device=pack.device)
    viol = torch.zeros(1, dtype=torch.int32, device=pack.device)
    lib = build.load_library().lib
    with torch.cuda.device(pack.device):
        stream = torch.cuda.current_stream().cuda_stream
        build.check_launch(lib.shade_patch_launch(
            ptab.data_ptr(), pack.data_ptr(), ray_pack.data_ptr(),
            ttab.data_ptr(), out.data_ptr(), viol.data_ptr(),
            shade_params(B, spec, wb), patch_params(B, pspec), stream),
            "shade_patch")
    shade_patch.launches += 1
    return out, viol


shade_patch.launches = 0
