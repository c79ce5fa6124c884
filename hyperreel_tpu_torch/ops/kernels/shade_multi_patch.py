"""Fused multi-axis patch-blend + shade (K6): the coherent patch-gather
route of the VM nets' eval render (the static llff_z_plane family, and the
dynamic neural_3d_z_plane family with its time planes) in one kernel,
from the per-sample pack and the three planes' patch tables to the per-ray
colour; the plane features never reach device memory.

Replaces hyperreel_tpu/ops/pallas/shade.py:_shade_kernel_multi_fused_patch
(the JAX route with HYPERREEL_FUSED_PATCH_MULTI=1) with the XLA patch-row
gathers and patch_anchor_idx before it. CUDA source:
csrc/shade_multi_patch.cu (the anchors, witness and blend in
csrc/patch_core.cuh, the ray run and K5's per-sample body in
csrc/multi_core.cuh). A thread per ray over its samples, each plane's
anchor and witness by warp shuffles over the R rays of a coherent block,
the taps read through L1, the SH basis folded once per ray, a running
composite; bound on the H100 by its f32 operations. See the sources for
the design.

The plane features are K4's (ops/kernels/patch_blend.py: the same
grouping, anchors and hat blend, per plane with its PatchSpec) kept in
f32; everything after them is K5's math, time planes included
(ops/kernels/shade_multi.py `shade_multi_features_plain`, one basis
product over the concatenated
appearance channels where the JAX kernel adds one per axis: the same sum in
another f32 order). `shade_multi_patch_folded_plain` is the kernel's op
order: four clamped taps per plane, the folded basis, a running
composite. Also returns the coverage violation count: the slots whose
footprint exits the patch on any plane.
"""

import torch

from hyperreel_tpu_torch.ops.kernels import build
from hyperreel_tpu_torch.ops.kernels.layout import check_ray_pack
from hyperreel_tpu_torch.ops.kernels.patch_blend import (
    check_patch, coverage_count, patch_features_plain, patch_params,
    patch_taps_plain)
from hyperreel_tpu_torch.ops.kernels.shade_multi import (
    check_kernel, check_lines, multi_params, shade_multi_features_plain)


def shade_multi_patch_plain(ptabs, lines, pack, ray_pack, wb, spec, pspecs):
    """Plain PyTorch version of the kernel (same inputs and outputs)."""
    feats = [patch_features_plain(t, pack, ps)
             for t, ps in zip(ptabs, pspecs)]
    return (shade_multi_features_plain(feats, lines, pack, ray_pack, wb,
                                       spec),
            coverage_count(pack, pspecs))


def shade_multi_patch_folded_plain(ptabs, lines, pack, ray_pack, wb, spec,
                                   pspecs):
    """`shade_multi_patch_plain` as the kernel computes it: each plane's
    four clamped taps (`patch_taps_plain`), the SH colour from the basis
    folded with each ray's view direction (shade.py `fold_sh_basis`) and
    the composite a running sum per ray (`composite_running_plain`); the
    same function up to the order of the sums."""
    feats = [patch_taps_plain(t, pack, ps) for t, ps in zip(ptabs, pspecs)]
    return (shade_multi_features_plain(feats, lines, pack, ray_pack, wb,
                                       spec, True, True),
            coverage_count(pack, pspecs))


def check_specs(spec, pspecs):
    """Raise unless the per-plane PatchSpecs match the MultiSpec's axes
    and share one block shape."""
    if len(pspecs) != len(spec.axes):
        raise ValueError(f"{len(pspecs)} PatchSpecs for {len(spec.axes)} "
                         "axes")
    for ax, ps in zip(spec.axes, pspecs):
        if (ps.W, ps.H, ps.C, ps.S, ps.m0, ps.m1) != (ax.W, ax.H, ax.C,
                                                      spec.S, ax.m0, ax.m1):
            raise ValueError(f"PatchSpec {ps} does not match axis {ax}")
    if len({(ps.R, ps.px, ps.py, ps.phase_major) for ps in pspecs}) != 1:
        raise ValueError("the planes' PatchSpecs differ in R, px, py or the "
                         "ray order")


def shade_multi_patch(ptabs, lines, pack, ray_pack, wb, spec, pspecs):
    """Run K6: returns (f32 [B, 5] = r, g, b, acc, depth per ray in the
    pack's order, coverage violations int32 [1]). `spec` is the MultiSpec,
    `pspecs` one PatchSpec per plane. A CPU pack goes to
    `shade_multi_patch_plain`; a CUDA pack launches the kernel or raises.
    Counts launches in `shade_multi_patch.launches`."""
    check_specs(spec, pspecs)
    B = check_patch(ptabs[0], pack, pspecs[0])
    for t, ps in zip(ptabs[1:], pspecs[1:]):
        check_patch(t, pack, ps)
    check_ray_pack(ray_pack, B)
    check_lines(lines, wb, spec, pack.device)
    if ray_pack.device != pack.device:
        raise ValueError("ray_pack and pack lie on different devices")
    if pack.device.type == "cpu":
        return shade_multi_patch_plain(ptabs, lines, pack, ray_pack, wb,
                                       spec, pspecs)
    if pack.device.type != "cuda":
        raise ValueError(f"shade_multi_patch has no kernel for {pack.device}")
    check_kernel(spec, "shade_multi_patch", weights=False)
    if pspecs[0].R not in (4, 8):
        raise NotImplementedError(f"shade_multi_patch kernel: R="
                                  f"{pspecs[0].R} not built (R in 4, 8)")
    if any(t.data_ptr() % 16 for t in list(ptabs) + list(lines)):
        raise ValueError("shade_multi_patch: tables must be 16-byte aligned")
    out = torch.empty((B, 5), dtype=torch.float32, device=pack.device)
    viol = torch.zeros(1, dtype=torch.int32, device=pack.device)
    lib = build.load_library().lib
    with torch.cuda.device(pack.device):
        stream = torch.cuda.current_stream().cuda_stream
        build.check_launch(lib.shade_multi_patch_launch(
            pack.data_ptr(), ray_pack.data_ptr(), out.data_ptr(),
            viol.data_ptr(), multi_params(B, spec, ptabs, lines, wb),
            patch_params(B, pspecs[0]), stream), "shade_multi_patch")
    shade_multi_patch.launches += 1
    return out, viol


shade_multi_patch.launches = 0
