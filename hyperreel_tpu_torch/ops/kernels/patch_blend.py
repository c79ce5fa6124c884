"""Patch blend (K4): the features of one plane of the coherent patch-gather
route (ops/patch_gather.py), one bf16 row of C channels per sample, for the
pre-blended shade kernels (ops/kernels/shade.py `shade_preblended`, the
flagship's space plane; ops/kernels/shade_multi.py
`shade_multi_preblended`, each of the multi-axis nets' three planes). The
plane's coordinates are pack rows (m0, m1) of its PatchSpec: (0, 1) for
the flagship's space plane, MAT_MODE of the multi-axis net's axis
otherwise.

Replaces hyperreel_tpu/ops/pallas/patch_blend.py:_patch_blend_kernel with
patch_anchor_idx and the XLA patch-row gather before it. CUDA source:
csrc/patch_blend.cu (the anchors, the shared-memory patch rows and the
blend in csrc/patch_core.cuh). Bound on the H100 by device-memory bytes:
per sample four pack rows read, px*py*C*2 / R bytes of patch row, and a
2*C-byte feature row written. See the sources for the design.

The grouping is the JAX package's: coherent block j is the caller's rays
R*j .. R*j + R-1; ray p of block j sits at position R*j + p of the chunk,
or at p*(B/R) + j when the caller delivers the rays phase-major
(`PatchSpec.phase_major`, the `rays_phase_major` render contract). Per
slot (j, s) the anchor is clip(floor(min over the R rays of the
unnormalised coordinate), -1, W-1 / H-1), every sample counted; per
sample u = (x+1)*0.5*(W-1) - x0 (v likewise), and the feature is
sum over ty < py, tx < px of max(0,1-|u-tx|)*max(0,1-|v-ty|)*patch[t].
The features are rounded to bf16 where the JAX route rounds them
(models/fused_eval.py `out_dtype=jnp.bfloat16`), and stored ray-major in
the pack's order ([B*S, C]) rather than the TPU's phase-major tiles.

Both kernels of the route also count the coverage violations: the slots
whose valid samples' bilinear footprint exits the patch on some axis,
floor(max) - floor(min) > p - 2 (models/fused_eval.py
`patch_coverage_viol` is that count over the J*S slots).
"""

from dataclasses import dataclass

import torch

from hyperreel_tpu_torch.ops.kernels import build
from hyperreel_tpu_torch.ops.kernels.layout import check_pack
from hyperreel_tpu_torch.ops.patch_gather import hat_weights, unnormalize

KERNEL_BLOCKS = (4, 8)          # R, as the JAX package takes it
KERNEL_CHANNELS = (8, 16)
MAX_S = 64                      # a warp lane per sample, two at S = 64


@dataclass(frozen=True)
class PatchSpec:
    R: int                      # rays per coherent block
    px: int
    py: int
    W: int
    H: int
    C: int
    S: int
    phase_major: bool = False
    m0: int = 0                 # pack rows of the plane's coordinates
    m1: int = 1


def grouped(row, spec):
    """A per-sample row [B*S] in the pack's order -> [R, J, S]: sample s
    of ray p of coherent block j at [p, j, s] (a view)."""
    x = row.reshape(-1, spec.S)
    J = x.shape[0] // spec.R
    if spec.phase_major:
        return x.reshape(spec.R, J, spec.S)
    return x.reshape(J, spec.R, spec.S).transpose(0, 1)


def ungrouped(x, spec):
    """[R, J, S] -> the per-sample row [B*S] in the pack's order."""
    if spec.phase_major:
        return x.reshape(-1)
    return x.transpose(0, 1).reshape(-1)


def patch_anchors(pack, spec):
    """Per slot (j, s): the anchors x0, y0 f32 [J, S] and the patch-table
    row (y0+1)*(W+1) + (x0+1) int64 [J, S] (patch_anchor_idx)."""
    x0 = torch.clamp(torch.floor(unnormalize(
        grouped(pack[spec.m0], spec).amin(0), spec.W)), -1, spec.W - 1)
    y0 = torch.clamp(torch.floor(unnormalize(
        grouped(pack[spec.m1], spec).amin(0), spec.H)), -1, spec.H - 1)
    idx = ((y0 + 1) * (spec.W + 1) + (x0 + 1)).long()
    return x0, y0, idx


def _per_sample(slot_vals, spec):
    """[J, S] per-slot values -> [B*S] for every sample of the slot."""
    return ungrouped(slot_vals[None].expand(spec.R, -1, -1), spec)


def coverage_flags(pack, spec):
    """bool [J, S]: the slots whose valid samples' footprint exits the
    patch on either of the plane's coordinates."""
    ok = grouped((pack[0].abs() <= 1.0) & (pack[1].abs() <= 1.0)
                 & (pack[2].abs() <= 1.0) & (pack[3] > 0.0), spec)
    viol = torch.zeros(ok.shape[1:], dtype=torch.bool, device=pack.device)
    for row, size, budget in ((pack[spec.m0], spec.W, spec.px),
                              (pack[spec.m1], spec.H, spec.py)):
        f = grouped(torch.floor(unnormalize(row, size)), spec)
        lo = torch.where(ok, f, float("inf")).amin(0)
        hi = torch.where(ok, f, float("-inf")).amax(0)
        viol |= hi - lo > budget - 2
    return viol


def coverage_count(pack, spec):
    """int32 [1]: the number of `coverage_flags`."""
    return coverage_flags(pack, spec).sum().reshape(1).to(torch.int32)


def patch_features_plain(ptab, pack, spec):
    """The f32 [B*S, C] features of every sample: the full px*py hat sum,
    in the JAX kernels' order."""
    C = spec.C
    x0, y0, idx = patch_anchors(pack, spec)
    u = unnormalize(pack[spec.m0], spec.W) - _per_sample(x0, spec)
    v = unnormalize(pack[spec.m1], spec.H) - _per_sample(y0, spec)
    rows = _per_sample(idx, spec)
    wx, wy = hat_weights(u, spec.px), hat_weights(v, spec.py)
    feat = torch.zeros(pack.shape[1], C, device=pack.device)
    for ty in range(spec.py):
        for tx in range(spec.px):
            t = ty * spec.px + tx
            tex = ptab[:, t * C:(t + 1) * C][rows].float()
            feat = feat + (wx[tx] * wy[ty])[:, None] * tex
    return feat


def patch_blend_plain(ptab, pack, spec, flags=None):
    """Plain PyTorch version of the kernel (same inputs and outputs)."""
    viol = coverage_flags(pack, spec)
    if flags is not None:
        flags |= viol.reshape(-1).to(flags.dtype)
    return (patch_features_plain(ptab, pack, spec).to(torch.bfloat16),
            viol.sum().reshape(1).to(torch.int32))


def check_patch(ptab, pack, spec):
    """Raise unless the patch table and the pack fit `spec`; returns B."""
    shape = ((spec.H + 1) * (spec.W + 1), spec.px * spec.py * spec.C)
    if ptab.dtype != torch.bfloat16 or tuple(ptab.shape) != shape \
            or not ptab.is_contiguous():
        raise ValueError(f"ptab must be contiguous bf16 {shape}, got "
                         f"{ptab.dtype} {tuple(ptab.shape)}")
    if ptab.device != pack.device:
        raise ValueError("ptab and pack lie on different devices")
    B = check_pack(pack, spec.S)
    if B % spec.R:
        raise ValueError(f"{B} rays are not whole blocks of R={spec.R}")
    if not (0 <= spec.m0 <= 2 and 0 <= spec.m1 <= 2):
        raise ValueError(f"plane coordinates ({spec.m0}, {spec.m1}) are "
                         "not point rows of the pack")
    return B


def check_flags(flags, B, spec, device):
    """Raise unless `flags` is a contiguous uint8 [J*S] buffer on
    `device`."""
    n = B // spec.R * spec.S
    if flags.dtype != torch.uint8 or tuple(flags.shape) != (n,) \
            or not flags.is_contiguous() or flags.device != device:
        raise ValueError(f"flags must be a contiguous uint8 ({n},) buffer "
                         f"on {device}, got {flags.dtype} "
                         f"{tuple(flags.shape)} on {flags.device}")


def check_patch_kernel(ptab, spec, name):
    """Raise unless the patch kernels are built for `spec` (K3's shade
    check also holds it to S <= 32; the launchers refuse patch rows too
    wide for shared memory)."""
    S = spec.S
    if spec.R not in KERNEL_BLOCKS or spec.C not in KERNEL_CHANNELS \
            or S > MAX_S or S & (S - 1):
        raise NotImplementedError(
            f"{name} kernel: R={spec.R}, C={spec.C}, S={S} not built (R in "
            f"{KERNEL_BLOCKS}, C in {KERNEL_CHANNELS}, S a power of two "
            f"<= {MAX_S})")
    if ptab.data_ptr() % 16:
        raise ValueError(f"{name}: ptab must be 16-byte aligned")


def patch_params(B, spec):
    q = build.PatchParams()
    q.B, q.S, q.W, q.H, q.C, q.R = B, spec.S, spec.W, spec.H, spec.C, spec.R
    q.px, q.py, q.phase_major = spec.px, spec.py, int(spec.phase_major)
    q.m0, q.m1 = spec.m0, spec.m1
    return q


def patch_blend(ptab, pack, spec, flags=None):
    """Run K4: returns (features bf16 [B*S, C] in the pack's order,
    coverage violations int32 [1]); with `flags` (uint8 [J*S]) also sets
    the flag of each violating slot. A CPU pack goes to
    `patch_blend_plain`; a CUDA pack launches the kernel or raises. Counts
    launches in `patch_blend.launches`."""
    B = check_patch(ptab, pack, spec)
    if flags is not None:
        check_flags(flags, B, spec, pack.device)
    if pack.device.type == "cpu":
        return patch_blend_plain(ptab, pack, spec, flags)
    if pack.device.type != "cuda":
        raise ValueError(f"patch_blend has no kernel for {pack.device}")
    check_patch_kernel(ptab, spec, "patch_blend")
    feats = torch.empty((pack.shape[1], spec.C), dtype=torch.bfloat16,
                        device=pack.device)
    viol = torch.zeros(1, dtype=torch.int32, device=pack.device)
    lib = build.load_library().lib
    with torch.cuda.device(pack.device):
        stream = torch.cuda.current_stream().cuda_stream
        build.check_launch(lib.patch_blend_launch(
            ptab.data_ptr(), pack.data_ptr(), feats.data_ptr(),
            viol.data_ptr(), None if flags is None else flags.data_ptr(),
            patch_params(B, spec), stream), "patch_blend")
    patch_blend.launches += 1
    return feats, viol


patch_blend.launches = 0
