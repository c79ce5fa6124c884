"""Patch blend (K4): the features of every plane of the coherent
patch-gather route (ops/patch_gather.py) in one launch per chunk, one bf16
row of C channels per sample and plane, for the pre-blended shade kernels
(ops/kernels/shade.py `shade_preblended`, the flagship's space plane;
ops/kernels/shade_multi.py `shade_multi_preblended`, the multi-axis nets'
three planes). Each plane's coordinates are pack rows (m0, m1) of its
PatchSpec: (0, 1) for the flagship's space plane, MAT_MODE of the
multi-axis net's axis otherwise.

Replaces hyperreel_tpu/ops/pallas/patch_blend.py:_patch_blend_kernel (one
call per plane on the JAX route) with patch_anchor_idx, the XLA patch-row
gathers before it and the OR of the planes' coverage flags. CUDA source:
csrc/patch_blend.cu (the warp prologue and the blend in
csrc/patch_core.cuh). Bound on the H100 by device-memory bytes: per
sample four pack rows read once for every plane, each plane's 2*C-byte
feature row written, and each slot's patch rows. See the sources for the
design.

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
the pack's order ([B*S, C] per plane) rather than the TPU's phase-major
tiles.

Both kernels of the route also count the coverage violations: the slots
whose valid samples' bilinear footprint exits the patch on some axis of
some plane, floor(max) - floor(min) > p - 2 (models/fused_eval.py
`patch_coverage_viol` is that count over the J*S slots).
"""

from dataclasses import dataclass

import torch

from hyperreel_tpu_torch.ops.kernels import build
from hyperreel_tpu_torch.ops.kernels.layout import check_pack
from hyperreel_tpu_torch.ops.patch_gather import hat_weights, unnormalize

KERNEL_BLOCKS = (4, 8)          # R, as the JAX package takes it
# one plane of 8 or 16 channels, or the multi-axis nets' three
# (csrc/multi_core.cuh PatchLayout) on pack rows (0, 1), (0, 2), (1, 2)
KERNEL_PLANES = ((8,), (16,), (16, 8, 8))
PLANE_ROWS = ((0, 1), (0, 2), (1, 2))
MIN_S, MAX_S = 4, 64            # a lane reads 4 samples of each pack row


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


def coverage_count(pack, specs):
    """int32 [1]: the slots that violate on any of the planes of `specs`
    (their `coverage_flags` ORed)."""
    flags = coverage_flags(pack, specs[0])
    for ps in specs[1:]:
        flags = flags | coverage_flags(pack, ps)
    return flags.sum().reshape(1).to(torch.int32)


def patch_offsets(pack, spec):
    """Per sample on one plane: its offsets u, v [B*S] inside its slot's
    patch and its patch-table row [B*S]."""
    x0, y0, idx = patch_anchors(pack, spec)
    u = unnormalize(pack[spec.m0], spec.W) - _per_sample(x0, spec)
    v = unnormalize(pack[spec.m1], spec.H) - _per_sample(y0, spec)
    return u, v, _per_sample(idx, spec)


def patch_features_plain(ptab, pack, spec):
    """The f32 [B*S, C] features of every sample on one plane: the full
    px*py hat sum, in the JAX kernels' order."""
    C = spec.C
    u, v, rows = patch_offsets(pack, spec)
    wx, wy = hat_weights(u, spec.px), hat_weights(v, spec.py)
    feat = torch.zeros(pack.shape[1], C, device=pack.device)
    for ty in range(spec.py):
        for tx in range(spec.px):
            t = ty * spec.px + tx
            tex = ptab[:, t * C:(t + 1) * C][rows].float()
            feat = feat + (wx[tx] * wy[ty])[:, None] * tex
    return feat


def patch_taps_plain(ptab, pack, spec):
    """The f32 [B*S, C] features of every sample on one plane as K6 takes
    them (csrc/patch_core.cuh patch_taps): the four taps around (u, v),
    their indices clamped into the patch and the weight of a tap outside
    it 0, summed in the order (dy, dx); the same non-zero terms in the same
    order as `patch_features_plain`'s full sum."""
    u, v, rows = patch_offsets(pack, spec)
    texels = ptab.reshape(ptab.shape[0], spec.px * spec.py, spec.C)

    def tap(c, size, d):
        t = torch.floor(c) + d
        inside = (t >= 0.0) & (t <= size - 1.0)
        return (torch.where(inside, torch.clamp_min(1.0 - (c - t).abs(), 0.0),
                            0.0), torch.where(inside, t, 0.0).long())
    wx, ix = zip(*(tap(u, spec.px, d) for d in (0, 1)))
    wy, iy = zip(*(tap(v, spec.py, d) for d in (0, 1)))
    feat = torch.zeros(pack.shape[1], spec.C, device=pack.device)
    for dy in (0, 1):
        for dx in (0, 1):
            tex = texels[rows, iy[dy] * spec.px + ix[dx]].float()
            feat = feat + tex * (wx[dx] * wy[dy])[:, None]
    return feat


def patch_blend_plain(ptabs, pack, specs):
    """Plain PyTorch version of the kernel (same inputs and outputs)."""
    return ([patch_features_plain(t, pack, s).to(torch.bfloat16)
             for t, s in zip(ptabs, specs)],
            coverage_count(pack, specs))


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


def check_planes(ptabs, pack, specs):
    """Raise unless each plane's table fits its spec and the specs share
    one sample count, block shape and ray order; returns B."""
    if len(ptabs) != len(specs) or not specs:
        raise ValueError(f"{len(ptabs)} patch tables for {len(specs)} "
                         "PatchSpecs")
    if len({(s.S, s.R, s.px, s.py, s.phase_major) for s in specs}) != 1:
        raise ValueError("the planes' PatchSpecs differ in S, R, px, py or "
                         "the ray order")
    B = check_pack(pack, specs[0].S)
    for t, s in zip(ptabs, specs):
        check_patch(t, pack, s)
    return B


def check_patch_kernel(ptabs, specs, name):
    """Raise unless the patch kernels are built for `specs` (one plane for
    K3, whose shade check also holds it to S <= 32; one or the three
    planes of KERNEL_PLANES for K4)."""
    s = specs[0]
    chans = tuple(p.C for p in specs)
    rows = tuple((p.m0, p.m1) for p in specs)
    if s.R not in KERNEL_BLOCKS or chans not in KERNEL_PLANES \
            or (len(specs) == 3 and rows != PLANE_ROWS) \
            or not MIN_S <= s.S <= MAX_S or s.S & (s.S - 1):
        raise NotImplementedError(
            f"{name} kernel: R={s.R}, planes of C={chans} on pack rows "
            f"{rows}, S={s.S} not built (R in {KERNEL_BLOCKS}, planes "
            f"{KERNEL_PLANES}, three on {PLANE_ROWS}, S a power of two in "
            f"{MIN_S} .. {MAX_S})")
    if any(t.data_ptr() % 16 for t in ptabs):
        raise ValueError(f"{name}: the patch tables must be 16-byte aligned")


def patch_params(B, spec):
    q = build.PatchParams()
    q.B, q.S, q.W, q.H, q.C, q.R = B, spec.S, spec.W, spec.H, spec.C, spec.R
    q.px, q.py, q.phase_major = spec.px, spec.py, int(spec.phase_major)
    q.m0, q.m1 = spec.m0, spec.m1
    return q


def blend_params(B, ptabs, feats, specs):
    s = specs[0]
    q = build.BlendParams()
    q.B, q.S, q.R, q.px, q.py = B, s.S, s.R, s.px, s.py
    q.phase_major, q.na = int(s.phase_major), len(specs)
    for pl, t, f, ps in zip(q.plane, ptabs, feats, specs):
        pl.ptab, pl.feats = t.data_ptr(), f.data_ptr()
        pl.W, pl.H, pl.C, pl.m0, pl.m1 = ps.W, ps.H, ps.C, ps.m0, ps.m1
    return q


def patch_blend(ptabs, pack, specs):
    """Run K4 over the planes of `specs` (one PatchSpec per patch table in
    `ptabs`): returns (one bf16 [B*S, C] feature tensor per plane in the
    pack's order, the slots that violate on any plane, int32 [1]). A CPU
    pack goes to `patch_blend_plain`; a CUDA pack launches the kernel
    once, or raises. Counts launches in `patch_blend.launches`."""
    B = check_planes(ptabs, pack, specs)
    if pack.device.type == "cpu":
        return patch_blend_plain(ptabs, pack, specs)
    if pack.device.type != "cuda":
        raise ValueError(f"patch_blend has no kernel for {pack.device}")
    check_patch_kernel(ptabs, specs, "patch_blend")
    if pack.shape[1] >= 2 ** 31:
        raise NotImplementedError("patch_blend kernel: the chunk's samples "
                                  "are indexed in 32 bits")
    feats = [torch.empty((pack.shape[1], s.C), dtype=torch.bfloat16,
                         device=pack.device) for s in specs]
    viol = torch.zeros(1, dtype=torch.int32, device=pack.device)
    lib = build.load_library().lib
    with torch.cuda.device(pack.device):
        stream = torch.cuda.current_stream().cuda_stream
        build.check_launch(lib.patch_blend_launch(
            pack.data_ptr(), viol.data_ptr(),
            blend_params(B, ptabs, feats, specs), stream), "patch_blend")
    patch_blend.launches += 1
    return feats, viol


patch_blend.launches = 0
