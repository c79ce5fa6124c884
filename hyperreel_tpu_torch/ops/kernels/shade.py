"""Shade + composite (K2): from the per-sample pack (ops/kernels/layout.py)
to the per-ray colour, for the dynamic single-axis net
(TensorVMKeyframeTime with one space plane and one time plane).

Replaces hyperreel_tpu/ops/pallas/shade.py:_shade_kernel on the quad
route (with _shade_core, _corner_weights, _twohot_matmul, _shade_tail and
_compact_rows) and the XLA quad-row gather before it. CUDA source:
csrc/shade.cu (the time taps, density, colour and running composite in
csrc/shade_core.cuh). A thread per ray walks its samples in order, the
pack staged per warp in shared memory 8 samples at a time, the SH basis
folded with the ray's view direction once per ray, the composite a
running sum in registers; bound on the H100 by device-memory bytes with
that fold: per valid sample one 8*C-byte quad row and the 40-byte pack
column. The thread computes its texel address itself (no gather kernel,
no index array) and samples outside the aabb load nothing. See the source
for the design. `shade_folded_plain` is the plain version with the fold,
the same function up to the order of the sums.

`shade_preblended` is the same kernel reading the space features that
the patch-blend kernel (ops/kernels/patch_blend.py) wrote, bf16 [B*S, C]
one row per sample, instead of the quad table (the two-kernel patch
route; shade.py `preblended="phase_major"`).

The view direction and the keyframe time coordinate tn are per ray: both
come from the ray pack f32 [B, 8] (o xyz, d xyz, dt, tn) that K1 read.

Per sample: validity (|xn|, |yn|, |zn| <= 1 and dist > 0); the space
features, bilinear from the 4 corners of one quad-table row; the time
features, linear in z and then in t on the time plane (or linear in z on
a table premixed for one t, or on the z line of a static net); prod =
space * time; density = relu(sum of the first nd channels, times the
sample's weight when the pack has the weights row) * valid; the colour,
SH max(sum_k (wb @ prod)_k Y_k + 0.5, 0) or RGB sigmoid(wb @ prod),
times (scale + 1) plus shift. Per ray: the
log-space composite (last delta 1e10, x = clip(sigma*delta*distance_scale,
+-70), exclusive log-transmittance floored at log 1e-10) and the sums
r, g, b, acc, depth.

Tables (built once per checkpoint by `quad_table`, `time_table`,
`basis_table`):
  quad  bf16 [(H+1)*(W+1), 4C]: the zero-ring-padded space plane, row
        y*(W+1) + x holding its corners (y,x), (y,x+1), (y+1,x), (y+1,x+1);
  ttab  f32 [TH, TW, C] (the time plane as is), or [TW, C] premixed when
        the caller passes TH = 0;
  wb    f32 [3*K, C] on the host (it rides in the kernel's parameters):
        basis rows c*K + k, zero on the nd density columns (K = (deg +
        1)^2 for SH of degree 0-4, 1 for RGB).

The static net's own fused route (models/tensorf.py TensorVMNoSample
apply_fused) runs K2 with RGB shading, the weights row, and its z line as
the premixed table.
"""

from dataclasses import dataclass

import torch

from hyperreel_tpu_torch.ops.kernels import build
from hyperreel_tpu_torch.ops.kernels.layout import (
    WEIGHTS_ROW, check_pack, check_ray_pack)
from hyperreel_tpu_torch.ops.render_math import EXP_CLAMP, LOG_EPS, raw2alpha
from hyperreel_tpu_torch.ops.sh import eval_sh_bases

# the channel counts and colours csrc/shade.cu is built for: those of the
# ported configurations (technicolor_z_plane and stanford_llff_z_plane C=16,
# tiny_dynamic C=8; SH of degree 0-4, as data_dim_color 3, 12, 27, 48, 75
# gives it, or RGB)
KERNEL_CHANNELS = (8, 16)
KERNEL_SH_DEGS = (0, 1, 2, 3, 4)
KERNEL_MAX_S = 32          # K2, K3


def shading_built(spec):
    """Whether the shade kernels are built for spec's colour: SH of a
    degree in KERNEL_SH_DEGS ((deg + 1)^2 basis rows per channel, the
    count a run-time value of the kernels, csrc/shade_core.cuh) or RGB
    (1)."""
    if spec.shading == "rgb":
        return True
    return spec.shading == "sh" and spec.deg in KERNEL_SH_DEGS


@dataclass(frozen=True)
class ShadeSpec:
    S: int
    W: int
    H: int
    TW: int
    TH: int          # 0: ttab is premixed [TW, C]
    C: int
    nd: int
    deg: int         # SH degree (unused by RGB)
    distance_scale: float
    shading: str = "sh"      # or "rgb"
    weights: bool = False    # the pack has the weights row

    @property
    def n_basis(self):
        return 1 if self.shading == "rgb" else (self.deg + 1) ** 2


def quad_table(plane_hwc):
    """[H, W, C] plane -> bf16 [(H+1)*(W+1), 4C] quad-corner table
    (hyperreel_tpu/models/fused_eval.py _plan_arrays quad_table)."""
    H, W, C = plane_hwc.shape
    p = torch.nn.functional.pad(plane_hwc.to(torch.bfloat16),
                                (0, 0, 1, 1, 1, 1))
    q = torch.cat([p[:-1, :-1], p[:-1, 1:], p[1:, :-1], p[1:, 1:]], -1)
    return q.reshape((H + 1) * (W + 1), 4 * C).contiguous()


def time_table(time_khc):
    """[TH, TW, C] time plane -> the f32 table the kernel reads."""
    return time_khc.float().contiguous()


def premix_time(ttab, tn0):
    """Mix the keyframe rows of [TH, TW, C] with the weights of one time
    coordinate tn0 (0-d tensor): the [TW, C] table for a frame whose rays
    all share that t (hyperreel_tpu/models/fused_eval.py _premix)."""
    TH = ttab.shape[0]
    pt = (tn0 + 1.0) * 0.5 * (TH - 1)
    p0 = torch.floor(pt)
    ft = pt - p0
    k = torch.arange(TH, device=ttab.device, dtype=torch.float32)
    t_lo = ((p0 >= 0.0) & (p0 <= TH - 1.0)).float()
    t_hi = ((p0 + 1.0 >= 0.0) & (p0 + 1.0 <= TH - 1.0)).float()
    mk = torch.where(k == p0, (1.0 - ft) * t_lo, 0.0) \
        + torch.where(k == p0 + 1.0, ft * t_hi, 0.0)
    return torch.tensordot(mk, ttab, dims=1).contiguous()


def basis_table(basis_weight, nd):
    """basis [3K, C - nd] (nn.Linear layout) -> f32 [3K, C] with zero
    density columns."""
    w = basis_weight.detach().float().cpu()
    return torch.cat([w.new_zeros(w.shape[0], nd), w], 1).contiguous()


def taps(coord, size):
    """Linear taps along one axis (align_corners=True, zero padding):
    (index of the low tap clamped to [-1, size-1], its weight, the high
    tap's weight), weights zero off-grid."""
    pc = (coord + 1.0) * 0.5 * (size - 1)
    p0 = torch.floor(pc)
    f = pc - p0
    w0 = torch.where((p0 >= 0.0) & (p0 <= size - 1.0), 1.0 - f, 0.0)
    w1 = torch.where((p0 + 1.0 >= 0.0) & (p0 + 1.0 <= size - 1.0), f, 0.0)
    return torch.clamp(p0, -1.0, size - 1.0).long(), w0, w1


def line_lookup(table_lc, i0, w0, w1):
    """sum of w0 * table[i0] + w1 * table[i0 + 1] over [L, C] rows."""
    L = table_lc.shape[0]
    lo = table_lc[torch.clamp(i0, 0, L - 1)]
    hi = table_lc[torch.clamp(i0 + 1, 0, L - 1)]
    return lo * w0[:, None] + hi * w1[:, None]


def quad_features(quad, x, y, W, H, C):
    """The plane features f32 [N, C] of every sample at normalised plane
    coordinates x, y [N]: bilinear from the 4 corners of its quad-table
    row."""
    xi, wx0, wx1 = taps(x, W)
    yi, wy0, wy1 = taps(y, H)
    rows = quad[(yi + 1) * (W + 1) + (xi + 1)].float()
    q = rows.reshape(-1, 4, C)
    return (q[:, 0] * (wy0 * wx0)[:, None] + q[:, 1] * (wy0 * wx1)[:, None]
            + q[:, 2] * (wy1 * wx0)[:, None]
            + q[:, 3] * (wy1 * wx1)[:, None])


def fold_sh_basis(wb, dirs, deg=2):
    """The SH basis [3K, A] (rows ch * K + k) folded with each ray's view
    direction dirs [B, 3]: f32 [B, 3, A], M[b, ch, a] = sum_k Y_k(dirs[b])
    wb[ch * K + k, a] (csrc/shade_core.cuh sh_fold). A sample's colour is
    then M @ app instead of the sum over k of Y_k (wb @ app)_k."""
    K = (deg + 1) ** 2
    Y = eval_sh_bases(deg, dirs.float())                   # [B, K]
    return torch.einsum("bk,cka->bca", Y, wb.to(dirs.device).float()
                        .reshape(3, K, -1))


def shade_tail_plain(dens, feat, wb, pack, ray_pack, spec, fold=False,
                     running=False):
    """The density feature [B*S] and the features [B*S, A] of every sample
    -> f32 [B, 5]: validity (|xn|, |yn|, |zn| <= 1 and dist > 0), relu
    density (of the feature times the weights row where spec.weights), the
    SH or RGB colour of wb [3K, A] @ feat with the colour scale and shift,
    and the per-ray composite (csrc/shade_core.cuh colour and
    composite_add). With `fold`, the SH colour is taken from the basis
    folded with each ray's view direction (`fold_sh_basis`), as the
    thread-per-ray kernels take it (shade_core.cuh sh_fold,
    sh_folded_colour): the same function up to the order of the sums; RGB
    colour has nothing to fold. With `running`, the composite is taken
    sample by sample per ray (`composite_running_plain`), in the kernels'
    order."""
    S = spec.S
    B = check_pack(pack, S, spec.weights)
    dist = pack[3]
    valid = sample_validity(pack)
    if spec.weights:
        dens = dens * pack[WEIGHTS_ROW]
    sigma = torch.clamp_min(dens, 0.0) * valid.float()
    if spec.shading == "rgb":
        v = 1.0 / (1.0 + torch.exp(-(feat @ wb.to(feat.device).t())))
    elif fold:
        M = fold_sh_basis(wb, ray_pack[:, 3:6], spec.deg)  # [B, 3, A]
        e = (M.repeat_interleave(S, 0) @ feat[..., None])[..., 0]
        v = torch.clamp_min(e + 0.5, 0.0)
    else:
        app = feat @ wb.to(feat.device).t()               # [N, 3K]
        K = spec.n_basis
        Y = eval_sh_bases(spec.deg, ray_pack[:, 3:6].repeat_interleave(
            S, 0))                                        # [N, K]
        e = (app.reshape(-1, 3, K) * Y[:, None, :]).sum(-1)
        v = torch.clamp_min(e + 0.5, 0.0)
    rgb = v * (pack[4:7].t() + 1.0) + pack[7:10].t()
    rgb = torch.where(valid[:, None], rgb, 0.0)
    return (composite_running_plain if running else composite_plain)(
        sigma, rgb, dist, B, spec)


def sample_validity(pack):
    """Samples inside the aabb (|xn|, |yn|, |zn| <= 1) with dist > 0."""
    return (pack[0].abs() <= 1.0) & (pack[1].abs() <= 1.0) \
        & (pack[2].abs() <= 1.0) & (pack[3] > 0.0)


def composite_plain(sigma, rgb, dist, B, spec):
    """Per-sample density [B*S], colour [B*S, 3] and dist [B*S] -> f32
    [B, 5]: the per-ray log-space composite (last delta 1e10) and the sums
    r, g, b, acc, depth (csrc/shade_core.cuh composite_add,
    composite_store)."""
    S = spec.S
    d = dist.reshape(B, S)
    delta = torch.cat([d[:, 1:] - d[:, :-1],
                       torch.full_like(d[:, :1], 1e10)], -1)
    _, w, _ = raw2alpha(sigma.reshape(B, S), delta * spec.distance_scale)
    rgb_map = (w[..., None] * rgb.reshape(B, S, 3)).sum(1)
    return torch.cat([rgb_map, w.sum(-1, keepdim=True),
                      (w * d).sum(-1, keepdim=True)], -1)


def composite_running_plain(sigma, rgb, dist, B, spec):
    """`composite_plain` as the thread-per-ray kernels take it: per ray a
    running sum over its samples in order (csrc/shade_core.cuh
    composite_add), the log-transmittance carried from sample to
    sample."""
    S = spec.S
    sg, d = sigma.reshape(B, S), dist.reshape(B, S)
    c = rgb.reshape(B, S, 3)
    log_t = torch.zeros(B, device=sigma.device)
    out = torch.zeros(B, 5, device=sigma.device)
    for s in range(S):
        delta = d[:, s + 1] - d[:, s] if s + 1 < S \
            else torch.full_like(d[:, s], 1e10)
        x = torch.clamp(sg[:, s] * (delta * spec.distance_scale),
                        -EXP_CLAMP, EXP_CLAMP)
        w = (1.0 - torch.exp(-x)) * torch.exp(log_t)
        log_t = log_t + torch.clamp_min(-x, LOG_EPS)
        out = out + torch.stack([w * c[:, s, 0], w * c[:, s, 1],
                                 w * c[:, s, 2], w, w * d[:, s]], -1)
    return out


def space_time_product(feat, pack, ray_pack, ttab, spec):
    """The space features f32 [B*S, C] times each sample's time features
    (csrc/shade_core.cuh sample_density)."""
    S, C = spec.S, spec.C
    check_pack(pack, S, spec.weights)
    zi, wz0, wz1 = taps(pack[2], spec.TW)
    if spec.TH == 0:
        ft = line_lookup(ttab, zi, wz0, wz1)
    else:
        tn = ray_pack[:, 7].repeat_interleave(S, 0)
        ti, wt0, wt1 = taps(tn, spec.TH)
        flat = ttab.reshape(spec.TH, spec.TW, C)
        ft = torch.zeros_like(feat)
        for dt, wt in ((0, wt0), (1, wt1)):
            k = torch.clamp(ti + dt, 0, spec.TH - 1)
            zf = (flat[k, torch.clamp(zi, 0, spec.TW - 1)] * wz0[:, None]
                  + flat[k, torch.clamp(zi + 1, 0, spec.TW - 1)]
                  * wz1[:, None])
            ft = ft + zf * wt[:, None]
    return feat * ft


def shade_features_plain(feat, pack, ray_pack, ttab, wb, spec,
                         fold=False):
    """Everything after the space features f32 [B*S, C]: the time
    features, their product with the space features, and
    `shade_tail_plain` (with the SH basis folded per ray where `fold`) ->
    f32 [B, 5] (csrc/shade_core.cuh sample_density, the colour)."""
    prod = space_time_product(feat, pack, ray_pack, ttab, spec)
    return shade_tail_plain(prod[:, :spec.nd].sum(-1), prod, wb, pack,
                            ray_pack, spec, fold)


def shade_plain(quad, pack, ray_pack, ttab, wb, spec):
    """Plain PyTorch version of the kernel (same inputs and output)."""
    feat = quad_features(quad, pack[0], pack[1], spec.W, spec.H, spec.C)
    return shade_features_plain(feat, pack, ray_pack, ttab, wb, spec)


def shade_folded_plain(quad, pack, ray_pack, ttab, wb, spec):
    """`shade_plain` with the SH colour taken from the basis folded with
    each ray's view direction, as the kernel takes it: the same function
    up to the order of the sums."""
    feat = quad_features(quad, pack[0], pack[1], spec.W, spec.H, spec.C)
    return shade_features_plain(feat, pack, ray_pack, ttab, wb, spec, True)


def shade_preblended_plain(feats, pack, ray_pack, ttab, wb, spec):
    """Plain PyTorch version of the pre-blended kernel."""
    return shade_features_plain(feats.float(), pack, ray_pack, ttab, wb,
                                spec)


def shade_preblended_folded_plain(feats, pack, ray_pack, ttab, wb, spec):
    """`shade_preblended_plain` with the SH basis folded per ray, as the
    kernel takes it."""
    return shade_features_plain(feats.float(), pack, ray_pack, ttab, wb,
                                spec, True)


def check_tables(ttab, wb, spec, device):
    """Raise unless the time table and the basis table fit `spec` (ttab
    contiguous f32 on `device`, wb on the host)."""
    C, K = spec.C, spec.n_basis
    tshape = (spec.TW, C) if spec.TH == 0 else (spec.TH, spec.TW, C)
    for name, t, shape in (("ttab", ttab, tshape), ("wb", wb, (3 * K, C))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous f32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if ttab.device != device:
        raise ValueError("ttab lies on another device than the pack")
    if wb.device.type != "cpu":
        raise ValueError("wb must lie on the host")


def check_kernel(spec, name, weights=True):
    """Raise unless the kernels are built for spec's C, colour and S (and,
    where `weights` is False, unless spec has no weights row)."""
    if spec.C not in KERNEL_CHANNELS or not shading_built(spec) \
            or spec.S > KERNEL_MAX_S or spec.S & (spec.S - 1):
        raise NotImplementedError(
            f"{name} kernel: C={spec.C}, {spec.shading} with "
            f"{spec.n_basis} basis rows, S={spec.S} not built (C in "
            f"{KERNEL_CHANNELS}, SH of degree {KERNEL_SH_DEGS} or RGB, S a "
            f"power of two <= {KERNEL_MAX_S}; ROADMAP.md: long tail)")
    if spec.weights and not weights:
        raise NotImplementedError(
            f"{name} kernel: the weights row is built into the quad "
            "kernels of K2 and K5 only (ROADMAP.md 2a: use_weights_row)")


def shade_params(B, spec, wb):
    """The kernels' ShadeParams for B rays (the basis rides in them)."""
    p = build.ShadeParams()
    p.B, p.S, p.W, p.H, p.TW, p.TH = B, spec.S, spec.W, spec.H, spec.TW, \
        spec.TH
    p.C, p.nd, p.nb = spec.C, spec.nd, spec.n_basis
    p.rgb, p.weights = int(spec.shading == "rgb"), int(spec.weights)
    p.distance_scale = float(spec.distance_scale)
    vals = wb.reshape(-1).tolist()
    p.wb[:len(vals)] = vals
    return p


def _check(space, space_shape, pack, ray_pack, ttab, wb, spec):
    if space.dtype != torch.bfloat16 or tuple(space.shape) != space_shape \
            or not space.is_contiguous():
        raise ValueError(f"space table must be contiguous bf16 "
                         f"{space_shape}, got {space.dtype} "
                         f"{tuple(space.shape)}")
    B = check_pack(pack, spec.S, spec.weights)
    check_ray_pack(ray_pack, B)
    check_tables(ttab, wb, spec, pack.device)
    if space.device != pack.device or ray_pack.device != pack.device:
        raise ValueError("the space table, ray_pack and pack lie on "
                         "different devices")
    return B


def _launch(name, fn, space, pack, ray_pack, ttab, wb, spec, B,
            weights=True):
    if pack.device.type != "cuda":
        raise ValueError(f"{name} has no kernel for {pack.device}")
    check_kernel(spec, name, weights)
    for t in (space, ttab):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tables must be 16-byte aligned")
    out = torch.empty((B, 5), dtype=torch.float32, device=pack.device)
    with torch.cuda.device(pack.device):
        stream = torch.cuda.current_stream().cuda_stream
        build.check_launch(fn(
            space.data_ptr(), pack.data_ptr(), ray_pack.data_ptr(),
            ttab.data_ptr(), out.data_ptr(), shade_params(B, spec, wb),
            stream), name)
    return out


def shade(quad, pack, ray_pack, ttab, wb, spec):
    """Run K2: returns f32 [B, 5] = r, g, b, acc, depth per ray. A CPU
    pack goes to `shade_plain`; a CUDA pack launches the kernel or
    raises. Counts launches in `shade.launches`."""
    B = _check(quad, ((spec.H + 1) * (spec.W + 1), 4 * spec.C), pack,
               ray_pack, ttab, wb, spec)
    if pack.device.type == "cpu":
        return shade_plain(quad, pack, ray_pack, ttab, wb, spec)
    out = _launch("shade", build.load_library().lib.shade_launch, quad,
                  pack, ray_pack, ttab, wb, spec, B)
    shade.launches += 1
    return out


shade.launches = 0


def shade_preblended(feats, pack, ray_pack, ttab, wb, spec):
    """Run K2 on pre-blended space features bf16 [B*S, C] (one row per
    sample, in the pack's order): returns f32 [B, 5]. A CPU pack goes to
    `shade_preblended_plain`; a CUDA pack launches the kernel or raises.
    Counts launches in `shade_preblended.launches`."""
    B = _check(feats, (pack.shape[1], spec.C), pack, ray_pack, ttab, wb,
               spec)
    if pack.device.type == "cpu":
        return shade_preblended_plain(feats, pack, ray_pack, ttab, wb, spec)
    out = _launch("shade_preblended",
                  build.load_library().lib.shade_preblended_launch, feats,
                  pack, ray_pack, ttab, wb, spec, B, weights=False)
    shade_preblended.launches += 1
    return out


shade_preblended.launches = 0
