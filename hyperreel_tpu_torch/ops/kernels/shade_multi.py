"""Multi-axis shade + composite (K5): from the per-sample pack
(ops/kernels/layout.py) to the per-ray colour, for the VM nets with three
axes: the static net (TensorVMNoSample, a plane times a line per axis, the
llff_z_plane family) and the dynamic one (TensorVMKeyframeTime, a space
plane times a keyframe time plane per axis, the neural_3d_z_plane family).

Replaces hyperreel_tpu/ops/pallas/shade.py:_shade_kernel_multi (with
_multi_core and its time-plane branch, the wrapper
fused_shade_composite_multi) and the XLA quad-row gathers before it. CUDA
source: csrc/shade_multi.cu (the per-axis body in csrc/multi_core.cuh, the
colour and composite in csrc/shade_core.cuh). Bound on the H100 by its f32 operations while the
quad tables stay in L2; at a trained checkpoint's grid they exceed it (see
the source). `shade_multi_preblended` is the same kernel reading the three
planes' features that K4 (ops/kernels/patch_blend.py) wrote, bf16 [B*S,
C_a] one row per sample, instead of the quad tables (the two-kernel patch
route; shade.py `preblended="phase_major"`).

Per valid sample and axis a (MAT_MODE plane coordinates m0, m1, VEC_MODE
line coordinate v): the plane features, bilinear from one quad-table row;
the second factor: linear between two rows of the line [L, C_a], or, for
a dynamic net (AxisSpec.TH > 0), the same on the two keyframe rows of the
time plane [TH, L, C_a] around the ray's time coordinate tn (ray pack row
7), mixed linearly in tn (a time plane premixed for one t, `premix_time`,
is a line: TH = 0); their product; the first nd_a channels sum into the
density feature, the rest append to the appearance vector in axis order.
Then relu density (of the density feature times the sample's weight when
the pack has the weights row: the static net's own fused route,
models/tensorf.py TensorVMNoSample apply_fused), the SH or RGB colour of
the [3K, A] basis (no density columns) times the appearance vector, and
the composite (ops/kernels/shade.py `shade_tail_plain`).

Tables (built once per checkpoint): the quad tables `shade.quad_table`
of each plane, the lines f32 [L, C_a] or time planes f32 [TH, L, C_a] as
they are (`line_table`), and `multi_basis_table`, on the host (it rides in
the kernel's parameters). The quad kernel is built for the [8, 4, 4]
layout of both families and for [8, 8, 8] (the catacaustics_distance
preset), the pre-blended kernel and K6 for [8, 4, 4] only
(csrc/multi_core.cuh Layout844, Layout888 and PatchLayout, read back by
the loader as `build.load_library().multi_layouts`), and S a power of two
<= 64 (at least 4 for the quad kernel); other layouts and S run the plain
version on the CPU and raise on the card.

On the card the quad kernel runs a thread per ray over its samples (S a
multiple of 4); it folds the SH basis with the ray's view direction once
per ray (shade.py `fold_sh_basis` is the plain form of the fold) and
reads the lines and time planes through L1. Each launch reports its
persistent grid, blocks per SM, L1/shared carve-out and shared memory per
block in `shade_multi.last_launch`. The pre-blended kernel runs a warp
segment per ray (a thread per ray measured slower on the two-kernel
frames: PERF.md); `shade_multi_preblended_folded_plain` is the same
function in the thread-per-ray order, a second reference for it.
"""

import ctypes

from dataclasses import dataclass
from typing import Tuple

import torch

from hyperreel_tpu_torch.models.tensorf import MAT_MODE, VEC_MODE
from hyperreel_tpu_torch.ops.kernels import build
from hyperreel_tpu_torch.ops.kernels.layout import check_pack, check_ray_pack
from hyperreel_tpu_torch.ops.kernels.shade import (
    line_lookup, quad_features, quad_table, shade_tail_plain, shading_built,
    taps)
from hyperreel_tpu_torch.ops.patch_gather import build_patch_table_2d

MAX_S = 64
# the quad kernel's pack tiles take 4 samples at a time
# (csrc/shade_multi.cu kStageS)
MIN_QUAD_S = 4


@dataclass(frozen=True)
class AxisSpec:
    """One axis: the plane [H, W, C], the second factor (the line [L, C],
    or the time plane [TH, L, C] when TH > 0), and the first nd channels
    being density."""
    index: int                  # i of MAT_MODE[i], VEC_MODE[i]
    W: int
    H: int
    L: int
    C: int
    nd: int
    TH: int = 0

    @property
    def m0(self):
        return MAT_MODE[self.index][0]

    @property
    def m1(self):
        return MAT_MODE[self.index][1]

    @property
    def v(self):
        return VEC_MODE[self.index]


@dataclass(frozen=True)
class MultiSpec:
    S: int
    axes: Tuple[AxisSpec, ...]
    deg: int                    # SH degree (unused by RGB)
    distance_scale: float
    shading: str = "sh"         # or "rgb"
    weights: bool = False       # the pack has the weights row

    @property
    def n_app(self):
        return sum(a.C - a.nd for a in self.axes)

    @property
    def n_basis(self):
        return 1 if self.shading == "rgb" else (self.deg + 1) ** 2


def line_table(line):
    """[L, C] line or [TH, L, C] time plane -> the f32 table the kernels
    read."""
    return line.float().contiguous()


def axis_tables(grids, density_n_comp, time_planes, patch=None):
    """A VM net's axes (FactoredNet.axis_grids: (i, plane [H, W, C],
    second factor)) -> (their AxisSpecs, the planes' quad tables, the
    second factors' f32 tables, and with `patch` = (px, py) the planes'
    bf16 patch tables); `time_planes`: the second factors are time planes
    [TH, L, C], else lines [L, C]."""
    axes, quads, lines, ptabs = [], [], [], []
    for i, plane, second in grids:
        H, W, C = plane.shape
        axes.append(AxisSpec(index=i, W=W, H=H, L=second.shape[-2], C=C,
                             nd=density_n_comp[i],
                             TH=second.shape[0] if time_planes else 0))
        quads.append(quad_table(plane))
        lines.append(line_table(second))
        if patch is not None:
            ptabs.append(build_patch_table_2d(plane.to(torch.bfloat16),
                                              *patch))
    return tuple(axes), quads, lines, ptabs


def multi_basis_table(basis_weight):
    """basis [3K, A] (nn.Linear layout over the concatenated appearance
    channels) -> f32 [3K, A] on the host; unlike `shade.basis_table` it has
    no density columns."""
    return basis_weight.detach().float().cpu().contiguous()


def second_factor(line, pack, tn, ax):
    """Axis ax's second factor f32 [B*S, C] at every sample: the line's
    taps, or on a time plane the z taps of the two keyframe rows around
    the per-sample time coordinate tn [B*S], mixed by tn's taps
    (csrc/multi_core.cuh line_product)."""
    zi, wz0, wz1 = taps(pack[ax.v], ax.L)
    if ax.TH == 0:
        return line_lookup(line, zi, wz0, wz1)
    ti, wt0, wt1 = taps(tn, ax.TH)
    flat = line.reshape(ax.TH * ax.L, ax.C)
    out = torch.zeros(pack.shape[1], ax.C, device=pack.device)
    for dk, wt in ((0, wt0), (1, wt1)):
        k = torch.clamp(ti + dk, 0, ax.TH - 1) * ax.L
        zf = flat[k + torch.clamp(zi, 0, ax.L - 1)] * wz0[:, None] \
            + flat[k + torch.clamp(zi + 1, 0, ax.L - 1)] * wz1[:, None]
        out = out + zf * wt[:, None]
    return out


def axis_products(feats, lines, pack, ray_pack, spec):
    """Per-axis plane features f32 [B*S, C_a] -> (density feature [B*S],
    appearance [B*S, A]): the second factors, the products and the
    sums."""
    tn = ray_pack[:, 7].repeat_interleave(spec.S, 0)
    dens, app = 0.0, []
    for f, line, ax in zip(feats, lines, spec.axes):
        prod = f * second_factor(line, pack, tn, ax)
        dens = dens + prod[:, :ax.nd].sum(-1)
        app.append(prod[:, ax.nd:])
    return dens, torch.cat(app, -1)


def shade_multi_features_plain(feats, lines, pack, ray_pack, wb, spec,
                               fold=False, running=False):
    """Everything after the plane features -> f32 [B, 5] (with the SH
    basis folded per ray where `fold`, the composite a running sum per ray
    where `running`)."""
    dens, app = axis_products(feats, lines, pack, ray_pack, spec)
    return shade_tail_plain(dens, app, wb, pack, ray_pack, spec, fold,
                            running)


def shade_multi_plain(quads, lines, pack, ray_pack, wb, spec):
    """Plain PyTorch version of the kernel (same inputs and output)."""
    feats = [quad_features(q, pack[ax.m0], pack[ax.m1], ax.W, ax.H, ax.C)
             for q, ax in zip(quads, spec.axes)]
    return shade_multi_features_plain(feats, lines, pack, ray_pack, wb, spec)


def shade_multi_preblended_plain(feats, lines, pack, ray_pack, wb, spec):
    """Plain PyTorch version of the pre-blended kernel."""
    return shade_multi_features_plain([f.float() for f in feats], lines,
                                      pack, ray_pack, wb, spec)


def shade_multi_preblended_folded_plain(feats, lines, pack, ray_pack, wb,
                                        spec):
    """`shade_multi_preblended_plain` in the order of a thread per ray: the
    SH colour from the basis folded with each ray's view direction
    (shade.py `fold_sh_basis`) and the composite a running sum per ray
    (`composite_running_plain`); the same function up to the order of the
    sums, held against the kernel as a second reference."""
    return shade_multi_features_plain([f.float() for f in feats], lines,
                                      pack, ray_pack, wb, spec, True, True)


def shade_multi_folded_plain(quads, lines, pack, ray_pack, wb, spec):
    """`shade_multi_plain` with the SH colour taken from the folded basis
    (shade.py `fold_sh_basis`), as the kernels take it: the same function
    up to the order of the sums. RGB colour has nothing to fold."""
    feats = [quad_features(q, pack[ax.m0], pack[ax.m1], ax.W, ax.H, ax.C)
             for q, ax in zip(quads, spec.axes)]
    return shade_multi_features_plain(feats, lines, pack, ray_pack, wb, spec,
                                      True)


def check_lines(lines, wb, spec, device):
    """Raise unless the second factors and the basis fit `spec` (lines
    [L, C] or time planes [TH, L, C], contiguous f32 on `device`; wb on
    the host)."""
    if len(lines) != len(spec.axes):
        raise ValueError(f"{len(lines)} lines for {len(spec.axes)} axes")
    K = spec.n_basis
    shapes = [(f"line {a.index}", t, (a.TH, a.L, a.C) if a.TH else
               (a.L, a.C)) for t, a in zip(lines, spec.axes)]
    for name, t, shape in shapes + [("wb", wb, (3 * K, spec.n_app))]:
        if t.dtype != torch.float32 or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous f32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if any(t.device != device for t in lines):
        raise ValueError("the lines lie on another device than the pack")
    if wb.device.type != "cpu":
        raise ValueError("wb must lie on the host")


def check_tables(tables, shapes, name):
    """Raise unless each table is a contiguous bf16 tensor of its shape."""
    for t, shape in zip(tables, shapes):
        if t.dtype != torch.bfloat16 or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous bf16 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")


def _check(tables, shapes, lines, pack, ray_pack, wb, spec):
    check_tables(tables, shapes, "each plane's table")
    B = check_pack(pack, spec.S, spec.weights)
    check_ray_pack(ray_pack, B)
    check_lines(lines, wb, spec, pack.device)
    if any(t.device != pack.device for t in tables) \
            or ray_pack.device != pack.device:
        raise ValueError("the tables, ray_pack and pack lie on different "
                         "devices")
    return B


def spec_layout(spec):
    """spec's layout: (axis, C, density channels) per plane."""
    return tuple((a.index, a.C, a.nd) for a in spec.axes)


def check_kernel(spec, name, weights=True, min_s=1):
    """Raise unless kernel `name` (build.MULTI_KERNELS) is built for spec's
    layout, colour and S (at least `min_s`), and, where `weights` is
    False, unless spec has no weights row."""
    layout = spec_layout(spec)
    built = build.load_library().multi_layouts[name]
    if layout not in built or not shading_built(spec) \
            or not min_s <= spec.S <= MAX_S or spec.S & (spec.S - 1):
        raise NotImplementedError(
            f"{name} kernel: layout {layout}, {spec.shading} with "
            f"{spec.n_basis} basis rows, S={spec.S} not built (layouts "
            f"{built}, SH of degree 0-4 or RGB, S a power of two in "
            f"[{min_s}, {MAX_S}]; ROADMAP.md 2a b: the other axis layouts)")
    if spec.weights and not weights:
        raise NotImplementedError(
            f"{name} kernel: the weights row is built into the quad "
            "kernels of K2 and K5 only (ROADMAP.md 2a: use_weights_row)")


def multi_params(B, spec, tables, lines, wb):
    """The kernels' MultiParams for B rays (the basis rides in them)."""
    p = build.MultiParams()
    p.B, p.S, p.nb = B, spec.S, spec.n_basis
    p.rgb, p.weights = int(spec.shading == "rgb"), int(spec.weights)
    p.distance_scale = float(spec.distance_scale)
    for i, (ax, t, line) in enumerate(zip(spec.axes, tables, lines)):
        p.axis[i] = build.MultiAxis(t.data_ptr(), line.data_ptr(), ax.W,
                                    ax.H, ax.L, ax.TH)
        p.ch[i], p.nd[i] = ax.C, ax.nd
    vals = wb.reshape(-1).tolist()
    p.wb[:len(vals)] = vals
    return p


def _launch(name, fn, tables, lines, pack, ray_pack, wb, spec, B, pre):
    """Launch K5 (pre: the pre-blended kernel); what the quad kernel's
    launch chose goes to `shade_multi.last_launch`."""
    if pack.device.type != "cuda":
        raise ValueError(f"{name} has no kernel for {pack.device}")
    check_kernel(spec, name, weights=not pre,
                 min_s=1 if pre else MIN_QUAD_S)
    if len({bool(a.TH) for a in spec.axes}) > 1:
        raise NotImplementedError(
            f"{name} kernel: built for lines on every axis or time planes "
            "on every axis, not a mix")
    if any(t.data_ptr() % 16 for t in list(tables) + list(lines) + [pack]):
        raise ValueError(f"{name}: the tables and the pack must be 16-byte "
                         "aligned")
    args = [multi_params(B, spec, tables, lines, wb)]
    if not pre:
        chosen = (ctypes.c_int * 4)()
        args.append(chosen)
    out = torch.empty((B, 5), dtype=torch.float32, device=pack.device)
    with torch.cuda.device(pack.device):
        stream = torch.cuda.current_stream().cuda_stream
        build.check_launch(fn(pack.data_ptr(), ray_pack.data_ptr(),
                              out.data_ptr(), *args, stream), name)
    if not pre and B:
        shade_multi.last_launch = dict(zip(
            ("grid", "blocks_per_sm", "carveout", "smem_bytes"), chosen))
    return out


def shade_multi(quads, lines, pack, ray_pack, wb, spec):
    """Run K5: returns f32 [B, 5] = r, g, b, acc, depth per ray. A CPU pack
    goes to `shade_multi_plain`; a CUDA pack launches the kernel or
    raises. Counts launches in `shade_multi.launches`."""
    B = _check(quads, [((a.H + 1) * (a.W + 1), 4 * a.C) for a in spec.axes],
               lines, pack, ray_pack, wb, spec)
    if pack.device.type == "cpu":
        return shade_multi_plain(quads, lines, pack, ray_pack, wb, spec)
    out = _launch("shade_multi", build.load_library().lib.shade_multi_launch,
                  quads, lines, pack, ray_pack, wb, spec, B, pre=False)
    shade_multi.launches += 1
    return out


shade_multi.launches = 0
shade_multi.last_launch = None


def shade_multi_preblended(feats, lines, pack, ray_pack, wb, spec):
    """Run K5 on pre-blended plane features, bf16 [B*S, C_a] per axis (one
    row per sample, in the pack's order): returns f32 [B, 5]. A CPU pack
    goes to `shade_multi_preblended_plain`; a CUDA pack launches the kernel
    or raises. Counts launches in `shade_multi_preblended.launches`."""
    B = _check(feats, [(pack.shape[1], a.C) for a in spec.axes], lines,
               pack, ray_pack, wb, spec)
    if pack.device.type == "cpu":
        return shade_multi_preblended_plain(feats, lines, pack, ray_pack, wb,
                                            spec)
    out = _launch("shade_multi_preblended",
                  build.load_library().lib.shade_multi_preblended_launch,
                  feats, lines, pack, ray_pack, wb, spec, B, pre=True)
    shade_multi_preblended.launches += 1
    return out


shade_multi_preblended.launches = 0
