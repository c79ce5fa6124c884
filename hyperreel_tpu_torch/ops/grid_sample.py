"""Bilinear plane and linear line lookups with `F.grid_sample` semantics
(align_corners=True, zero padding) on channels-last grids (port of
hyperreel_tpu/ops/grid_sample.py grid_sample_2d and the 1-D lookup, which
the colour nets' general paths use, of the custom VJP of its quad
lookups, `_quad2d_bwd` / `_quad1d_bwd`, and of the grid events' resizes,
`resize_bilinear_2d` / `resize_linear_1d`).

Texels are read at the table's dtype (bf16 tables round the stored values,
as the JAX quad gathers do) and interpolated in f32.

Where autograd records a lookup (a table or the coordinates require grad),
it runs as an autograd Function with the JAX package's hand-made
backward; elsewhere (every eval route) it is the same per-corner forward
without the residuals. The grid gradient sums every sample's corner
weights in f32 (one `index_add_`) and rounds to the table's dtype once,
where autograd through `flat[idx]` would sum in the table's dtype (a bf16
table's thousands of samples per texel would lose most of the sum); the
coordinate gradient comes from the corner texels that the forward read.
"""

import numpy as np
import torch


def _unnormalize(coord, size):
    """[-1, 1] -> [0, size - 1] pixel coordinates (align_corners=True)."""
    return (coord + 1.0) * 0.5 * (size - 1)


def _corners_2d(coords, H, W):
    """The four corners of each coordinate, in the order (y0, x0), (y0,
    x1), (y1, x0), (y1, x1): ([(flat texel indices [N], bilinear weight
    times the in-bounds mask [N], the mask [N])], wx1, wy1)."""
    x = _unnormalize(coords[:, 0], W)
    y = _unnormalize(coords[:, 1], H)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx1 = x - x0
    wy1 = y - y0
    corners = []
    for yc, xc, wc in ((y0, x0, (1.0 - wy1) * (1.0 - wx1)),
                       (y0, x0 + 1.0, (1.0 - wy1) * wx1),
                       (y0 + 1.0, x0, wy1 * (1.0 - wx1)),
                       (y0 + 1.0, x0 + 1.0, wy1 * wx1)):
        ok = ((xc >= 0) & (xc <= W - 1) & (yc >= 0) & (yc <= H - 1)).float()
        corners.append((_index(yc, H) * W + _index(xc, W), wc * ok, ok))
    return corners, wx1, wy1


def _index(c, size):
    """A corner's texel index, clamped into [0, size - 1]; a NaN
    coordinate reads texel 0 (its weight is NaN, so the lookup gives NaN,
    as the JAX package's clamped gather does) where a NaN index would
    read out of bounds."""
    return torch.clamp(torch.nan_to_num(c), 0, size - 1).long()


def _corners_1d(coords, L):
    """The two neighbours of each coordinate: ([(indices [N], weight
    times the in-bounds mask [N], the mask [N])], wz1)."""
    z = _unnormalize(coords, L)
    z0 = torch.floor(z)
    wz1 = z - z0
    corners = []
    for zc, wc in ((z0, 1.0 - wz1), (z0 + 1.0, wz1)):
        ok = ((zc >= 0) & (zc <= L - 1)).float()
        corners.append((_index(zc, L), wc * ok, ok))
    return corners, wz1


def _blend(flat, corners):
    """The corner texels of `flat` [rows, C], one gather per corner at the
    table's dtype, and their f32 sum over the corners in order [N, C]:
    (the sum, [the texels [N, C]])."""
    q = [flat[i] for i, _, _ in corners]
    out = q[0].float() * corners[0][1][:, None]
    for qk, (_, wk, _) in zip(q[1:], corners[1:]):
        out = out + qk.float() * wk[:, None]
    return out, q


def _saved(corners, q):
    """The backward's residuals: the texels [K, N, C], indices, weights
    and masks [K, N]."""
    idx, w, inb = (torch.stack(c) for c in zip(*corners))
    return torch.stack(q), idx, w, inb


def _grid_grad(g, idx, w, rows, dtype):
    """The table's gradient [rows, C]: every corner's g * w summed in f32
    by one index_add_, then one rounding to the table's dtype."""
    K, N = w.shape
    acc = g.new_zeros(rows, g.shape[1], dtype=torch.float32)
    acc.index_add_(0, idx.reshape(-1),
                   (w[:, :, None] * g.float()[None]).reshape(K * N, -1))
    return acc.to(dtype)


class _Quad2d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, grid_hwc, coords):
        H, W, C = grid_hwc.shape
        corners, wx1, wy1 = _corners_2d(coords, H, W)
        out, q = _blend(grid_hwc.reshape(H * W, C), corners)
        q, idx, w, inb = _saved(corners, q)
        ctx.save_for_backward(q, idx, w, wx1, wy1, inb)
        ctx.shape = (H, W, C, grid_hwc.dtype)
        return out

    @staticmethod
    def backward(ctx, g):
        q, idx, w, wx1, wy1, inb = ctx.saved_tensors
        H, W, C, dtype = ctx.shape
        g_grid = g_coords = None
        if ctx.needs_input_grad[0]:
            g_grid = _grid_grad(g, idx, w, H * W, dtype).reshape(H, W, C)
        if ctx.needs_input_grad[1]:
            # per corner sum_c texel * g, masked (hyperreel_tpu
            # _quad2d_bwd: from the residual corner rows)
            s = (q.float() * g.float()[None]).sum(-1) * inb    # [4, N]
            dwx = (-(1.0 - wy1) * s[0] + (1.0 - wy1) * s[1]
                   - wy1 * s[2] + wy1 * s[3])
            dwy = (-(1.0 - wx1) * s[0] - wx1 * s[1]
                   + (1.0 - wx1) * s[2] + wx1 * s[3])
            g_coords = torch.stack([dwx * (0.5 * (W - 1)),
                                    dwy * (0.5 * (H - 1))], -1)
        return g_grid, g_coords


class _Quad1d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, line_lc, coords):
        L, C = line_lc.shape
        corners, _ = _corners_1d(coords, L)
        out, q = _blend(line_lc, corners)
        q, idx, w, inb = _saved(corners, q)
        ctx.save_for_backward(q, idx, w, inb)
        ctx.shape = (L, C, line_lc.dtype)
        return out

    @staticmethod
    def backward(ctx, g):
        q, idx, w, inb = ctx.saved_tensors
        L, C, dtype = ctx.shape
        g_line = g_coords = None
        if ctx.needs_input_grad[0]:
            g_line = _grid_grad(g, idx, w, L, dtype)
        if ctx.needs_input_grad[1]:
            s = (q.float() * g.float()[None]).sum(-1) * inb    # [2, N]
            g_coords = (s[1] - s[0]) * (0.5 * (L - 1))
        return g_line, g_coords


def _recording(*tensors):
    """Whether autograd records a call on `tensors`."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def grid_sample_2d(grid_hwc, coords):
    """grid [H, W, C]; coords [N, 2] (x indexes W, y indexes H) ->
    [N, C] f32. Out-of-range corners contribute zero. Where autograd
    records the call, the lookup keeps the residuals of its backward."""
    if _recording(grid_hwc, coords):
        return _Quad2d.apply(grid_hwc, coords)
    H, W, C = grid_hwc.shape
    return _blend(grid_hwc.reshape(H * W, C),
                  _corners_2d(coords, H, W)[0])[0]


def grid_sample_1d(line_lc, coords):
    """Linear lookup of a line [L, C] at coords [N] (align_corners=True,
    zero padding) -> [N, C] f32 (hyperreel_tpu/ops/grid_sample.py
    grid_sample_1d_cf_quad, the static net's line factor)."""
    if _recording(line_lc, coords):
        return _Quad1d.apply(line_lc, coords)
    return _blend(line_lc, _corners_1d(coords, line_lc.shape[0])[0])[0]


def linspace(start, stop, n, device=None):
    """n points from start to stop in f32, computed as jnp.linspace does
    under XLA (start * (1 - step) + stop * step with step = i times the
    f32 reciprocal of n - 1, the last point stop): the [0, 1] lattices of
    the alpha grid match the JAX package's to the bit."""
    if n == 1:
        return torch.full((1,), float(start), device=device)
    step = torch.arange(n - 1, dtype=torch.float32, device=device) \
        * float(np.float32(1) / np.float32(n - 1))
    out = start * (1 - step) + stop * step
    return torch.cat([out, torch.full((1,), float(stop), device=device)])


def resize_bilinear_2d(grid_hwc, new_h, new_w):
    """Bilinear resize with align_corners=True (hyperreel_tpu
    resize_bilinear_2d: the lookup at a new_h x new_w lattice of [-1, 1];
    a source axis of one texel maps every target to it)."""
    H, W, _ = grid_hwc.shape
    dev = grid_hwc.device

    def axis(n, src):
        if src == 1:
            return torch.full((n,), -1.0, device=dev)
        return linspace(-1.0, 1.0, n, dev) if n > 1 \
            else torch.zeros(1, device=dev)

    gy, gx = torch.meshgrid(axis(new_h, H), axis(new_w, W), indexing="ij")
    coords = torch.stack([gx, gy], -1).reshape(-1, 2)
    return grid_sample_2d(grid_hwc, coords).reshape(new_h, new_w, -1).to(
        grid_hwc.dtype)


def resize_linear_1d(line_lc, new_l):
    """Linear resize of a line [L, C] with align_corners=True (hyperreel_tpu
    resize_linear_1d: the lookup at new_l points of [-1, 1]; a line of one
    texel maps every target to it)."""
    L = line_lc.shape[0]
    dev = line_lc.device
    if L == 1:
        zs = torch.full((new_l,), -1.0, device=dev)
    else:
        zs = linspace(-1.0, 1.0, new_l, dev) if new_l > 1 \
            else torch.zeros(1, device=dev)
    return grid_sample_1d(line_lc, zs).to(line_lc.dtype)
