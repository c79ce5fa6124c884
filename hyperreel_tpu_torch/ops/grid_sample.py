"""Bilinear plane and linear line lookups with `F.grid_sample` semantics
(align_corners=True, zero padding) on channels-last grids (port of
hyperreel_tpu/ops/grid_sample.py grid_sample_2d and the 1-D lookup, which
the colour nets' general paths use).

Texels are read at the table's dtype (bf16 tables round the stored values,
as the JAX quad gathers do) and interpolated in f32.
"""

import torch


def _unnormalize(coord, size):
    """[-1, 1] -> [0, size - 1] pixel coordinates (align_corners=True)."""
    return (coord + 1.0) * 0.5 * (size - 1)


def grid_sample_2d(grid_hwc, coords):
    """grid [H, W, C]; coords [N, 2] (x indexes W, y indexes H) ->
    [N, C] f32. Out-of-range corners contribute zero."""
    H, W, C = grid_hwc.shape
    x = _unnormalize(coords[:, 0], W)
    y = _unnormalize(coords[:, 1], H)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx1 = x - x0
    wy1 = y - y0
    flat = grid_hwc.reshape(H * W, C)

    def corner(yc, xc, w):
        inb = (xc >= 0) & (xc <= W - 1) & (yc >= 0) & (yc <= H - 1)
        xi = torch.clamp(xc, 0, W - 1).long()
        yi = torch.clamp(yc, 0, H - 1).long()
        val = flat[yi * W + xi].float()
        return val * (w * inb.float())[:, None]

    return (corner(y0, x0, (1.0 - wy1) * (1.0 - wx1))
            + corner(y0, x0 + 1.0, (1.0 - wy1) * wx1)
            + corner(y0 + 1.0, x0, wy1 * (1.0 - wx1))
            + corner(y0 + 1.0, x0 + 1.0, wy1 * wx1))


def grid_sample_1d(line_lc, coords):
    """Linear lookup of a line [L, C] at coords [N] (align_corners=True,
    zero padding) -> [N, C] f32 (hyperreel_tpu/ops/grid_sample.py
    grid_sample_1d_cf_quad, the static net's line factor)."""
    L = line_lc.shape[0]
    z = _unnormalize(coords, L)
    z0 = torch.floor(z)
    wz1 = z - z0

    def tap(zc, w):
        inb = (zc >= 0) & (zc <= L - 1)
        val = line_lc[torch.clamp(zc, 0, L - 1).long()].float()
        return val * (w * inb.float())[:, None]

    return tap(z0, 1.0 - wz1) + tap(z0 + 1.0, wz1)

