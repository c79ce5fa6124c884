"""Coherent patch-gather (port of hyperreel_tpu/ops/patch_gather.py): one
patch row of px x py texels serves the bilinear lookups of a block of R
rays at one sample slot.

Rays rendered in frame scanline order are spatially coherent: at a high
pixel density the R rays of a block sample texels a fraction of a texel
apart, so ONE (px x py)-texel patch row anchored at the block minimum
covers all R rays' 2x2 footprints:

  rows read: N -> N / R
  bytes / sample: 4C*2 (quad) -> px*py*C*2 / R

Semantics match the quad table's bilinear lookup (align_corners=True,
zero padding) exactly whenever each ray's 2x2 footprint fits its block's
patch, and degrade gracefully (hat weights vanish -> zero features,
identical to far-out-of-range zero padding) when it does not. The
coverage is geometry-dependent; the render path returns the measured
violation rate. Eval-only.

The patch table is row-major [(H+1)*(W+1), px*py*C] with texel t =
ty*px + tx channel-major inside the row. These are the plain versions;
the kernels that use them are ops/kernels/patch_blend.py (K4) and
ops/kernels/shade_patch.py (K3).
"""

import torch
import torch.nn.functional as F


def unnormalize(coord, size):
    """Normalised [-1, 1] -> texel coordinate (align_corners=True)."""
    return (coord + 1.0) * 0.5 * (size - 1)


def build_patch_table_2d(grid_hwc, px=4, py=2):
    """[(H+1)*(W+1), px*py*C] patch rows from a [H, W, C] plane.

    Row (y0+1)*(W+1) + (x0+1) holds texels (y0+ty, x0+tx) for ty < py,
    tx < px, zero outside the plane (matching the quad table's zero
    ring); anchors x0 in [-1, W-1], y0 in [-1, H-1]. Texels are laid out
    t-major: row[:, (ty*px+tx)*C : +C] = plane[y0+ty, x0+tx].
    """
    H, W, C = grid_hwc.shape
    p = F.pad(grid_hwc, (0, 0, 1, px - 1, 1, py - 1))
    tiles = [p[ty:ty + H + 1, tx:tx + W + 1]
             for ty in range(py) for tx in range(px)]
    return torch.cat(tiles, -1).reshape((H + 1) * (W + 1),
                                        px * py * C).contiguous()


def hat_weights(u, p):
    """[p, N] hat (bilinear) weights over patch texel positions.

    w[t] = max(0, 1 - |u - t|): reproduces the two bilinear corner
    weights for in-patch u, and vanishes for out-of-patch u (the
    zero-padding behaviour for coverage violations / far-out coords).
    """
    t = torch.arange(p, dtype=u.dtype, device=u.device)[:, None]
    return torch.clamp_min(1.0 - (u[None, :] - t).abs(), 0.0)


def patch_blend(rows, u, v, px, py, C):
    """Blend patch rows [N//R, px*py*C] to features [C, N] (row i serves
    samples i*R .. i*R + R-1); u, v the per-sample in-patch offsets."""
    n = u.shape[0]
    R = n // rows.shape[0]
    wx = hat_weights(u, px)                    # [px, N]
    wy = hat_weights(v, py)                    # [py, N]
    feats = rows.reshape(n // R, py, px, C).float()
    feats = feats.repeat_interleave(R, 0)      # [N, py, px, C]
    w = wy.t()[:, :, None] * wx.t()[:, None, :]
    return torch.einsum("nyx,nyxc->cn", w, feats)


def coverage_violations(x, y, R, px=4, py=2):
    """Fraction of R-ray blocks whose 2x2 footprint exits the block patch
    (the samples patch sampling zero-degrades); x, y unnormalised texel
    coords [N], rays grouped in R-consecutive blocks."""
    n = x.shape[0]
    xb = x.reshape(n // R, R)
    yb = y.reshape(n // R, R)
    vx = xb.max(-1).values.floor() - xb.min(-1).values.floor() > px - 2
    vy = yb.max(-1).values.floor() - yb.min(-1).values.floor() > py - 2
    return (vx | vy).float().mean()
