"""Ray-primitive intersection math (port of the z-plane part of
hyperreel_tpu/ops/intersect_math.py; reference
utils/intersect_utils.py:127-150). Rays are [..., 6+]: origin 0:3,
direction 3:6."""

import torch

EPS_DIR = 1e-5
BIG = 1e12


def safe_dirs(rays_d):
    """Direction components with |d| < 1e-5 replaced by 1e12."""
    return torch.where(rays_d.abs() < EPS_DIR,
                       torch.full_like(rays_d, BIG), rays_d)


def intersect_axis_plane(rays, val, dim):
    """t such that o[dim] + t * d[dim] == val; `val` broadcasts against
    rays[..., 0]."""
    return (val - rays[..., dim]) / safe_dirs(rays[..., 3:6])[..., dim]
