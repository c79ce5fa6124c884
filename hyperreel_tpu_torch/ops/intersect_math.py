"""Ray-primitive intersection math (port of the z-plane, voxel-grid,
general-plane, sphere, cylinder and Pluecker parts of
hyperreel_tpu/ops/intersect_math.py; reference
utils/intersect_utils.py, nlf/param.py:297-307). Rays are [..., 6+]:
origin 0:3, direction 3:6. Distances are returned raw (they may be
negative or zero); the intersect stages mask and sort them."""

import torch

EPS_DIR = 1e-5
BIG = 1e12


def dot(a, b):
    return (a * b).sum(-1)


def safe_norm(v, keepdim=True, eps=1e-12):
    """sqrt(max(sum v^2, eps^2)) over the last axis."""
    return torch.sqrt(torch.clamp_min((v * v).sum(-1, keepdim=keepdim),
                                      eps * eps))


def safe_dirs(rays_d):
    """Direction components with |d| < 1e-5 replaced by 1e12."""
    return torch.where(rays_d.abs() < EPS_DIR,
                       torch.full_like(rays_d, BIG), rays_d)


def intersect_axis_plane(rays, val, dim):
    """t such that o[dim] + t * d[dim] == val; `val` broadcasts against
    rays[..., 0]."""
    return (val - rays[..., dim]) / safe_dirs(rays[..., 3:6])[..., dim]


def intersect_voxel_grid(rays, origin, val):
    """Axis-aligned planes in all three dims at offsets `val` [B, S, 3]
    (reference utils/intersect_utils.py:152-179); rays [B, 1, 6] ->
    distances [B, S * 3], the three axes of a sample adjacent."""
    t = (val - (rays[..., :3] - origin)) / safe_dirs(rays[..., 3:6])
    return t.reshape(t.shape[0], -1)


def intersect_plane(rays, normal, distance):
    """Planes n . x = distance (reference utils/intersect_utils.py:
    210-236): rays [B, S, 6] (or broadcastable), normal [B, S, 3],
    distance [B, S] -> [B, S]; a direction within 1e-5 of the plane takes
    n . d = 1e12."""
    o_n = dot(rays[..., :3], normal)
    d_n = dot(rays[..., 3:6], normal)
    d_n = torch.where(d_n.abs() < EPS_DIR, torch.full_like(d_n, BIG), d_n)
    t = (distance - o_n) / d_n
    return t.reshape(t.shape[0], -1)


def _quadratic_intersect(o2, d2, od, radius):
    """The hit of |o + t d| = radius from |o|^2, |d|^2 and o.d: the near
    root, or the far one where the near lies behind the origin or the
    radius is negative (the reference's far-side convention); 0 where the
    ray misses."""
    b = 2.0 * od
    c = o2 - radius * radius
    disc = torch.clamp_min(b * b - 4.0 * d2 * c, 0.0)
    sq = torch.sqrt(disc + 1e-8)
    t1 = (-b + sq) / (2.0 * d2)
    t2 = (-b - sq) / (2.0 * d2)
    t1 = torch.where(disc <= 0, torch.zeros_like(t1), t1)
    t2 = torch.where(disc <= 0, torch.zeros_like(t2), t2)
    return torch.where((t2 < 0) | (radius < 0), t1, t2)


def intersect_sphere(rays, origin, radius):
    """Concentric spheres about `origin` (reference
    utils/intersect_utils.py:45-84); radius broadcasts against
    rays[..., 0]."""
    o = rays[..., :3] - origin
    d = rays[..., 3:6]
    return _quadratic_intersect(dot(o, o), dot(d, d), dot(o, d), radius)


def _xz(v):
    """The x and z components of [..., 3] (a y-axis cylinder drops y)."""
    return torch.stack([v[..., 0], v[..., 2]], -1)


def intersect_cylinder(rays, origin, radius):
    """Concentric y-axis cylinders (reference
    utils/intersect_utils.py:86-125)."""
    o = _xz(rays[..., :3] - origin)
    d = _xz(rays[..., 3:6])
    return _quadratic_intersect(dot(o, o), dot(d, d), dot(o, d), radius)


def pluecker_closest_point(rays_o, rays_d):
    """The point of each ray closest to the origin, from its Pluecker
    coordinates (reference nlf/param.py:297-307)."""
    d = rays_d / safe_norm(rays_d)
    m = torch.linalg.cross(rays_o, d)
    return torch.linalg.cross(d, m)


def min_sphere_radius(rays, origin):
    """The smallest concentric sphere each ray touches (reference
    utils/intersect_utils.py:27-33)."""
    p = pluecker_closest_point(rays[..., :3] - origin, rays[..., 3:6])
    return safe_norm(p, keepdim=False)


def min_cylinder_radius(rays, origin):
    """The same for y-axis cylinders (reference
    utils/intersect_utils.py:35-43)."""
    o = rays[..., :3] - origin
    d = rays[..., 3:6]
    zero_y = torch.tensor([1.0, 0.0, 1.0], dtype=o.dtype, device=o.device)
    p = pluecker_closest_point(o * zero_y, d * zero_y)
    return safe_norm(p, keepdim=False)
