"""Ray parameterizations (port of every entry of
hyperreel_tpu/models/ray_param.py `ray_param_dict`; reference
nlf/param.py): identity, take, position, two_plane and pluecker (each
with use_local_param), multi_plane, two_plane_matrix, two_cylinder,
ray_plus_time, voxel_center, z_slice, contract_points, spherical, xy,
rays and pluecker_pos."""

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from hyperreel_tpu_torch.ops.contract import get_contract
from hyperreel_tpu_torch.ops.intersect_math import (
    intersect_axis_plane, intersect_cylinder, intersect_sphere,
    pluecker_closest_point, safe_norm)


@dataclass
class RayParam:
    name: str
    in_channels: int
    out_channels: int
    apply: Callable


def _on(values):
    """A constant as a tensor per device and dtype it meets: a
    host-to-device copy per call would synchronise the host with the
    card."""
    cache = {}

    def get(like):
        key = (like.device, like.dtype)
        t = cache.get(key)
        if t is None:
            t = cache[key] = like.new_tensor(values)
        return t

    return get


def identity_param(cfg):
    n = int(cfg.get("in_channels", cfg.get("n_dims", 6)))
    return RayParam("identity", n, int(cfg.get("n_dims", n)), lambda x: x)


def take_param(cfg):
    idx = [int(i) for i in cfg["input_channels"]]
    return RayParam("take", int(cfg.get("in_channels", 6)), len(idx),
                    lambda x: x[..., idx])


def position_param(cfg):
    return RayParam("position", 6, 3, lambda rays: rays[..., :3])


def two_plane_param(cfg):
    """(x1, y1, x2, y2) where the ray crosses z=near and z=far; with
    use_local_param the origin's z first snaps to its voxel (round half
    to even, as jnp.round) and is taken off (reference nlf/param.py:
    63-118)."""
    near = float(cfg.get("near", -1.0))
    far = float(cfg.get("far", 0.0))
    origin = _on([float(v) for v in cfg.get("origin", [0.0, 0.0, 0.0])])
    st_mult = float(cfg.get("st_multiplier", 1.0))
    uv_mult = float(cfg.get("uv_multiplier", 1.0))
    use_local = bool(cfg.get("use_local_param", False))
    voxel_size = float(cfg.get("voxel_size", 1.0))

    def apply(rays):
        rays_o = rays[..., :3] - origin(rays)
        rays_d = rays[..., 3:6]
        if use_local:
            z_off = torch.round(rays_o[..., 2:3] / voxel_size) * voxel_size
            zero = torch.zeros_like(z_off)
            rays_o = rays_o - torch.cat([zero, zero, z_off], -1)
        r = torch.cat([rays_o, rays_d], -1)
        t1 = intersect_axis_plane(r, near, 2)
        t2 = intersect_axis_plane(r, far, 2)
        p1 = (rays_o[..., :2] + rays_d[..., :2] * t1[..., None]) * st_mult
        p2 = (rays_o[..., :2] + rays_d[..., :2] * t2[..., None]) * uv_mult
        return torch.cat([p1, p2], -1)

    return RayParam("two_plane", 6, int(cfg.get("n_dims", 4)), apply)


def pluecker_param(cfg):
    """(d, o x d) with the unit direction d; with use_local_param the
    origin first snaps to its voxel (round half to even) and is taken off
    (reference nlf/param.py:223-257)."""
    d_mult = float(cfg.get("direction_multiplier", 1.0))
    m_mult = float(cfg.get("moment_multiplier", 1.0))
    origin = _on([float(v) for v in cfg.get("origin", [0.0, 0.0, 0.0])])
    use_local = bool(cfg.get("use_local_param", False))
    voxel_size = _on(np.broadcast_to(np.asarray(
        cfg.get("voxel_size", [1.0, 1.0, 1.0]), np.float32), (3,)).tolist())

    def apply(rays):
        rays_o = rays[..., :3] - origin(rays)
        d = rays[..., 3:6]
        d = d / safe_norm(d)
        if use_local:
            vs = voxel_size(rays)
            rays_o = rays_o - torch.round(rays_o / vs) * vs
        m = torch.linalg.cross(rays_o, d, dim=-1)
        return torch.cat([d * d_mult, m * m_mult], -1)

    return RayParam("pluecker", 6, int(cfg.get("n_dims", 6)), apply)


def spherical_param(cfg):
    """The hit point of a sphere about the origin, over its radius
    (reference nlf/param.py:322-360)."""
    radius = float(cfg.get("radius", 1.0))

    def apply(rays):
        t = intersect_sphere(rays, 0.0, radius)
        return (rays[..., :3] + rays[..., 3:6] * t[..., None]) / radius

    return RayParam("spherical", 6, int(cfg.get("n_dims", 3)), apply)


def xy_param(cfg):
    def apply(rays):
        r = rays.reshape(rays.shape[0], -1, 6)
        return torch.cat([r[..., :2], r[..., 3:5]], -1).reshape(
            rays.shape[0], -1)

    return RayParam("xy", 6, int(cfg.get("n_dims", 4)), apply)


def rays_param(cfg):
    def apply(rays):
        r = rays.reshape(rays.shape[0], -1, 6)
        rays_o = r[..., :3]
        v = r[..., 3:6] - rays_o
        return torch.cat([rays_o, v / safe_norm(v)], -1).reshape(
            rays.shape[0], -1)

    return RayParam("rays", 6, int(cfg.get("n_dims", 6)), apply)


def pluecker_pos_param(cfg):
    return RayParam("pluecker_pos", 6, 3, lambda rays: pluecker_closest_point(
        rays[..., :3], rays[..., 3:6]))


def multi_plane_param(cfg):
    """(x, y) where the ray crosses each of z_channels z-planes (reference
    nlf/param.py:121-160)."""
    z_channels = int(cfg.get("z_channels", 8))
    depths = torch.from_numpy(np.linspace(
        float(cfg.get("initial_z", -1.0)), float(cfg.get("end_z", 1.0)),
        z_channels).astype(np.float32))

    def apply(rays):
        t = intersect_axis_plane(rays[:, None, :],
                                 depths.to(rays.device)[None, :], 2)
        pts = rays[:, None, :2] + rays[:, None, 3:5] * t[..., None]
        return pts.reshape(rays.shape[0], -1)

    return RayParam("multi_plane", 6, 2 * z_channels, apply)


def two_plane_matrix_param(cfg):
    """two_plane, then a fixed affine matrix (its [:4, :4] block)."""
    base = two_plane_param(cfg)
    M = torch.from_numpy(np.ascontiguousarray(np.asarray(
        cfg.get("matrix", np.eye(4)), np.float32).T[:4, :4]))

    def apply(rays):
        return base.apply(rays) @ M.to(rays.device)

    return RayParam("two_plane_matrix", 6, 4, apply)


def two_cylinder_param(cfg):
    """(x1, y1, x2, z2) where the ray crosses two concentric y-axis
    cylinders (reference nlf/param.py two_cylinder)."""
    near = float(cfg.get("near", 0.5))
    far = float(cfg.get("far", 1.0))

    def apply(rays):
        p1 = rays[..., :3] + rays[..., 3:6] * intersect_cylinder(
            rays, 0.0, near)[..., None]
        p2 = rays[..., :3] + rays[..., 3:6] * intersect_cylinder(
            rays, 0.0, far)[..., None]
        return torch.cat([p1[..., 0:1], p1[..., 1:2], p2[..., 0:1],
                          p2[..., 2:3]], -1)

    return RayParam("two_cylinder", 6, 4, apply)


def ray_plus_time_param(cfg):
    """An inner param of the ray, with the trailing time channel kept."""
    inner = get_ray_param(dict(cfg.get("param", {"fn": "identity"})))

    def apply(rays):
        return torch.cat([inner.apply(rays[..., :6]), rays[..., -1:]], -1)

    return RayParam("ray_plus_time", 7, inner.out_channels + 1, apply)


def voxel_center_param(cfg):
    """The origin snapped to its voxel's center, with the direction."""
    voxel_size = float(cfg.get("voxel_size", 1.0))

    def apply(rays):
        center = torch.round(rays[..., :3] / voxel_size) * voxel_size
        return torch.cat([center, rays[..., 3:6]], -1)

    return RayParam("voxel_center", 6, 6, apply)


def z_slice_param(cfg):
    """(x, y) at a fixed z plane, with the direction."""
    z_val = float(cfg.get("z", 0.0))

    def apply(rays):
        t = intersect_axis_plane(rays, z_val, 2)
        pts = rays[..., :2] + rays[..., 3:5] * t[..., None]
        return torch.cat([pts, rays[..., 3:6]], -1)

    return RayParam("z_slice", 6, 5, apply)


def contract_points_param(cfg):
    """A scene contraction on channels [start, end) of an inner param's
    output (reference nlf/param.py:258-295)."""
    inner = get_ray_param(dict(cfg["param"]))
    contract = get_contract(cfg.get("contract"))
    start = int(cfg.get("contract_start_channel", 0))
    end = int(cfg.get("contract_end_channel", 3))

    def apply(rays):
        p = inner.apply(rays)
        return torch.cat([p[..., :start],
                          contract.contract_points(p[..., start:end]),
                          p[..., end:]], -1)

    return RayParam("contract_points", inner.in_channels,
                    inner.out_channels, apply)


RAY_PARAMS = {
    "identity": identity_param, "take": take_param,
    "position": position_param, "two_plane": two_plane_param,
    "multi_plane": multi_plane_param,
    "two_plane_matrix": two_plane_matrix_param,
    "two_cylinder": two_cylinder_param, "ray_plus_time": ray_plus_time_param,
    "voxel_center": voxel_center_param, "z_slice": z_slice_param,
    "contract_points": contract_points_param, "pluecker": pluecker_param,
    "spherical": spherical_param, "xy": xy_param, "rays": rays_param,
    "pluecker_pos": pluecker_pos_param}


def get_ray_param(cfg):
    if cfg is None:
        return identity_param({})
    return RAY_PARAMS[cfg.get("fn", "identity")](cfg)
