"""Ray parameterizations (port of identity, two_plane and pluecker from
hyperreel_tpu/models/ray_param.py; reference nlf/param.py)."""

from dataclasses import dataclass
from typing import Callable

import torch

from hyperreel_tpu_torch.ops.intersect_math import intersect_axis_plane


@dataclass
class RayParam:
    name: str
    in_channels: int
    out_channels: int
    apply: Callable


def identity_param(cfg):
    n = int(cfg.get("in_channels", cfg.get("n_dims", 6)))
    return RayParam("identity", n, int(cfg.get("n_dims", n)), lambda x: x)


def two_plane_param(cfg):
    """(x1, y1, x2, y2) where the ray crosses z=near and z=far."""
    near = float(cfg.get("near", -1.0))
    far = float(cfg.get("far", 0.0))
    origin = [float(v) for v in cfg.get("origin", [0.0, 0.0, 0.0])]
    st_mult = float(cfg.get("st_multiplier", 1.0))
    uv_mult = float(cfg.get("uv_multiplier", 1.0))
    if cfg.get("use_local_param", False):
        raise NotImplementedError(
            "two_plane use_local_param is not ported (ROADMAP.md: long tail)")

    # the origin as a tensor per device and dtype it meets: a
    # host-to-device copy per call would synchronise the host with the card
    origin_on = {}

    def apply(rays):
        key = (rays.device, rays.dtype)
        o = origin_on.get(key)
        if o is None:
            o = origin_on[key] = rays.new_tensor(origin)
        rays_o = rays[..., :3] - o
        rays_d = rays[..., 3:6]
        r = torch.cat([rays_o, rays_d], -1)
        t1 = intersect_axis_plane(r, near, 2)
        t2 = intersect_axis_plane(r, far, 2)
        p1 = (rays_o[..., :2] + rays_d[..., :2] * t1[..., None]) * st_mult
        p2 = (rays_o[..., :2] + rays_d[..., :2] * t2[..., None]) * uv_mult
        return torch.cat([p1, p2], -1)

    return RayParam("two_plane", 6, int(cfg.get("n_dims", 4)), apply)


def pluecker_param(cfg):
    """(d, o x d) with the unit direction d (reference nlf/param.py:
    223-257)."""
    d_mult = float(cfg.get("direction_multiplier", 1.0))
    m_mult = float(cfg.get("moment_multiplier", 1.0))
    origin = [float(v) for v in cfg.get("origin", [0.0, 0.0, 0.0])]
    if cfg.get("use_local_param", False):
        raise NotImplementedError(
            "pluecker use_local_param is not ported (ROADMAP.md: long tail)")
    origin_on = {}

    def apply(rays):
        key = (rays.device, rays.dtype)
        o = origin_on.get(key)
        if o is None:
            o = origin_on[key] = rays.new_tensor(origin)
        rays_o = rays[..., :3] - o
        d = rays[..., 3:6]
        d = d / torch.sqrt(torch.clamp_min((d * d).sum(-1, keepdim=True),
                                           1e-24))
        m = torch.linalg.cross(rays_o, d, dim=-1)
        return torch.cat([d * d_mult, m * m_mult], -1)

    return RayParam("pluecker", 6, int(cfg.get("n_dims", 6)), apply)


def get_ray_param(cfg):
    fn = (cfg or {}).get("fn", "identity")
    if fn == "identity":
        return identity_param(cfg or {})
    if fn == "two_plane":
        return two_plane_param(cfg)
    if fn == "pluecker":
        return pluecker_param(cfg)
    raise NotImplementedError(
        f"ray parameterization {fn!r} is not ported (ROADMAP.md: long "
        "tail)")
