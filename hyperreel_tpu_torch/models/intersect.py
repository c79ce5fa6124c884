"""Z-plane intersect stage (port of hyperreel_tpu/models/intersect.py
IntersectStage + IntersectZPlane + _make_anchor_schedule; reference
nlf/intersect/base.py:142-259 and nlf/intersect/z.py).

Invalid samples keep distance 0 and are masked by the colour net; the
sort is values-only (the predicted fields stay in prediction order).
"""

import numpy as np
import torch

from hyperreel_tpu_torch.models.activations import get_activation
from hyperreel_tpu_torch.ops.contract import get_contract
from hyperreel_tpu_torch.ops.intersect_math import intersect_axis_plane

_NOT_PORTED = ("weight_fn", "sort_outputs", "invalid_sort_far", "normalize",
               "residual_z", "residual_distance", "use_disparity",
               "use_local_prediction", "use_dataset_bounds")


def make_anchor_schedule(z_channels, cfg, contract):
    """linspace anchors [S, 1] and z_scale [1, 1] (reference
    nlf/intersect/z.py:26-71), in contracted space when the contraction
    has contract_samples."""
    initial = float(cfg.get("initial", 0.0))
    end = float(cfg.get("end", 1.0))
    if contract.contract_samples:
        initial, end = (float(contract.contract_distance(
            torch.tensor(v, dtype=torch.float32))) for v in (initial, end))
    num_repeat = int(cfg.get("num_repeat", 1))
    n = z_channels // num_repeat
    samples = np.linspace(initial, end, n)
    samples = np.tile(samples, num_repeat).reshape(-1, 1).astype(np.float32)
    if z_channels > 1:
        if "z_scale" in cfg:
            z_scale = float(cfg["z_scale"])
        elif "num_samples_for_scale" in cfg:
            z_scale = abs(samples[1, 0] - samples[0, 0]) * (
                z_channels / float(cfg["num_samples_for_scale"]))
        else:
            z_scale = abs(samples[1, 0] - samples[0, 0])
    else:
        z_scale = float(cfg.get("z_scale", 1.0))
    return samples, np.asarray(z_scale, np.float32).reshape(-1, 1), \
        initial, end


class IntersectZPlane:
    def __init__(self, z_channels, cfg):
        if cfg.get("type") != "z_plane":
            raise NotImplementedError(
                f"intersect {cfg.get('type')!r} is not ported "
                "(ROADMAP.md: K5/K6 and the other net families)")
        for key in _NOT_PORTED:
            if cfg.get(key):
                raise NotImplementedError(
                    f"intersect option {key!r} is not ported "
                    "(ROADMAP.md: long tail)")
        self.z_channels = z_channels
        self.cfg = cfg
        self.in_density_field = cfg.get("in_density_field", "sigma")
        self.out_points = cfg.get("out_points", None)
        self.out_distance = cfg.get("out_distance", None)
        self.sort = bool(cfg.get("sort", False))
        self.clamp = bool(cfg.get("clamp", False))
        self.use_sigma = bool(cfg.get("use_sigma", False))
        self.origin = np.asarray(cfg.get("origin", [0.0, 0.0, 0.0]),
                                 np.float32)
        self.near = float(cfg.get("near", 0.0))
        self.far = float(cfg.get("far", float("inf")))
        self.mask_stop_iters = float(
            cfg.get("mask", {}).get("stop_iters", float("inf")))
        self.contract = get_contract(cfg.get("contract", None))
        if cfg.get("contract", {}).get("stop_iters") is not None:
            raise NotImplementedError(
                "a scheduled contraction is not ported (ROADMAP.md: long "
                "tail)")
        self.activation = get_activation(cfg.get("activation", "identity"))
        self.samples, self.z_scale, self.initial, self.end = \
            make_anchor_schedule(z_channels, cfg, self.contract)

    def process_z_vals(self, z_vals):
        """Scale and shift against the anchors, then undo the sample-space
        contraction (reference nlf/intersect/base.py:128-140)."""
        B = z_vals.shape[0]
        z = z_vals.reshape(B, -1, self.z_scale.shape[-1])
        z = z * torch.as_tensor(self.z_scale, device=z.device)[None] \
            + torch.as_tensor(self.samples, device=z.device)[None]
        z = z.reshape(B, -1)
        if self.contract.contract_samples:
            z = self.contract.inverse_contract_distance(z)
        return z

    def apply(self, rays, x, ctx):
        rays = torch.cat([rays[..., :3] - rays.new_tensor(self.origin),
                          rays[..., 3:6]], -1)
        B = rays.shape[0]
        z_vals = x["z_vals"].reshape(B, -1)
        if self.use_sigma and self.in_density_field in x:
            sigma = x[self.in_density_field].reshape(B, -1)
        else:
            sigma = torch.zeros_like(z_vals)
        z3 = z_vals.reshape(B, sigma.shape[1], -1)
        z3 = self.activation(z3, ctx) * (1.0 - sigma[..., None])
        z_vals = self.process_z_vals(z3.reshape(B, -1))
        planes = torch.clamp(z_vals, self.initial, self.end) \
            if self.clamp else z_vals
        dists = intersect_axis_plane(rays[:, None, :], planes, 2)
        x["weights"] = torch.ones_like(dists)[..., None]
        mask = (dists <= self.near) | (dists >= self.far)
        if ctx.it > self.mask_stop_iters:
            mask = torch.zeros_like(mask)
        dists = torch.where(mask, torch.zeros_like(dists), dists)
        if self.sort:
            dists = torch.sort(dists, dim=-1).values      # values only
        dists = dists[..., None]
        points = rays[..., None, :3] + rays[..., None, 3:6] * dists
        if self.contract.name != "identity":
            # contract the points and measure the distances in contracted
            # space (reference nlf/intersect/base.py:242-246)
            points, dists_c = self.contract.contract_points_and_distance(
                rays[..., :3], points)
            dists = torch.where(dists == 0.0, torch.zeros_like(dists),
                                dists_c)
        if self.out_points is not None:
            x[self.out_points] = points
        if self.out_distance is not None:
            x[self.out_distance] = dists
        x["points"] = points
        x["distances"] = dists
        x["z_vals"] = z_vals
        return x


def build_intersect(z_channels, cfg):
    return IntersectZPlane(z_channels, cfg)
