"""Scene contraction (port of the identity and mipnerf contractions of
hyperreel_tpu/ops/contract.py; reference nlf/contract.py). The other
contractions, and a mipnerf distance activation, raise. Under
`use_dataset_bounds` mipnerf's radii default to 1.5x the dataset's depth
range (`_dataset_depth_range`, which the embedding chain injects from its
dataset_info, models/embeddings.py).

`contract_samples=True` makes the z-plane intersect place its linspace
anchors in contracted space and invert the predicted z back to metric
distance (reference nlf/intersect/base.py:128-140).

Each function mirrors the JAX package's operation order, which differs
between `contract_points` ((p / d) * (2 - t), the general path) and
`contract_rows` (p * ((2 - t) / d), the fused path's pack-build kernel);
the pack-build kernel (csrc/pack_build.cu) repeats `contract_rows` and
`inverse_contract_distance` with the constants of `MipnerfContract`.
"""

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class IdentityContract:
    name: str = "identity"
    contract_samples: bool = False

    def inverse_contract_distance(self, distance):
        return distance

    def contract_distance(self, distance):
        return distance


def _safe_norm(v):
    """sqrt(max(sum v^2, 1e-24)) over the last axis, kept."""
    return torch.sqrt(torch.clamp_min((v * v).sum(-1, keepdim=True), 1e-24))


@dataclass(frozen=True)
class MipnerfContract:
    """Piecewise linear -> 1/x contraction to radius 2 (reference
    nlf/contract.py:112-192), with the identity distance activation."""
    start_r: float
    end_r: float
    start_d: float
    end_d: float
    contract_samples: bool = False
    name: str = "mipnerf"

    @property
    def inv_end_r(self):
        return self.start_r / self.end_r if math.isfinite(self.end_r) \
            else 0.0

    @property
    def r_scale(self):
        return 1.0 / (1.0 - self.inv_end_r)

    @property
    def inv_end_d(self):
        return self.start_d / self.end_d if math.isfinite(self.end_d) \
            else 0.0

    @property
    def d_scale(self):
        return 1.0 / (1.0 - self.inv_end_d)

    def inverse_contract_distance(self, distance):
        distance = (distance / 2.0) * 2.0
        distance = torch.clamp(distance, -2.0, 2.0)
        t = 2.0 - distance.abs()
        inverse_distance = t / self.d_scale + self.inv_end_d
        return torch.where(distance.abs() < 1.0, distance,
                           torch.sign(distance) * (1.0 / inverse_distance)) \
            * self.start_d

    def contract_distance(self, distance):
        distance = distance / self.start_d
        inverse_distance = 1.0 / torch.clamp_min(distance.abs(), 1e-12)
        t = (inverse_distance - self.inv_end_d) * self.d_scale
        distance = torch.where(distance.abs() < 1.0, distance,
                               torch.sign(distance) * (2.0 - t))
        return (distance / 2.0) * 2.0

    def contract_points(self, points):
        """[..., 3] points (general path order)."""
        points = points / self.start_r
        distance = _safe_norm(points)
        inverse_distance = 1.0 / torch.clamp_min(distance, 1e-12)
        t = (inverse_distance - self.inv_end_r) * self.r_scale
        return torch.where(distance < 1.0, points,
                           (points / torch.clamp_min(distance, 1e-12))
                           * (2.0 - t))

    def contract_points_and_distance(self, rays_o, points):
        """(contracted points [B, S, 3], their distance from the contracted
        origin [B, S, 1]) (reference nlf/contract.py:43-50)."""
        o_c = self.contract_points(rays_o)
        p_c = self.contract_points(points)
        return p_c, _safe_norm(p_c - o_c[..., None, :])

    def contract_rows(self, px, py, pz):
        """contract_points on three same-shape rows, in the op order of the
        fused path (hyperreel_tpu/ops/contract.py contract_rows)."""
        px, py, pz = px / self.start_r, py / self.start_r, pz / self.start_r
        distance = torch.sqrt(torch.clamp_min(px * px + py * py + pz * pz,
                                              1e-24))
        inverse_distance = 1.0 / torch.clamp_min(distance, 1e-12)
        t = (inverse_distance - self.inv_end_r) * self.r_scale
        scale = torch.where(distance < 1.0, torch.ones_like(distance),
                            (2.0 - t) / torch.clamp_min(distance, 1e-12))
        return px * scale, py * scale, pz * scale


def mipnerf_contract(cfg):
    if cfg.get("distance_activation"):
        raise NotImplementedError(
            "a mipnerf distance activation is not ported (ROADMAP.md: long "
            "tail)")
    if cfg.get("use_dataset_bounds") and "_dataset_depth_range" in cfg:
        # reference nlf/contract.py:121-127
        dr = cfg["_dataset_depth_range"]
        start_r = float(cfg.get("contract_start_radius",
                                max(float(dr[0]) * 1.5, 1.0)))
        end_r = float(cfg.get("contract_end_radius", float(dr[1]) * 1.5))
    else:
        start_r = float(cfg.get("contract_start_radius", 1.0))
        end_r = float(cfg.get("contract_end_radius", float("inf")))
    return MipnerfContract(
        start_r=start_r, end_r=end_r,
        start_d=float(cfg.get("contract_start_distance", start_r)),
        end_d=float(cfg.get("contract_end_distance", end_r)),
        contract_samples=bool(cfg.get("contract_samples", False)))


def get_contract(cfg):
    kind = (cfg or {}).get("type", "identity")
    if kind == "identity":
        return IdentityContract(
            contract_samples=bool((cfg or {}).get("contract_samples", False)))
    if kind == "mipnerf":
        return mipnerf_contract(cfg)
    raise NotImplementedError(
        f"contraction {kind!r} is not ported (ROADMAP.md: the other static "
        "multi-axis presets)")
