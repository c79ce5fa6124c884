"""Ray-primitive intersect stages (port of hyperreel_tpu/models/intersect.py
IntersectStage, _make_anchor_schedule and the z-plane, voxel_grid,
deformable_voxel_grid, sphere, sphere_new, cylinder and
euclidean_distance_unified primitives; reference
nlf/intersect/base.py:142-259, nlf/intersect/z.py, nlf/intersect/voxel.py,
nlf/intersect/primitive.py).

`IntersectStage` is the stage every primitive shares: the predicted
z values against the anchors (undoing a sample-space contraction), the
primitive's distances, the near/far mask, the sort, the points and their
contraction. A primitive supplies its anchors' range and `intersect`.
Invalid samples keep distance 0 and are masked by the colour net, or,
under `invalid_sort_far` (the render-time compaction of
configs/presets.py with_compact_samples), take the far sentinel
FAR_SENTINEL, so that the sort puts them last and the valid samples form
a nearest-first prefix. The sort is values-only (the predicted fields
stay in prediction order).
Under `use_dataset_bounds` the anchors and the near default come from the
dataset's near/far (`_dataset_bounds`, which the embedding chain injects
from its dataset_info, models/embeddings.py).

The voxel grid takes three z values per sample (one plane per axis, the
three distances sorted with the rest), the deformable grid four (a normal
offset and the plane's distance). Of the radius primitives only the
one-channel-per-sample layout is ported: the sphere, cylinder and
sphere_new stages' blocked layouts (4 or 8 channels per sample: origin,
resize, raw offset, radius; the JAX stages' `_blocked`) raise.
"""

import numpy as np
import torch

from hyperreel_tpu_torch.models.activations import get_activation
from hyperreel_tpu_torch.ops.contract import get_contract
from hyperreel_tpu_torch.ops.intersect_math import (
    intersect_axis_plane, intersect_cylinder, intersect_plane,
    intersect_sphere, intersect_voxel_grid, min_sphere_radius,
    pluecker_closest_point, safe_norm)

_NOT_PORTED = ("weight_fn", "sort_outputs", "normalize", "residual_z",
               "residual_distance", "use_disparity", "use_local_prediction")

# the distance of an invalid sample under invalid_sort_far: beyond any
# scene distance, small enough that f32 math on it stays finite
# (hyperreel_tpu/models/intersect.py _FAR_SENTINEL)
FAR_SENTINEL = 1e9


def make_anchor_schedule(z_channels, cfg, contract, near=None, far=None):
    """linspace anchors [S, 1] and z_scale [1, 1] (reference
    nlf/intersect/z.py:26-71) from cfg's initial/end, or the primitive's
    near/far where it gives them, in contracted space when the contraction
    has contract_samples."""
    initial = float(cfg.get("initial", 0.0)) if near is None else near
    end = float(cfg.get("end", 1.0)) if far is None else far
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


def _dataset_bounds(cfg):
    return cfg.get("_dataset_bounds", (0.0, 1.0))


class IntersectStage:
    """The stage shared by the primitives (hyperreel_tpu IntersectStage):
    a subclass sets `anchor_range` (the anchors' near/far under
    use_dataset_bounds, None for cfg's initial/end) and `intersect(rays,
    z_vals)` -> distances [B, Z]."""

    def __init__(self, z_channels, cfg):
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
        # under use_dataset_bounds the mask's near defaults to the
        # dataset's near (reference nlf/intersect/base.py:87-91)
        if "near" in cfg:
            self.near = float(cfg["near"])
        elif cfg.get("use_dataset_bounds", False):
            self.near = float(_dataset_bounds(cfg)[0])
        else:
            self.near = 0.0
        self.far = float(cfg.get("far", float("inf")))
        self.mask_stop_iters = float(
            cfg.get("mask", {}).get("stop_iters", float("inf")))
        self.contract = get_contract(cfg.get("contract", None))
        if cfg.get("contract", {}).get("stop_iters") is not None:
            raise NotImplementedError(
                "a scheduled contraction is not ported (ROADMAP.md: long "
                "tail)")
        self.activation = get_activation(cfg.get("activation", "identity"))
        self.invalid_sort_far = bool(cfg.get("invalid_sort_far", False))
        self.samples, self.z_scale, self.initial, self.end = self.anchors()

    def anchors(self):
        """(samples, z_scale, initial, end): the linspace schedule over
        cfg's initial/end, or over `anchor_range` under
        use_dataset_bounds."""
        near, far = self.anchor_range() \
            if self.cfg.get("use_dataset_bounds", False) else (None, None)
        return make_anchor_schedule(self.z_channels, self.cfg, self.contract,
                                    near, far)

    def anchor_range(self):
        """(near, far) of the anchors under use_dataset_bounds; None
        keeps cfg's initial/end."""
        return None, None

    def intersect(self, rays, z_vals):
        raise NotImplementedError

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
        dists = self.intersect(rays, z_vals)
        x["weights"] = torch.ones_like(dists)[..., None]
        mask = (dists <= self.near) | (dists >= self.far)
        if ctx.it > self.mask_stop_iters:
            mask = torch.zeros_like(mask)
        # the sentinel stays after the sort: its point lands far outside
        # the aabb, so the colour net drops it, and the last valid
        # sample's delta (sentinel - d) saturates its alpha as the
        # reference's 1e10 last delta does (hyperreel_tpu/models/
        # intersect.py:228-235)
        far = FAR_SENTINEL if self.invalid_sort_far and self.sort else 0.0
        dists = torch.where(mask, torch.full_like(dists, far), dists)
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


class IntersectZPlane(IntersectStage):
    """Axis-aligned z-planes (reference nlf/intersect/z.py)."""

    def anchor_range(self):
        ds = _dataset_bounds(self.cfg)
        return -float(ds[0]), -float(ds[1])

    def intersect(self, rays, z_vals):
        planes = torch.clamp(z_vals, self.initial, self.end) \
            if self.clamp else z_vals
        return intersect_axis_plane(rays[:, None, :], planes, 2)


class _RadiusStage(IntersectStage):
    """A primitive with one radius per sample: its z width must be
    z_channels (the blocked layouts are not ported)."""

    def process_z_vals(self, z_vals):
        if z_vals.shape[-1] != self.z_channels:
            raise NotImplementedError(
                f"{self.cfg.get('type')}: {z_vals.shape[-1]} z values for "
                f"{self.z_channels} samples, a blocked layout (origin, "
                "resize, offset per sample), is not ported (ROADMAP.md: the "
                "blocked primitive layouts)")
        return super().process_z_vals(z_vals)

    def anchor_range(self):
        # the cfg's initial/end, else 1.5x the dataset bounds (reference
        # nlf/intersect/primitive.py:370-373)
        ds = _dataset_bounds(self.cfg)
        return (float(self.cfg["initial"]) if "initial" in self.cfg
                else float(ds[0]) * 1.5,
                float(self.cfg["end"]) if "end" in self.cfg
                else float(ds[1]) * 1.5)


class IntersectSphere(_RadiusStage):
    """Concentric spheres (reference nlf/intersect/primitive.py:366-441)."""

    def intersect(self, rays, z_vals):
        radii = torch.clamp(z_vals, self.initial, self.end) \
            if self.clamp else z_vals
        return intersect_sphere(rays[:, None, :], rays.new_zeros(3), radii)


class IntersectCylinder(_RadiusStage):
    """Concentric y-axis cylinders (reference
    nlf/intersect/primitive.py:181-255)."""

    def intersect(self, rays, z_vals):
        radii = torch.clamp(z_vals, self.initial, self.end) \
            if self.clamp else z_vals
        return intersect_cylinder(rays[:, None, :], rays.new_zeros(3), radii)


class IntersectSphereNew(_RadiusStage):
    """Concentric spheres of the rays resized per axis (`resize`), with a
    miss fallback (reference nlf/intersect/primitive.py:474-545): a sphere
    smaller than the one the ray touches gives the signed distance to the
    ray's closest point to the origin instead."""

    def __init__(self, z_channels, cfg):
        super().__init__(z_channels, cfg)
        self.resize = np.asarray(cfg.get("resize", [1.0, 1.0, 1.0]),
                                 np.float32)

    def anchor_range(self):
        # initial: near * 1.5 when outward facing, else -far * 1.5
        # (reference primitive.py:479-486)
        cfg, ds = self.cfg, _dataset_bounds(self.cfg)
        if "initial" in cfg:
            near = float(cfg["initial"])
        elif cfg.get("outward_facing", False):
            near = float(ds[0]) * 1.5
        else:
            near = -float(ds[1]) * 1.5
        return near, float(cfg["end"]) if "end" in cfg \
            else float(ds[1]) * 1.5

    def intersect(self, rays, z_vals):
        resize = rays.new_tensor(self.resize)
        r = torch.cat([rays[..., :3] * resize, rays[..., 3:6] * resize], -1)
        zero = rays.new_zeros(3)
        min_r = min_sphere_radius(r, zero)[:, None]
        hit = z_vals >= min_r
        t = intersect_sphere(r[:, None, :], zero,
                             torch.maximum(z_vals, min_r))
        p = pluecker_closest_point(r[..., :3], r[..., 3:6])
        d_unit = r[..., 3:6] / safe_norm(r[..., 3:6])
        t_base = ((p - r[..., :3]) * d_unit).sum(-1)[:, None]
        return torch.where(hit, t, t_base)


class IntersectEuclideanUnified(IntersectStage):
    """Distances predicted directly, offset by the signed distance from the
    ray origin to the ray's closest point to the world origin (reference
    nlf/intersect/primitive.py:126-179); the anchors span [-far, far]
    under use_dataset_bounds."""

    def anchor_range(self):
        cfg, ds = self.cfg, _dataset_bounds(self.cfg)
        return (float(cfg["initial"]) if "initial" in cfg
                else -float(ds[1]),
                float(cfg["end"]) if "end" in cfg else float(ds[1]))

    def intersect(self, rays, z_vals):
        rays_o, rays_d = rays[..., :3], rays[..., 3:6]
        diff = pluecker_closest_point(rays_o, rays_d) - rays_o
        off = torch.sign((rays_d * diff).sum(-1)) \
            * safe_norm(diff, keepdim=False)
        return z_vals + off[:, None]


class IntersectVoxelGrid(IntersectStage):
    """Axis-aligned planes in all three dims, z_channels / 3 per axis
    (reference nlf/intersect/voxel.py:19-112): per axis a z/3-point
    linspace of anchors from cfg's initial/end (3-vectors; under
    use_dataset_bounds they default to the dataset's bbox, `_dataset_bbox`,
    times `fac`), each axis its own z_scale; `outward_facing` flips each
    axis's value by the sign of the direction, `max_axis` keeps only the
    dominant direction axis's planes."""

    def __init__(self, z_channels, cfg):
        if z_channels % 3:
            raise ValueError(f"voxel_grid: {z_channels} z channels, not a "
                             "multiple of 3")
        self.outward_facing = bool(cfg.get("outward_facing", False))
        self.max_axis = bool(cfg.get("max_axis", False))
        super().__init__(z_channels, cfg)

    def anchors(self):
        cfg, n = self.cfg, self.z_channels // 3
        if cfg.get("use_dataset_bounds", False) and "_dataset_bbox" in cfg:
            fac = float(cfg.get("fac", 1.0))
            d_initial, d_end = (np.asarray(b, np.float32) * fac
                                for b in cfg["_dataset_bbox"])
        else:
            d_initial, d_end = [0.0] * 3, [1.0] * 3
        initial, end = (np.broadcast_to(np.asarray(
            cfg.get(key, d), np.float32).reshape(-1), (3,)).copy()
            for key, d in (("initial", d_initial), ("end", d_end)))
        if self.contract.contract_samples:
            initial, end = (self.contract.contract_distance(
                torch.from_numpy(v)).numpy() for v in (initial, end))
        samples = np.stack([np.linspace(initial[d], end[d], n)
                            for d in range(3)], -1).astype(np.float32)
        if "z_scale" in cfg:
            z_scale = np.asarray(cfg["z_scale"], np.float32)
        elif n > 1:
            z_scale = np.abs(samples[1] - samples[0])
        else:
            z_scale = np.ones(3, np.float32)
        z_scale = np.where(z_scale == 0.0, 1.0, z_scale).astype(np.float32)
        return samples, z_scale, initial, end

    def intersect(self, rays, z_vals):
        B = z_vals.shape[0]
        vals = z_vals.reshape(B, -1, 3)
        if self.outward_facing:
            vals = vals * torch.sign(rays[..., 3:6])[:, None, :]
        dists = intersect_voxel_grid(rays[:, None, :], rays.new_zeros(3),
                                     vals)
        if self.max_axis:
            d = rays[..., 3:6].abs()
            keep = d >= d.amax(-1, keepdim=True) - 1e-8
            dists = torch.where(keep[:, None, :].expand_as(vals).reshape(
                B, -1), dists, 0.0)
        return dists


class IntersectDeformableVoxelGrid(IntersectStage):
    """Planes of learned normals (reference nlf/intersect/voxel.py:115-215):
    four z values per sample, a normal offset (3) and the plane's distance
    (1); the anchors apply to the distance (z_channels / num_axes per
    axis of start_normal), the normal is start_normal + normal_scale_factor
    * offset, normalised."""

    def __init__(self, z_channels, cfg):
        self.start_normal = np.asarray(
            cfg.get("start_normal", [[1.0, 0, 0], [0, 1.0, 0], [0, 0, 1.0]]),
            np.float32)
        self.num_axes = len(self.start_normal)
        self.normal_scale_factor = float(cfg.get("normal_scale_factor", 0.1))
        super().__init__(z_channels, cfg)

    def anchors(self):
        cfg, n_ax = self.cfg, self.num_axes
        zc = self.z_channels // n_ax
        initial = np.asarray(cfg.get("initial", [0.0] * n_ax))
        end = np.asarray(cfg.get("end", [1.0] * n_ax))
        samples = np.stack([np.linspace(initial[d], end[d], zc)
                            for d in range(n_ax)], -1).reshape(
                                -1, 1).astype(np.float32)
        if "z_scale" in cfg:
            z_scale = np.asarray(cfg["z_scale"], np.float32)
        elif zc > 1:
            z_scale = np.abs(samples[1] - samples[0])
        else:
            z_scale = np.ones((n_ax,), np.float32)
        z_scale = np.where(z_scale == 0.0, 1.0, z_scale)
        return samples, np.asarray(z_scale, np.float32).reshape(-1, 1), \
            initial, end

    def process_z_vals(self, z_vals):
        B = z_vals.shape[0]
        z4 = z_vals.reshape(B, -1, 4)
        d = super().process_z_vals(z4[..., -1])
        return torch.cat([z4[..., :3], d[..., None]], -1).reshape(B, -1)

    def intersect(self, rays, z_vals):
        B = z_vals.shape[0]
        z4 = z_vals.reshape(B, -1, 4)
        offset = z4[..., :3].reshape(B, -1, self.num_axes, 3)
        normal = (offset * self.normal_scale_factor
                  + rays.new_tensor(self.start_normal)).reshape(B, -1, 3)
        normal = normal / safe_norm(normal)
        return intersect_plane(rays[:, None, :], normal, z4[..., -1])


INTERSECTS = {"z_plane": IntersectZPlane, "sphere": IntersectSphere,
              "sphere_new": IntersectSphereNew,
              "cylinder": IntersectCylinder,
              "euclidean_distance_unified": IntersectEuclideanUnified,
              "voxel_grid": IntersectVoxelGrid,
              "deformable_voxel_grid": IntersectDeformableVoxelGrid}


def build_intersect(z_channels, cfg):
    kind = cfg.get("type")
    if kind not in INTERSECTS:
        raise NotImplementedError(
            f"intersect {kind!r} is not ported (ROADMAP.md: long tail)")
    return INTERSECTS[kind](z_channels, cfg)
