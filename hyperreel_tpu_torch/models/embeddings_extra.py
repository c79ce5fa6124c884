"""Embedding stages beyond the z-plane chains' own (port of
hyperreel_tpu/models/embeddings_extra.py): the sample-count stages
`generate_samples` and `select_points` (reference
nlf/embedding/point.py:402-480) and `reflect` (point.py:673-738). The
module's other stages are not ported (ROADMAP.md: long tail).
"""

import torch

from hyperreel_tpu_torch.ops.intersect_math import safe_norm


class GenerateNumSamplesEmbedding:
    """The sample count n of a step (hyperreel_tpu
    GenerateNumSamplesEmbedding; reference nlf/embedding/point.py:402-449):
    in training round(u * (hi - lo) + lo) for the draw "num_samples" (a
    0-d U[0, 1); the JAX package's fold_in(rng, 404)) and sample_range
    (lo, hi), at eval `inference_samples`. n rides along as a ray column
    (appended after the prediction and the intersect, which read the
    columns before it) and as the state's "num_samples" (a 0-d f32 tensor),
    with "total_samples" and, at eval, "inference_samples_static" (host
    ints), which select_points reads."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.sample_range = tuple(cfg["sample_range"])
        self.inference_samples = int(cfg["inference_samples"])
        self.total_samples = int(cfg["total_samples"])
        self.rays_name = cfg.get("rays_name", "rays")

    def init(self, gen, device):
        return {}

    def apply(self, params, x, ctx, render_kwargs=None):
        rays = x[self.rays_name]
        if ctx.training:
            lo, hi = self.sample_range
            u = ctx.uniform("num_samples", (), rays.device)
            n = torch.round(u * (hi - lo) + lo)
        else:
            n = torch.tensor(float(self.inference_samples),
                             device=rays.device)
            x["inference_samples_static"] = self.inference_samples
        x["num_samples"] = n
        x["total_samples"] = self.total_samples
        x[self.rays_name] = torch.cat([rays, torch.ones_like(rays[..., :1])
                                       * n], -1)
        return x


def _per_sample(x, S):
    """The keys of the state's per-sample fields: each tensor whose axis 1
    has the S samples and that has a channel axis."""
    return [k for k, v in x.items()
            if torch.is_tensor(v) and v.dim() >= 3 and v.shape[1] == S]


class SelectPointsEmbedding:
    """Keep a subset of the samples in every per-sample field (hyperreel_tpu
    SelectPointsEmbedding; reference nlf/embedding/point.py:452-480).

    At eval, and in training with `always_slice` and `inference_samples`:
    n = `inference_samples`, else a generate_samples stage's
    "inference_samples_static"; without one, or with n >= S, the state
    passes unchanged;
      mode="stride" (the reference's arrangement; any mode but "first")
        keeps every (S // n)-th sample, v[:, ::S // n];
      mode="first" keeps the first n, v[:, :n]: after an intersect with
        invalid_sort_far the n nearest valid samples of the sorted
        distances (configs/presets.py with_compact_samples). The fields
        other than the distances stay in prediction order, so sorted
        position j pairs with prediction row j, as in the JAX package.

    In training otherwise, where a generate_samples stage drew n: every
    round(total / n)-th sample is kept at the state's S samples, each
    sample replaced by the next kept one (clamped to the last kept one), a
    gather: the duplicates share their distances, so their deltas are 0
    and the composite is the one over the kept samples, the reference's
    slice. Without a drawn n the state passes unchanged.
    """

    def __init__(self, cfg):
        self.cfg = cfg
        isamp = cfg.get("inference_samples")
        self.inference_samples = int(isamp) if isamp else None
        self.always_slice = bool(cfg.get("always_slice", False))
        self.mode = cfg.get("mode", "stride")

    def init(self, gen, device):
        return {}

    def apply(self, params, x, ctx, render_kwargs=None):
        S = x["points"].shape[1]
        if not ctx.training or (self.always_slice and self.inference_samples):
            n = self.inference_samples or x.get("inference_samples_static")
            if not n or n >= S:
                return x
            sel = slice(None, n) if self.mode == "first" \
                else slice(None, None, max(S // n, 1))
            for k in _per_sample(x, S):
                x[k] = x[k][:, sel]
            return x
        if "num_samples" not in x:
            return x
        n = x["num_samples"]
        total = x.get("total_samples", S)
        # the index of each sample's replacement, in f32 as the JAX
        # package computes it
        stride = torch.clamp_min(torch.round(total / torch.clamp_min(n, 1.0)),
                                 1.0)
        j = torch.arange(S, dtype=torch.float32, device=n.device)
        last_kept = torch.floor((S - 1) / stride) * stride
        idx = torch.minimum(torch.ceil(j / stride) * stride,
                            last_kept).long()
        for k in _per_sample(x, S):
            x[k] = x[k].index_select(1, idx.to(x[k].device))
        return x


class ReflectEmbedding:
    """Reflected view directions for RefNeRF-style shading (hyperreel_tpu
    ReflectEmbedding; reference nlf/embedding/point.py:673-738): the
    predicted normal (minus the view direction under `direction_init`, its
    z minus 1 under `forward_facing`) normalised; the view direction
    reflected about it; the points marched |ref_distance| along the
    reflection where the state has one; the reflection plus a predicted
    offset, normalised, where the state has one. The view direction is the
    state's `in_direction_field`, else each ray's direction."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.in_points_field = cfg.get("in_points_field", "points")
        self.in_direction_field = cfg.get("in_direction_field", "viewdirs")
        self.in_normal_field = cfg.get("in_normal_field", "normal")
        self.in_distance_field = cfg.get("in_distance_field",
                                         "ref_distance")
        self.direction_offset_field = cfg.get("direction_offset_field",
                                              "ref_viewdirs_offset")
        self.out_points_field = cfg.get("out_points_field", "ref_points")
        self.out_direction_field = cfg.get("out_direction_field",
                                           "ref_viewdirs")
        self.out_normal_field = cfg.get("out_normal_field", "normal")
        self.forward_facing = bool(cfg.get("forward_facing", False))
        self.direction_init = bool(cfg.get("direction_init", False))

    def init(self, gen, device):
        return {}

    def apply(self, params, x, ctx, render_kwargs=None):
        rays = x["rays"]
        points = x[self.in_points_field]
        B, S = points.shape[:2]
        dirs = x[self.in_direction_field] if self.in_direction_field in x \
            else rays[:, None, 3:6].expand(B, S, 3)
        normal = x[self.in_normal_field]
        if self.forward_facing:
            normal = torch.cat([normal[..., :2], normal[..., 2:] - 1.0], -1)
        elif self.direction_init:
            normal = normal - dirs
        normal = normal / safe_norm(normal)
        x[self.out_normal_field] = normal
        refl = dirs - 2.0 * (dirs * normal).sum(-1, keepdim=True) * normal
        if self.in_distance_field in x:
            points = points + x[self.in_distance_field].reshape(
                B, S, 1).abs() * refl
        if self.direction_offset_field in x:
            refl = refl + x[self.direction_offset_field].reshape(B, S, 3)
            refl = refl / safe_norm(refl)
        x[self.out_points_field] = points
        x[self.out_direction_field] = refl
        return x
