"""Embedding stages of the flagship chain (port of
hyperreel_tpu/models/embeddings.py; reference nlf/embedding/).

Each stage has `.init(gen, device) -> params` and
`.apply(params, x, ctx, render_kwargs) -> x` over a dict of tensors. The
ported stages are ray_prediction (with its ray outputs), ray_intersect,
point_prediction, point_density, advect_points (spatial and angular
flow), point_offset, add_point_outputs, extract_fields, color_transform,
and generate_samples, select_points and reflect
(models/embeddings_extra.py), at eval and in training, with
the per-stage wait/stop gating of the chain; any other stage type raises
NotImplementedError (ROADMAP.md: long tail). Each stage's `group` names
the optimizer group of its params (the prediction net's config may name
one: the flagship's "embedding_impl").
"""

from typing import List

import numpy as np
import torch

from hyperreel_tpu_torch.models.activations import get_activation
from hyperreel_tpu_torch.models.embeddings_extra import (
    GenerateNumSamplesEmbedding, ReflectEmbedding, SelectPointsEmbedding)
from hyperreel_tpu_torch.models.intersect import build_intersect
from hyperreel_tpu_torch.models.mlp import build_net
from hyperreel_tpu_torch.models.pe import get_pe
from hyperreel_tpu_torch.models.ray_param import get_ray_param
from hyperreel_tpu_torch.ops.rotation import axis_angle_to_matrix


class RayPredictionEmbedding:
    """The sample-prediction network (reference nlf/embedding/ray.py:
    213-363): parameterize and encode channel ranges of the ray, run one
    MLP, split its output into per-sample fields with their activations."""

    def __init__(self, cfg, compute_dtype=None):
        self.cfg = cfg
        self.group = cfg.get("net", {}).get("group",
                                            cfg.get("group", "embedding"))
        self.rays_name = cfg.get("rays_name", "rays")
        self.param_ranges, self.params_fns, self.pes = [], [], []
        in_channels = 0
        for pcfg in cfg["params"].values():
            start, end = int(pcfg["start"]), int(pcfg["end"])
            self.param_ranges.append((start, end))
            param_cfg = dict(pcfg["param"])
            param_cfg.setdefault("in_channels", end - start)
            rp = get_ray_param(param_cfg)
            self.params_fns.append(rp)
            pe = get_pe(rp.out_channels, pcfg.get("pe", None))
            self.pes.append(pe)
            in_channels += pe.out_channels
        self.in_channels = in_channels
        self.z_channels = int(cfg["z_channels"])
        outputs = cfg["outputs"]
        self.output_names = list(outputs.keys())
        self.output_shapes = [int(outputs[k]["channels"])
                              for k in self.output_names]
        self.preds_per_z = sum(self.output_shapes)
        # per-ray fields after the per-sample ones in the MLP's output
        # (JAX embeddings.py:73-99, 127-134)
        ray_outputs = cfg.get("ray_outputs") or {}
        self.ray_output_names = list(ray_outputs.keys())
        self.ray_output_shapes = [int(ray_outputs[k]["channels"])
                                  for k in self.ray_output_names]
        self.total_point_out = self.z_channels * self.preds_per_z
        self.total_ray_out = sum(self.ray_output_shapes)
        # the reference shrinks depth by 2 and drops linear_last here
        # (nlf/embedding/ray.py:283-285)
        net_cfg = dict(cfg["net"])
        if "depth" in net_cfg:
            net_cfg["depth"] = int(net_cfg["depth"]) - 2
            net_cfg["linear_last"] = False
        self.net = build_net(self.in_channels,
                             self.total_point_out + self.total_ray_out,
                             net_cfg, compute_dtype=compute_dtype)
        self.activations = [get_activation(outputs[k].get("activation",
                                                          "identity"))
                            for k in self.output_names]
        self.ray_activations = [
            get_activation(ray_outputs[k].get("activation", "identity"))
            for k in self.ray_output_names]

    def init(self, gen, device):
        return {"net": self.net.init(gen, device)}

    def net_input(self, rays, ctx):
        """[B, in_channels] encoded ray parameters."""
        return torch.cat([pe.apply(rp.apply(rays[:, a:b]), ctx)
                          for (a, b), rp, pe in zip(self.param_ranges,
                                                    self.params_fns,
                                                    self.pes)], -1)

    def apply(self, params, x, ctx, render_kwargs=None):
        rays = x[self.rays_name]
        out = self.net.apply(params["net"], self.net_input(rays, ctx), ctx)
        point_out = out[..., :self.total_point_out].reshape(
            rays.shape[0], self.z_channels, self.preds_per_z)
        off = 0
        for name, width, act in zip(self.output_names, self.output_shapes,
                                    self.activations):
            x[name] = act(point_out[..., off:off + width], ctx)
            off += width
        off = self.total_point_out
        for name, width, act in zip(self.ray_output_names,
                                    self.ray_output_shapes,
                                    self.ray_activations):
            x[name] = act(out[..., off:off + width], ctx)
            off += width
        return x


class PointPredictionEmbedding:
    """The per-sample MLP of the cascaded chains (hyperreel_tpu
    PointPredictionEmbedding; reference nlf/embedding/point.py:39-218).
    The named per-sample inputs (`inputs`: viewdirs, origins and times
    from the rays, anything else from the state, cut to its width) are
    concatenated in declaration order and the `params` ranges index that
    concatenation, so the cascaded presets' `time: 3:4` reads viewdirs.x,
    as the reference does. Each of the in_z_channels input samples emits
    out_z_channels / in_z_channels output samples (`expand_factor`); an
    output marked `residual` adds to the state's field of that name. The
    net has depth - 2 layers and no linear_last, as the ray prediction's;
    its params are in the "embedding" group (the JAX stage reads no
    group from the config)."""

    group = "embedding"

    def __init__(self, cfg, compute_dtype=None):
        self.cfg = cfg
        self.rays_name = cfg.get("rays_name", "rays")
        self.inputs = dict(cfg.get("inputs", {"points": 3}))
        self.in_fields = []
        in_channels = 0
        for pcfg in cfg["params"].values():
            start, end = int(pcfg["start"]), int(pcfg["end"])
            param_cfg = dict(pcfg.get("param", {"fn": "identity"}))
            param_cfg.setdefault("in_channels", end - start)
            rp = get_ray_param(param_cfg)
            pe = get_pe(rp.out_channels, pcfg.get("pe", None))
            self.in_fields.append((start, end, rp, pe))
            in_channels += pe.out_channels
        self.in_channels = in_channels
        outputs = cfg["outputs"]
        self.output_names = list(outputs.keys())
        self.output_shapes = [int(outputs[k]["channels"])
                              for k in self.output_names]
        self.residual = {k: bool(outputs[k].get("residual", False))
                         for k in self.output_names}
        self.activations = [get_activation(outputs[k].get("activation",
                                                          "identity"))
                            for k in self.output_names]
        self.out_channels = sum(self.output_shapes)
        in_z = int(cfg.get("in_z_channels", 0))
        out_z = int(cfg.get("out_z_channels", 0))
        self.expand_factor = max(out_z // in_z, 1) if in_z and out_z else 1
        net_cfg = dict(cfg["net"])
        if "depth" in net_cfg:
            net_cfg["depth"] = int(net_cfg["depth"]) - 2
            net_cfg["linear_last"] = False
        self.net = build_net(self.in_channels,
                             self.out_channels * self.expand_factor,
                             net_cfg, compute_dtype=compute_dtype)

    def init(self, gen, device):
        return {"net": self.net.init(gen, device)}

    def _field(self, x, name, width, B, S):
        rays = x[self.rays_name]
        if name == "viewdirs":
            return rays[:, None, 3:6].expand(B, S, 3)
        if name == "origins":
            return rays[:, None, 0:3].expand(B, S, 3)
        if name in ("times", "base_times"):
            return rays[:, None, -1:].expand(B, S, 1)
        return x[name][..., :width]

    def apply(self, params, x, ctx, render_kwargs=None):
        B, S = x["points"].shape[:2]
        inputs = torch.cat([self._field(x, name, width, B, S)
                            for name, width in self.inputs.items()], -1)
        net_in = torch.cat([
            pe.apply(rp.apply(inputs[..., start:end].reshape(B * S, -1)),
                     ctx)
            for start, end, rp, pe in self.in_fields], -1)
        out = self.net.apply(params["net"], net_in, ctx).reshape(
            B, S * self.expand_factor, -1)
        off = 0
        for name, width, act in zip(self.output_names, self.output_shapes,
                                    self.activations):
            val = act(out[..., off:off + width], ctx)
            x[name] = x[name] + val if self.residual[name] and name in x \
                else val
            off += width
        return x


class PointDensityEmbedding:
    """sigma from the last channel of `in_field`, act(v + shift), faded in
    over a linear window (hyperreel_tpu PointDensityEmbedding; reference
    nlf/embedding/point.py:282-335): w = clip((it - window_start) /
    window_iters, 0, 1), or 0 before window_start and 1 from it when
    window_iters is 0; out = sigma w + (1 - w). `it` is a host int, so w
    is a host float."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.in_field = cfg.get("in_field", "sigma")
        self.out_field = cfg.get("out_field", "sigma")
        self.activation = get_activation(cfg.get("activation", "sigmoid"))
        self.shift = float(cfg.get("shift", 0.0))
        self.window_start = float(cfg.get("window_start_iters", 0))
        self.window_iters = float(cfg.get("window_iters", 0))

    def init(self, gen, device):
        return {}

    def apply(self, params, x, ctx, render_kwargs=None):
        cur = float(np.float32(ctx.it) - np.float32(self.window_start))
        if self.window_iters <= 0:
            w = 0.0 if cur < 0 else 1.0
        else:
            w = float(np.clip(np.float32(cur) / np.float32(self.window_iters),
                              0.0, 1.0))
        sigma = self.activation(x[self.in_field][..., -1:] + self.shift, ctx)
        x[self.out_field] = sigma * w + (1.0 - w)
        return x


class RayIntersectEmbedding:
    """An intersect primitive (reference nlf/embedding/ray.py:366-394),
    given the dataset's bounds: its near/far as `_dataset_bounds`, its
    bbox as `_dataset_bbox`, and its depth range as the contraction's
    `_dataset_depth_range` (the reference reads them off the live
    datamodule: nlf/intersect/base.py:88, nlf/contract.py:121-125;
    hyperreel_tpu/models/embeddings.py:683-703)."""

    def __init__(self, cfg, dataset_info=None):
        dataset_info = dataset_info or {}
        cfg = dict(cfg)
        icfg = dict(cfg.get("intersect", {}))
        if dataset_info.get("near") is not None:
            icfg.setdefault("_dataset_bounds",
                            (float(dataset_info["near"]),
                             float(dataset_info["far"])))
        if dataset_info.get("bbox") is not None:
            bb = dataset_info["bbox"]
            icfg.setdefault("_dataset_bbox",
                            (np.asarray(bb[0], np.float32),
                             np.asarray(bb[1], np.float32)))
        dr = dataset_info.get("depth_range")
        if isinstance(icfg.get("contract"), dict) and dr is not None:
            icfg["contract"] = dict(icfg["contract"])
            icfg["contract"].setdefault("_dataset_depth_range",
                                        (float(dr[0]), float(dr[1])))
        cfg["intersect"] = icfg
        self.cfg = cfg
        self.rays_name = cfg.get("rays_name", "rays")
        self.z_channels = int(cfg["z_channels"])
        self.intersect = build_intersect(self.z_channels, icfg)

    def init(self, gen, device):
        return {"intersect": {}}

    def apply(self, params, x, ctx, render_kwargs=None):
        return self.intersect.apply(x[self.rays_name], x, ctx)


def get_base_time(t, flow_keyframes, total_frames, jitter=None,
                  flow_scale=0.0):
    """Snap times to keyframe times (reference utils/flow_utils.py:10-35);
    in training with flow_scale > 0, jittered first by (jitter - 0.5) *
    flow_scale keyframes, `jitter` a U[0, 1) draw of t's shape."""
    if flow_keyframes <= 0:
        return torch.zeros_like(t)
    fac = flow_keyframes * (total_frames - 1) / total_frames
    base = t * fac
    if jitter is not None and flow_scale > 0.0:
        base = base + (jitter * flow_scale - flow_scale / 2.0)
    base = torch.clamp(base, 0.0, flow_keyframes - 1.0) - 1e-5
    return torch.round(base) * (1.0 / fac)


class AdvectPointsEmbedding:
    """Keyframe flow advection (reference nlf/embedding/point.py:741-834):
    the angular flow (the predicted field "angular_flow": an axis-angle
    rate [..., :3] and an anchor [..., 3:6], each under its activation;
    the points rotated about the anchor by the rate times the time
    offset, ops/rotation.py axis_angle_to_matrix) and then the spatial
    flow (points + flow * time offset); in training the keyframe jitter of
    flow_scale (the draw "flow_jitter"; render_kwargs "no_flow_jitter"
    turns it off); `save_points_field` keeps the points before the
    advection, `out_offset_field` gets in-points minus out-points."""

    def __init__(self, cfg, num_keyframes=1, num_frames=1):
        self.cfg = cfg
        self.rays_name = cfg.get("rays_name", "rays")
        self.in_points_field = cfg.get("in_points_field", "points")
        self.out_points_field = cfg.get("out_points_field", "points")
        self.out_offset_field = cfg.get("out_offset_field", "offset")
        self.use_spatial_flow = bool(cfg.get("use_spatial_flow", False))
        self.use_angular_flow = bool(cfg.get("use_angular_flow", False))
        self.spatial_flow_activation = get_activation(
            cfg.get("spatial_flow_activation", "identity"))
        self.angular_flow_rotation_activation = get_activation(
            cfg.get("angular_flow_rotation_activation", "identity"))
        self.angular_flow_anchor_activation = get_activation(
            cfg.get("angular_flow_anchor_activation", "identity"))
        self.save_points_field = cfg.get("save_points_field")
        self.flow_scale = float(cfg.get("flow_scale", 0.0))
        self.num_keyframes = num_keyframes
        self.num_frames = num_frames

    def init(self, gen, device):
        return {}

    def apply(self, params, x, ctx, render_kwargs=None):
        rays = x[self.rays_name]
        points = x[self.in_points_field]
        t = rays[..., -1:]
        if self.save_points_field is not None:
            x[self.save_points_field] = points
        jitter = None
        if ctx.training and self.flow_scale > 0.0 \
                and "no_flow_jitter" not in (render_kwargs or {}):
            jitter = ctx.uniform("flow_jitter", t.shape, t.device,
                                 per_ray=True)
        base_t = get_base_time(t, self.num_keyframes, self.num_frames,
                               jitter, self.flow_scale)
        time_offset = (t - base_t)[..., None, :]
        if self.use_angular_flow:
            rot_vec = self.angular_flow_rotation_activation(
                x["angular_flow"][..., :3], ctx)
            anchor = self.angular_flow_anchor_activation(
                x["angular_flow"][..., 3:6], ctx)
            x["angular_flow_rot"] = rot_vec
            x["angular_flow_anchor"] = anchor
            R = axis_angle_to_matrix(rot_vec * time_offset)
            points = torch.einsum("...ij,...j->...i", R,
                                  points - anchor) + anchor
        if self.use_spatial_flow:
            flow = self.spatial_flow_activation(x["spatial_flow"], ctx)
            x["spatial_flow"] = flow
            points = points + flow * time_offset
        B, S = points.shape[:2]
        x[self.out_points_field] = points
        x["base_times"] = base_t[..., None, :].expand(B, S, 1)
        x["time_offset"] = time_offset.expand(B, S, 1)
        if self.out_offset_field is not None:
            x[self.out_offset_field] = x[self.in_points_field] - points
        return x


class PointOffsetEmbedding:
    """points += act(point_offset) * (1 - sigma) (reference
    nlf/embedding/point.py:338-399): `save_points_field` keeps the points
    before the offset; with `dropout` the offset is zero in the training
    steps at `it` % frequency == 0 below stop_iter (decided on the host:
    `it` is a host int)."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.save_points_field = cfg.get("save_points_field")
        self.use_dropout = cfg.get("dropout") is not None
        dropout = cfg.get("dropout") or {}
        self.dropout_frequency = int(dropout.get("frequency", 2))
        self.dropout_stop_iter = float(dropout.get("stop_iter",
                                                   float("inf")))
        self.in_density_field = cfg.get("in_density_field", "sigma")
        self.in_offset_field = cfg.get("in_offset_field", "point_offset")
        self.out_offset_field = cfg.get("out_offset_field", "offset")
        self.in_points_field = cfg.get("in_points_field", "points")
        self.out_points_field = cfg.get("out_points_field", "points")
        self.use_sigma = bool(cfg.get("use_sigma", True))
        self.activation = get_activation(cfg.get("activation", "identity"))

    def init(self, gen, device):
        return {}

    def apply(self, params, x, ctx, render_kwargs=None):
        in_points = x[self.in_points_field]
        if self.save_points_field is not None:
            x[self.save_points_field] = in_points
        if self.use_sigma and self.in_density_field in x:
            sigma = x[self.in_density_field]
        else:
            sigma = in_points.new_zeros(in_points.shape[:2] + (1,))
        offset = self.activation(x[self.in_offset_field], ctx) * (1.0 - sigma)
        if self.use_dropout and ctx.training \
                and ctx.it % self.dropout_frequency == 0 \
                and ctx.it < self.dropout_stop_iter:
            offset = torch.zeros_like(offset)
        x[self.in_offset_field] = offset
        x[self.out_points_field] = in_points + offset
        if self.out_offset_field is not None:
            x[self.out_offset_field] = offset
        return x


class AddPointOutputsEmbedding:
    """Broadcast per-ray viewdirs/times to per-sample fields (reference
    nlf/embedding/point.py:837-873)."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.rays_name = cfg.get("rays_name", "rays")
        self.extra_outputs = list(cfg.get("extra_outputs", []))

    def init(self, gen, device):
        return {}

    def apply(self, params, x, ctx, render_kwargs=None):
        rays = x[self.rays_name]
        B, S = rays.shape[0], x["points"].shape[1]
        if "times" in self.extra_outputs and "times" not in x:
            x["times"] = rays[..., None, -1:].expand(B, S, 1)
        if "base_times" in self.extra_outputs and "base_times" not in x:
            x["base_times"] = rays[..., None, -1:].expand(B, S, 1)
        if "viewdirs" in self.extra_outputs and "viewdirs" not in x:
            x["viewdirs"] = rays[..., None, 3:6].expand(B, S, 3)
        return x


class ExtractFieldsEmbedding:
    """Final field selection (reference nlf/embedding/point.py:221-247)."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.fields = list(cfg.get("fields", []))

    def init(self, gen, device):
        return {}

    def apply(self, params, x, ctx, render_kwargs=None):
        fields = self.fields + list((render_kwargs or {}).get("fields", []))
        return {k: x[k] for k in fields if k in x}


class ColorTransformEmbedding:
    """A learned per-camera residual 3x3 colour transform and shift
    (hyperreel_tpu ColorTransformEmbedding; reference
    nlf/embedding/point.py:558-602): each ray's camera index (the ray's
    second-to-last channel, rounded) picks its camera's transform [9] and
    shift [3], under their activations, broadcast to every sample as
    color_transform_global [B, S, 9] and color_shift_global [B, S, 3],
    which the colour net applies to the composited colour
    (FactoredNet.finish). An index outside [0, num_views) reads the
    nearest camera's and passes it no gradient, as the JAX package's
    gather (clamped) and its transpose (out-of-range updates dropped) do.
    Its params are in the "color" group."""

    def __init__(self, cfg, num_views=1):
        self.cfg = cfg
        self.num_views = int(num_views)
        self.group = "color"
        self.rays_name = cfg.get("rays_name", "rays")
        self.transform_activation = get_activation(
            cfg.get("transform_activation", "identity"))
        self.shift_activation = get_activation(
            cfg.get("shift_activation", "identity"))

    def init(self, gen, device):
        return {"transform": torch.zeros(self.num_views, 9, device=device),
                "shift": torch.zeros(self.num_views, 3, device=device)}

    def apply(self, params, x, ctx, render_kwargs=None):
        rays = x[self.rays_name]
        idx = torch.round(rays[..., -2]).long()
        cam = torch.clamp(idx, 0, self.num_views - 1)
        inside = (cam == idx)[:, None]

        def pick(v):
            v = v[cam]
            return torch.where(inside, v, v.detach())

        transform = pick(self.transform_activation(params["transform"], ctx))
        shift = pick(self.shift_activation(params["shift"], ctx))
        B, S = rays.shape[0], x["points"].shape[1]
        x["color_transform_global"] = transform[:, None, :].expand(B, S, 9)
        x["color_shift_global"] = shift[:, None, :].expand(B, S, 3)
        return x


def _stage_window(stage):
    """A stage's (wait_iters, stop_iters) gate, or None where it has
    none."""
    wait = float(stage.cfg.get("wait_iters", 0))
    stop = float(stage.cfg.get("stop_iters", float("inf")))
    return (wait, stop) if wait > 0 or stop != float("inf") else None


def _held(new, old):
    """A field of an inactive gated stage: its value before the stage
    where the stage changed it in place (same shape), zeros of its shape
    where the stage added it, the stage's where the shape changed."""
    if old is None:
        return torch.zeros_like(new) if torch.is_tensor(new) else 0 * new
    if torch.is_tensor(new) and torch.is_tensor(old) \
            and old.shape == new.shape:
        return old
    return new


class EmbeddingChain:
    """Ordered chain over the sample-state dict (reference
    nlf/embedding/embedding.py:59-126), with per-stage wait_iters /
    stop_iters gating (embedding.py:106-110) as the JAX package realizes
    it (hyperreel_tpu EmbeddingChain.apply): a gated stage always runs, on
    a copy of the state; where `it` is outside [wait, stop) each field of
    its output is `_held`. `it` is a host int, so the gate is decided on
    the host."""

    def __init__(self, stages: List):
        self.stages = stages          # (name, stage) pairs
        self.windows = {name: _stage_window(stage) for name, stage in stages}

    def init(self, gen, device):
        return {name: stage.init(gen, device) for name, stage in self.stages}

    def apply(self, params, rays, ctx, render_kwargs=None):
        x = {"rays": rays}
        for name, stage in self.stages:
            window = self.windows[name]
            if window is None:
                x = stage.apply(params[name], x, ctx, render_kwargs)
                continue
            out = stage.apply(params[name], dict(x), ctx, render_kwargs)
            if window[0] <= ctx.it < window[1]:
                x = out
            else:
                x = {k: _held(v, x.get(k)) for k, v in out.items()}
        return x


def build_embedding_chain(cfg, dataset_info=None, compute_dtype=None):
    """Build the ray_point chain from `embedding.embeddings` (reference
    nlf/models/models.py:104-143)."""
    dataset_info = dataset_info or {}
    stages = []
    for name, scfg in cfg["embeddings"].items():
        t = scfg["type"]
        if t == "ray_prediction":
            stage = RayPredictionEmbedding(dict(scfg), compute_dtype)
        elif t == "ray_intersect":
            stage = RayIntersectEmbedding(scfg, dataset_info)
        elif t == "point_prediction":
            stage = PointPredictionEmbedding(dict(scfg), compute_dtype)
        elif t == "point_density":
            stage = PointDensityEmbedding(dict(scfg))
        elif t == "reflect":
            stage = ReflectEmbedding(dict(scfg))
        elif t == "advect_points":
            stage = AdvectPointsEmbedding(
                dict(scfg),
                int(dataset_info.get("num_keyframes", 1)),
                int(dataset_info.get("num_frames", 1)))
        elif t == "point_offset":
            stage = PointOffsetEmbedding(dict(scfg))
        elif t == "add_point_outputs":
            stage = AddPointOutputsEmbedding(dict(scfg))
        elif t == "extract_fields":
            stage = ExtractFieldsEmbedding(dict(scfg))
        elif t == "color_transform":
            stage = ColorTransformEmbedding(
                dict(scfg), int(dataset_info.get("num_views", 1)))
        elif t == "select_points":
            stage = SelectPointsEmbedding(dict(scfg))
        elif t == "generate_samples":
            stage = GenerateNumSamplesEmbedding(dict(scfg))
        else:
            raise NotImplementedError(
                f"embedding stage {t!r} is not ported "
                "(ROADMAP.md: long tail)")
        stages.append((name, stage))
    return EmbeddingChain(stages)
