"""Regularizers (port of hyperreel_tpu/train/regularizers.py; reference
nlf/regularizers/).

Each regularizer exposes `loss(model, params, batch, ctx, system) ->
0-d tensor`: the TensoRF L1 + TV regularizer (`tensorf`, the shipped
`tv_4000` config, the one the shipped training scripts run),
`render_weight`, `geometry` and `voxel_sparsity`. The JAX package's
regularizers_extra.py is not ported (ROADMAP.md: long tail).
"""

import math

import numpy as np
import torch


def schedule_weight(cfg, it):
    """wait/warmup/stop-iteration weight window at the host iteration `it`
    (reference nlf/regularizers/base.py)."""
    f = np.float32
    weight = f(cfg.get("weight", 1.0))
    wait = f(cfg.get("wait_iters", 0))
    stop = float(cfg.get("stop_iters", float("inf")))
    warmup = f(cfg.get("warmup_iters", 0))
    cur = f(it) - wait
    w = f(0.0) if cur < 0 else weight
    if warmup > 0:
        w = w * np.clip(cur / warmup, f(0.0), f(1.0))
    if it >= stop:
        w = f(0.0)
    return float(w)


class TensorfRegularizer:
    """Plane/line L1 + TV on the density and appearance grids (reference
    nlf/regularizers/tensorf.py:57-96, tensorf/tv_4000.yaml):

      L1_weight * density_l1 + 2 * TV_weight_density * tv_density
      + TV_weight_app * tv_app,

    the L1 weight dropping at the config's first alpha-mask iteration, the
    density TV counted twice (the reference accumulates it into both
    terms), and no TV past `total_num_tv_iters` (the reference returns
    early there; the host decides from `it`)."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.l1_weight_initial = float(cfg.get("L1_weight_initial", 8e-5))
        self.l1_weight_rest = float(cfg.get("L1_weight_rest", 4e-5))
        mask_list = list(cfg.get("update_AlphaMask_list", [4000]))
        self.l1_switch_iter = float(mask_list[0]) if mask_list \
            else float("inf")
        self.tv_weight_density = float(cfg.get("TV_weight_density", 0.0))
        self.tv_weight_app = float(cfg.get("TV_weight_app", 0.0))
        ratio = float(cfg.get("lr_decay_target_ratio", 0.1))
        n_iters = float(cfg.get("n_iters", 30000))
        self.total_num_tv_iters = float(cfg.get(
            "total_num_tv_iters",
            round((math.log(1e-4) / math.log(ratio)) * n_iters)))

    def loss(self, model, params, batch, ctx, system=None):
        net = model.color_net
        cp = params["color"]
        l1_w = self.l1_weight_initial if ctx.it < self.l1_switch_iter \
            else self.l1_weight_rest
        total = l1_w * net.density_l1(cp)
        if ctx.it <= self.total_num_tv_iters and (
                self.tv_weight_density > 0 or self.tv_weight_app > 0):
            tv = 0.0
            if self.tv_weight_density > 0:
                d = self.tv_weight_density * net.tv_loss_density(cp)
                tv = tv + (2.0 * d if self.tv_weight_app > 0 else d)
            if self.tv_weight_app > 0:
                tv = tv + self.tv_weight_app * net.tv_loss_app(cp)
            total = total + tv
        return total


class RenderWeightRegularizer:
    """The render weights pulled toward the predicted weights: the
    scheduled weight times the mean squared difference, from a second
    apply of the model with the fields "render_weights" and "weights" (the
    latter not composited) (reference nlf/regularizers/geometry.py:266+;
    hyperreel_tpu RenderWeightRegularizer)."""

    def __init__(self, cfg):
        self.cfg = cfg

    def loss(self, model, params, batch, ctx, system=None):
        out = model.apply(params, batch["rays"], ctx,
                          {"fields": ["render_weights", "weights"],
                           "no_over_fields": ["weights"]})
        rw = out["render_weights"]
        pw = out["weights"].reshape(rw.shape)
        return schedule_weight(self.cfg, ctx.it) * ((rw - pw) ** 2).mean()


class GeometryRegularizer:
    """Depth supervision (reference nlf/regularizers/geometry.py:48-85;
    hyperreel_tpu GeometryRegularizer): the squared distance of the
    render-weight composited sample points to the batch's ground-truth
    "points", over the rays with a depth > 0, times the scheduled weight;
    0 for a batch without "depth"."""

    def __init__(self, cfg):
        self.cfg = cfg

    def loss(self, model, params, batch, ctx, system=None):
        rays = batch["rays"]
        if "depth" not in batch:
            return rays.new_zeros(())
        out = model.apply(params, rays, ctx, {"fields": ["points"]})
        pts = out["points"].reshape(rays.shape[0], 3)
        valid = (batch["depth"] > 0).to(pts.dtype)
        err = ((pts - batch["points"]) ** 2).sum(-1, keepdim=True)
        return schedule_weight(self.cfg, ctx.it) * (valid * err).sum() \
            / torch.clamp_min(valid.sum(), 1.0)


class VoxelSparsityRegularizer:
    """Sparsity of the densities at `num_points` points drawn uniformly in
    the aabb (the draw "voxel_sparsity"): the scheduled weight times the
    mean of 1 - exp(-0.01 relu(density)), the static net's density feature
    or the dynamic net's at the normalized time 0 (reference
    nlf/regularizers/voxel_sparsity.py:24-40; hyperreel_tpu
    VoxelSparsityRegularizer)."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.num_points = int(cfg.get("num_points", 4096))

    def loss(self, model, params, batch, ctx, system=None):
        net = model.color_net
        cp = params["color"]
        dev = cp["basis_mat"]["weight"].device
        aabb = torch.as_tensor(net.aabb, device=dev)
        pts = ctx.uniform("voxel_sparsity", (self.num_points, 3), dev) \
            * (aabb[1] - aabb[0]) + aabb[0]
        xyz = net.normalize_coord(pts)
        if net.TIME_PLANES:
            xyz = torch.cat([xyz, torch.zeros_like(xyz[:, :1])], -1)
        sigma = net.feature2density(net.sample_density(cp, xyz))
        return schedule_weight(self.cfg, ctx.it) \
            * (1.0 - torch.exp(-sigma * 0.01)).mean()


regularizer_dict = {
    "tensorf": TensorfRegularizer,
    "render_weight": RenderWeightRegularizer,
    "geometry": GeometryRegularizer,
    "voxel_sparsity": VoxelSparsityRegularizer,
}


def build_regularizers(cfgs):
    regs = []
    for name, cfg in (cfgs or {}).items():
        t = cfg.get("type", name)
        if t not in regularizer_dict:
            raise NotImplementedError(
                f"regularizer {t!r} is not ported (ROADMAP.md: long tail)")
        regs.append((name, regularizer_dict[t](dict(cfg))))
    return regs


def tv_4000_defaults():
    """The shipped `tv_4000` regularizer config (reference
    conf/experiment/regularizers/tensorf/tv_4000.yaml)."""
    return {
        "tensorf": {
            "type": "tensorf",
            "L1_weight_initial": 8e-5,
            "L1_weight_rest": 4e-5,
            "update_AlphaMask_list": [4000, 8000],
            "TV_weight_density": 0.05,
            "TV_weight_app": 0.05,
            "lr_decay_target_ratio": 0.1,
            "n_iters": 30000,
        }
    }
