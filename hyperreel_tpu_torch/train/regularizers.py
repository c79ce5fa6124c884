"""Regularizers (port of hyperreel_tpu/train/regularizers.py; reference
nlf/regularizers/).

Each regularizer exposes `loss(model, params, batch, ctx, system) ->
0-d tensor`. The TensoRF L1 + TV regularizer (`tensorf`, the shipped
`tv_4000` config) is the one the shipped training scripts run and the one
ported; the others raise NotImplementedError.
"""

import math

import numpy as np


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


# the JAX package's other regularizers (render_weight, geometry,
# voxel_sparsity and regularizers_extra.py's) are not ported
regularizer_dict = {"tensorf": TensorfRegularizer}


def build_regularizers(cfgs):
    regs = []
    for name, cfg in (cfgs or {}).items():
        t = cfg.get("type", name)
        if t not in regularizer_dict:
            raise NotImplementedError(
                f"regularizer {t!r} is not ported (ROADMAP.md: training "
                "beyond the flagship)")
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
