"""Named optimizer groups (port of hyperreel_tpu/train/optim.py; reference
utils/__init__.py:49-130 and the `optimizers:` blocks of
conf/experiment/training/*_tensorf.yaml).

The JAX package runs one `optax.multi_transform` over the params' group
labels, each group a chain: optional clip by the group's global norm; adam
(betas (0.9, 0.99), eps 1e-8), sgd with momentum, or rmsprop; optional
weight decay; the group's learning-rate schedule. Here the same update is
written by hand over the labelled leaves (`GroupedOptimizer`), with the
optax formulas in the same order and in f32.

Each group keeps its own step counter, and the schedule and Adam's bias
correction read it, not the global iteration: optax's `scale_by_schedule`
and `scale_by_adam` count from 0 whenever the state is initialized, and
the trainer initializes it anew at every grid event (upsample, shrink). So
after an event the learning rate starts again from `lr` and Adam's bias
correction restarts, as in the JAX package. A label without a config is
frozen (optax.set_to_zero).
"""

import math

import numpy as np
import torch


def make_lr_schedule(group_cfg, iters_per_epoch):
    """Per-epoch-stepped schedules (reference utils/__init__.py:78-126), in
    f32 as the JAX package evaluates them:

    exp: lr * gamma^(epoch/decay_epoch), zero after stop_epoch.
    steplr: lr * gamma^(epoch >= decay_epoch).
    poly: lr * (1 - epoch/num_epochs)^poly_exp.
    cosine: cosine annealing to ~0 over num_epochs.
    Optional linear warmup over warmup_epochs with warmup_multiplier.
    """
    f = np.float32
    kind = group_cfg.get("lr_scheduler", "exp")
    lr0 = f(group_cfg["lr"])
    gamma = f(group_cfg.get("decay_gamma", 1.0))
    decay_epoch = f(group_cfg.get("decay_epoch", 100))
    stop_epoch = float(group_cfg.get("stop_epoch", float("inf")))
    num_epochs = f(group_cfg.get("num_epochs", 100))
    poly_exp = f(group_cfg.get("poly_exp", 1.0))
    warmup_epochs = f(group_cfg.get("warmup_epochs", 0))
    warmup_mult = f(group_cfg.get("warmup_multiplier", 1.0))
    if kind not in ("exp", "steplr", "poly", "cosine"):
        raise ValueError(f"unknown lr_scheduler {kind}")

    def schedule(it):
        epoch = np.floor(f(it) / f(iters_per_epoch))
        if kind == "exp":
            lr = lr0 * gamma ** (epoch / decay_epoch)
            if stop_epoch != float("inf") and epoch > stop_epoch:
                lr = f(0.0)
        elif kind == "steplr":
            lr = lr0 * (gamma if epoch >= decay_epoch else f(1.0))
        elif kind == "poly":
            lr = lr0 * max(f(1.0) - epoch / num_epochs, f(0.0)) ** poly_exp
        else:
            lr = f(1e-8) + (lr0 - f(1e-8)) * f(0.5) * (f(1.0) + np.cos(
                f(math.pi) * min(epoch / num_epochs, f(1.0))))
        if warmup_epochs > 0:
            # linear ramp from lr/multiplier to lr over warmup_epochs
            frac = np.clip(epoch / warmup_epochs, f(0.0), f(1.0))
            lr = lr * (f(1.0) + (warmup_mult - f(1.0)) * frac) / warmup_mult
        return float(f(lr))

    return schedule


def tree_leaves(tree, prefix=()):
    """[(path, leaf)] of a nested dict, in insertion order."""
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out += tree_leaves(v, prefix + (k,))
        return out
    return [(prefix, tree)]


def tree_get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


class GroupTransform:
    """One group's chain (hyperreel_tpu optim._group_transform)."""

    def __init__(self, group_cfg, iters_per_epoch):
        self.opt = group_cfg.get("optimizer", "adam")
        if self.opt not in ("adam", "sgd", "rmsprop"):
            raise ValueError(f"unknown optimizer {self.opt}")
        self.schedule = make_lr_schedule(group_cfg, iters_per_epoch)
        self.clip = float(group_cfg.get("clip_amount", 1.0)) \
            if group_cfg.get("clip", False) else None
        self.momentum = float(group_cfg.get("momentum", 0.0))
        self.alpha = float(group_cfg.get("alpha", 0.99))
        self.wd = float(group_cfg.get("weight_decay", 0.0))

    def slots(self):
        """The per-leaf state this chain keeps."""
        if self.opt == "adam":
            return ("mu", "nu")
        if self.opt == "sgd":
            return ("trace",) if self.momentum > 0 else ()
        return ("nu",)

    def update(self, params, grads, slots, count):
        """Updates (to add to the params) from the grads of this group's
        leaves at the group's count; `slots` (one dict per leaf) updated in
        place."""
        if self.clip is not None:
            norm = torch.sqrt(sum((g * g).sum() for g in grads))
            grads = [torch.where(norm < self.clip, g, g / norm * self.clip)
                     for g in grads]
        out = []
        b1, b2 = np.float32(0.9), np.float32(0.99)
        for p, g, st in zip(params, grads, slots):
            if self.opt == "adam":
                st["mu"] = (1 - 0.9) * g + 0.9 * st["mu"]
                st["nu"] = (1 - 0.99) * (g * g) + 0.99 * st["nu"]
                c1 = float(np.float32(1) - b1 ** np.float32(count + 1))
                c2 = float(np.float32(1) - b2 ** np.float32(count + 1))
                u = (st["mu"] / c1) / (torch.sqrt(st["nu"] / c2) + 1e-8)
            elif self.opt == "sgd" and self.momentum > 0:
                st["trace"] = g + self.momentum * st["trace"]
                u = st["trace"]
            elif self.opt == "sgd":
                u = g
            else:
                st["nu"] = (1 - self.alpha) * (g * g) \
                    + self.alpha * st["nu"]
                u = g * torch.rsqrt(st["nu"] + 1e-8)
            if self.wd > 0:
                u = u + self.wd * p
            out.append(-self.schedule(count) * u)
        return out


def path_key(path):
    """The optimizer state's key of a leaf path: "embedding/.../weight"."""
    return "/".join(path)


class GroupedOptimizer:
    """optax.multi_transform over group labels, by hand: `init(params)` ->
    state {"count": {group: int}, "slots": {path_key: {slot: tensor}}};
    `step(params, grads, state)` adds each group's updates to its leaves in
    place and advances its counter."""

    def __init__(self, optimizers_cfg, labels, iters_per_epoch):
        self.labels = dict(tree_leaves(labels))
        self.groups = {name: GroupTransform(cfg, iters_per_epoch)
                       for name, cfg in optimizers_cfg.items()}

    def init(self, params):
        slots = {}
        for path, p in tree_leaves(params):
            g = self.groups.get(self.labels[path])
            slots[path_key(path)] = {
                k: torch.zeros_like(p, dtype=torch.float32)
                for k in (g.slots() if g else ())}
        return {"count": {name: 0 for name in self.groups
                          if name in self.labels.values()},
                "slots": slots}

    @torch.no_grad()
    def step(self, params, grads, state):
        """grads: {path tuple: tensor} of the leaves that have one."""
        for name, g in self.groups.items():
            paths = [p for p, lab in self.labels.items()
                     if lab == name and p in grads]
            if not paths:
                continue
            leaves = [tree_get(params, p) for p in paths]
            ups = g.update(leaves, [grads[p].float() for p in paths],
                           [state["slots"][path_key(p)] for p in paths],
                           state["count"][name])
            for leaf, u in zip(leaves, ups):
                leaf.add_(u.to(leaf.dtype))
            state["count"][name] += 1
        return state


def build_optimizer(optimizers_cfg, group_labels, iters_per_epoch):
    return GroupedOptimizer(optimizers_cfg, group_labels, iters_per_epoch)


def apply_weight_init(params, cfg, gen):
    """weight_init_dict (reference utils/__init__.py:19-45): none /
    uniform / xavier / kaiming re-initialization of every linear layer's
    weight (nn.Linear layout [out, in]), drawn from the torch.Generator
    `gen`."""
    kind = (cfg or {}).get("type", "none")
    if kind in (None, "none"):
        return params

    def walk(node):
        if not isinstance(node, dict):
            return node
        out = {}
        for k, v in node.items():
            if k == "weight" and torch.is_tensor(v) and v.dim() == 2:
                fan_out, fan_in = v.shape
                shape = (fan_in, fan_out)         # drawn in the [in, out]
                if kind == "uniform":
                    a = float(cfg.get("a", 0.1))
                    w = torch.rand(shape, generator=gen) * (2 * a) - a
                elif kind == "xavier":
                    s = (6.0 / (fan_in + fan_out)) ** 0.5
                    w = torch.rand(shape, generator=gen) * (2 * s) - s
                elif kind == "kaiming":
                    w = torch.randn(shape, generator=gen) \
                        * (2.0 / fan_in) ** 0.5
                else:
                    w = None
                out[k] = v if w is None else w.t().contiguous().to(v)
            else:
                out[k] = walk(v)
        return out

    return walk(params)
