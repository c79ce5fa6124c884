"""Activation registry (port of hyperreel_tpu/models/activations.py;
reference nlf/activations.py).

`get_activation(cfg)` returns a callable `act(x, ctx)`. The flagship needs
identity, sigmoid and tanh with the affine factors of `_affine_params`,
the iteration-scheduled `ease_value` around one of them, and the MLP's
leaky_relu. Every other type raises NotImplementedError.

`Activation.descriptor(it)` hands the same function to the pack-build
kernel as plain numbers: the kernel evaluates
`w * f((x * inner + shift)) * outer + (1 - w) * start` with
f in {identity, sigmoid, tanh}; the host evaluates the ease weight `w`
from `it`, the only thing it depends on.
"""

from dataclasses import dataclass

import numpy as np
import torch

# kernel codes of the per-field activation kinds (csrc/pack_build.cu)
KINDS = {"identity": 0, "sigmoid": 1, "tanh": 2}


def _cfg_get(cfg, key, default):
    if isinstance(cfg, str):
        return default
    return cfg.get(key, default)


def _affine_params(cfg):
    inner = _cfg_get(cfg, "inner_fac", 1.0)
    outer = _cfg_get(cfg, "outer_fac", 1.0)
    shift = _cfg_get(cfg, "shift", 0.0)
    fac = _cfg_get(cfg, "fac", None)
    if fac is not None:
        outer = fac
    return float(inner), float(outer), float(shift)


@dataclass(frozen=True)
class Ease:
    """ease_value schedule: weight(it) blends start_value into the inner
    activation (reference nlf/activations.py:462-497)."""
    start_value: float
    wait: float
    window: float

    def weight(self, it):
        cur = np.float32(it) - np.float32(self.wait)
        if self.window <= 0.0:
            return 1.0 if cur >= 0.0 else 0.0
        return float(np.clip(cur / np.float32(self.window), 0.0, 1.0))


@dataclass(frozen=True)
class Activation:
    kind: str                   # identity | sigmoid | tanh
    inner: float = 1.0
    outer: float = 1.0
    shift: float = 0.0
    ease: Ease = None

    def _base(self, x):
        # unit factors are skipped: x * 1 + 0 is x (a pass over the
        # tensor saved, e.g. the MLP's identity output activation)
        u = x if self.inner == 1.0 else x * self.inner
        u = u if self.shift == 0.0 else u + self.shift
        if self.kind == "sigmoid":
            u = torch.reciprocal(1.0 + torch.exp(-u))
        elif self.kind == "tanh":
            u = torch.tanh(u)
        return u if self.outer == 1.0 else u * self.outer

    def __call__(self, x, ctx=None):
        out = self._base(x)
        if self.ease is None or ctx is None:
            return out
        w = self.ease.weight(ctx.it)
        return w * out + (1.0 - w) * self.ease.start_value

    def descriptor(self, it):
        """(kind code, inner, outer, shift, ease weight, start value)."""
        if self.ease is None:
            w, start = 1.0, 0.0
        else:
            w, start = self.ease.weight(it), float(self.ease.start_value)
        return (KINDS[self.kind], self.inner, self.outer, self.shift,
                w, start)


@dataclass(frozen=True)
class LeakyRelu:
    a: float = 0.01

    def __call__(self, x, ctx=None, dtype=None):
        """dtype: the storage dtype of a low-precision chain, whose slope
        JAX rounds to that dtype too (a weakly typed scalar)."""
        if dtype is None:
            return torch.nn.functional.leaky_relu(x, self.a)
        a = torch.tensor(self.a).to(dtype).item()
        return torch.where(x >= 0, x, a * x)


def get_activation(cfg):
    """str or {'type': ...} config -> activation (reference
    nlf/activations.py:566-570)."""
    if cfg is None:
        return Activation("identity")
    t = cfg if isinstance(cfg, str) else cfg.get("type", "identity")
    if t in KINDS:
        return Activation(t, *_affine_params(cfg))
    if t == "leaky_relu":
        return LeakyRelu(float(_cfg_get(cfg, "a", 0.01)))
    if t == "ease_value":
        inner = get_activation(cfg["activation"])
        if not isinstance(inner, Activation) or inner.ease is not None:
            raise NotImplementedError(
                f"ease_value around {cfg['activation']!r} is not ported "
                "(ROADMAP.md: long tail)")
        ease = Ease(float(cfg.get("start_value", 0.0)),
                    float(cfg.get("wait_iters", 0.0)),
                    float(cfg.get("window_iters", 0.0)))
        return Activation(inner.kind, inner.inner, inner.outer,
                          inner.shift, ease)
    raise NotImplementedError(
        f"activation {t!r} is not ported (ROADMAP.md: long tail)")
