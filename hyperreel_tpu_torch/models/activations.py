"""Activation registry (port of hyperreel_tpu/models/activations.py;
reference nlf/activations.py).

`get_activation(cfg)` returns a callable `act(x, ctx)` for every entry of
the JAX `activation_map`:
- `Activation`: an elementwise kind (identity, sigmoid, tanh, softplus,
  relu, leaky_relu, abs, zero, identity_tanh, power, gaussian; alpha and
  rgba are the sigmoid of every channel), with its affine factors or its
  parameter;
- `EaseValue` and `InterpValue`: the iteration-scheduled blends of
  ease_value (start_value into an activation) and interp_value (one
  activation into another);
- `VectorActivation`: the kinds that mix the channels of a row (softmax,
  the norms, probs, sparse_magnitude, twist_to_matrix,
  axis_angle_translation), plain torch.

The pack-build kernel (K1) takes every elementwise activation and any
ease_value / interp_value over them, as plain numbers: `kernel_terms(it)`
folds the schedules into coefficients, c0 + sum_i c_i f_i(x) over at most
MAX_LEAVES elementwise functions f_i(x) = g(x * inner + shift) * outer
(`leaf()`: kind code, inner, outer, shift and the kind's parameter). The
host evaluates the schedules from `it`, the only thing they depend on.

Gradients at ties are JAX's: jnp.maximum(x, 0) passes 0.5 at 0 and
jnp.abs passes 1 (relu is 0.5 (x + |x|), abs where(x >= 0, x, -x)).
"""

from dataclasses import dataclass

import numpy as np
import torch

# kernel codes of the elementwise kinds (csrc/pack_build.cuh ActKind);
# kinds below BASIC_KINDS run in K1's default instantiation
KINDS = {"identity": 0, "sigmoid": 1, "tanh": 2, "softplus": 3, "relu": 4,
         "leaky_relu": 5, "abs": 6, "zero": 7, "identity_tanh": 8,
         "power": 9, "gaussian": 10}
BASIC_KINDS = 3
# the elementwise functions one K1 activation slot holds
MAX_LEAVES = 2
# identity_tanh's switch from the identity to 2 tanh (JAX :70-77)
IDENTITY_TANH_EDGE = 1.91501
VECTOR_KINDS = ("softmax", "l1_norm", "l2_norm", "row_l2_norm",
                "row_l1_norm", "row_linf_norm", "row_l2_norm_z_only",
                "probs", "sparse_magnitude", "twist_to_matrix",
                "axis_angle_translation")


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


def _const(v, dtype):
    """A weakly typed JAX scalar in an array of `dtype`: rounded to it."""
    return v if dtype is None else torch.tensor(v).to(dtype).item()


def schedule_weight(it, wait, window):
    """The ease/interp weight at iteration `it`: clip((it - wait) /
    window, 0, 1), or a step at wait where window <= 0 (f32, as JAX)."""
    cur = np.float32(it) - np.float32(wait)
    if window <= 0.0:
        return 1.0 if cur >= 0.0 else 0.0
    return float(np.clip(cur / np.float32(window), 0.0, 1.0))


def _abs(x):
    """|x| with jnp.abs's gradient 1 at 0 (torch.abs passes 0)."""
    return torch.where(x >= 0, x, -x)


def leaf_value(leaf, x):
    """An elementwise function (kind code, inner, outer, shift, a) of x:
    g(x * inner + shift) * outer, g as the JAX closures compute it, with
    JAX's gradients at the ties; unit factors are skipped (x * 1 + 0 is
    x: a pass over the tensor saved). K1's plain version evaluates its
    leaves with it too (ops/kernels/pack_build.py apply_terms)."""
    kind, inner, outer, shift, a = leaf
    u = x if inner == 1.0 else x * inner
    u = u if shift == 0.0 else u + shift
    if kind == KINDS["sigmoid"]:
        u = torch.reciprocal(1.0 + torch.exp(-u))
    elif kind == KINDS["tanh"]:
        u = torch.tanh(u)
    elif kind == KINDS["softplus"]:
        # logaddexp(u, 0) in jnp.logaddexp's and K1's form; maximum passes
        # 0.5 at the tie, as its gradient
        u = torch.maximum(u, torch.zeros_like(u)) + torch.log1p(
            torch.exp(-u.abs()))
    elif kind == KINDS["relu"]:
        u = 0.5 * (u + u.abs())
    elif kind == KINDS["leaky_relu"]:
        u = torch.where(u >= 0, u, a * u)
    elif kind == KINDS["abs"]:
        u = _abs(u)
    elif kind == KINDS["zero"]:
        u = torch.zeros_like(u)
    elif kind == KINDS["identity_tanh"]:
        u = torch.where(u.abs() < IDENTITY_TANH_EDGE, u,
                        torch.tanh(u) * 2.0) * a / 2.0
    elif kind == KINDS["power"]:
        u = torch.pow(_abs(u) + 1e-8, a) * torch.sign(u)
    elif kind == KINDS["gaussian"]:
        u = torch.exp(-0.5 * (u / a) ** 2)
    return u if outer == 1.0 else u * outer


@dataclass(frozen=True)
class Activation:
    """An elementwise activation: `kind` with the affine factors of
    identity, sigmoid, tanh and softplus (inner, outer, shift), or its
    parameter `a` (leaky_relu's slope, identity_tanh's fac, power's
    exponent, gaussian's sigma)."""
    kind: str
    inner: float = 1.0
    outer: float = 1.0
    shift: float = 0.0
    a: float = 0.0

    elementwise = True

    def __call__(self, x, ctx=None, dtype=None):
        """dtype: the storage dtype of a low-precision chain (the MLP's
        layers under the bf16 policy), whose constants JAX rounds to it
        (weakly typed scalars); the caller rounds the result."""
        kind, inner, outer, shift, a = self.leaf()
        return leaf_value((kind, _const(inner, dtype), _const(outer, dtype),
                           _const(shift, dtype), _const(a, dtype)), x)

    def n_leaves(self):
        return 1

    def basic(self):
        """One of the kinds K1's default instantiation evaluates."""
        return KINDS[self.kind] < BASIC_KINDS

    def leaf(self):
        """(kind code, inner, outer, shift, a): f(x) = g(x * inner +
        shift) * outer with g the kind's function of its parameter a
        (identity_tanh: x * 2 in, fac / 2 folded into g; csrc/
        pack_build.cuh act_leaf)."""
        k = KINDS[self.kind]
        if self.kind in ("identity", "sigmoid", "tanh", "softplus"):
            return (k, self.inner, self.outer, self.shift, 0.0)
        if self.kind == "identity_tanh":
            return (k, 2.0, 1.0, 0.0, self.a)
        return (k, 1.0, 1.0, 0.0, self.a)

    def kernel_terms(self, it):
        """(c0, ((c, leaf), ...)): the activation at iteration `it` as
        c0 + sum c * f_leaf(x); `it` None: without a context (an ease
        gives its inner activation, an interp its second)."""
        return 0.0, ((1.0, self.leaf()),)


@dataclass(frozen=True)
class EaseValue:
    """ease_value: weight(it) blends start_value into the inner activation
    (reference nlf/activations.py:462-497)."""
    inner: object
    start_value: float
    wait: float
    window: float

    @property
    def elementwise(self):
        return self.inner.elementwise

    def weight(self, it):
        return schedule_weight(it, self.wait, self.window)

    def __call__(self, x, ctx=None, dtype=None):
        out = self.inner(x, ctx, dtype)
        if ctx is None:
            return out
        w = self.weight(ctx.it)
        return w * out + (1.0 - w) * self.start_value

    def n_leaves(self):
        return self.inner.n_leaves()

    def basic(self):
        return self.inner.basic()

    def kernel_terms(self, it):
        c0, leaves = self.inner.kernel_terms(it)
        if it is None:
            return c0, leaves
        w = np.float32(self.weight(it))
        return (float(w * np.float32(c0) + (np.float32(1.0) - w)
                      * np.float32(self.start_value)),
                tuple((float(w * np.float32(c)), f) for c, f in leaves))


@dataclass(frozen=True)
class InterpValue:
    """interp_value: (1 - w(it)) act1 + w(it) act2, act2 alone without a
    context (reference nlf/activations.py:499-535)."""
    act1: object
    act2: object
    wait: float
    window: float

    @property
    def elementwise(self):
        return self.act1.elementwise and self.act2.elementwise

    def weight(self, it):
        return schedule_weight(it, self.wait, self.window)

    def __call__(self, x, ctx=None, dtype=None):
        if ctx is None:
            return self.act2(x, ctx, dtype)
        w = self.weight(ctx.it)
        return (1.0 - w) * self.act1(x, ctx, dtype) \
            + w * self.act2(x, ctx, dtype)

    def n_leaves(self):
        return self.act1.n_leaves() + self.act2.n_leaves()

    def basic(self):
        return False

    def kernel_terms(self, it):
        b0, lb = self.act2.kernel_terms(it)
        if it is None:
            return b0, lb
        w = np.float32(self.weight(it))
        a0, la = self.act1.kernel_terms(it)
        v = np.float32(1.0) - w
        return (float(v * np.float32(a0) + w * np.float32(b0)),
                tuple((float(v * np.float32(c)), f) for c, f in la)
                + tuple((float(w * np.float32(c)), f) for c, f in lb))


def _rows(x, pc):
    """x [..., C] viewed as [..., C / pc, pc]."""
    return x.reshape(x.shape[:-1] + (-1, pc))


def _safe_div(x, n):
    return x / torch.clamp_min(n, 1e-12)


@dataclass(frozen=True)
class VectorActivation:
    """A kind that mixes a row's channels (plain torch, the JAX closures'
    operations); K1 does not take these, and a chain with one takes the
    general stage chain."""
    kind: str
    inner: float = 1.0
    outer: float = 1.0
    pc: int = 3              # param_channels of the row kinds
    fac: float = 1.0

    elementwise = False

    def n_leaves(self):
        return 0

    def basic(self):
        return False

    def __call__(self, x, ctx=None, dtype=None):
        from hyperreel_tpu_torch.ops.rotation import axis_angle_to_matrix
        k = self.kind
        if k == "softmax":
            e = torch.exp(x - x.amax(-1, keepdim=True))
            return e / e.sum(-1, keepdim=True)
        if k == "l1_norm":
            return _safe_div(x, _abs(x).sum(-1, keepdim=True)) * x.shape[-1]
        if k == "l2_norm":
            return _safe_div(x, torch.linalg.norm(x, dim=-1, keepdim=True))
        if k in ("row_l2_norm", "row_l1_norm", "row_linf_norm",
                 "row_l2_norm_z_only"):
            xr = _rows(x, self.pc)
            if k == "row_l2_norm":
                n = torch.linalg.norm(xr, dim=-1, keepdim=True)
            elif k == "row_l1_norm":
                n = _abs(xr).sum(-1, keepdim=True)
            elif k == "row_linf_norm":
                n = _abs(xr).amax(-1, keepdim=True)
            else:
                n = _abs(xr[..., -1:])
            return _safe_div(xr, n).reshape(x.shape)
        if k == "probs":
            x = _abs(x)
            return _safe_div(x, x.sum(-1, keepdim=True))
        if k == "sparse_magnitude":
            xr = x.reshape(x.shape[0], -1, self.pc)
            mag = torch.linalg.norm(xr, dim=-1)
            e = torch.exp(mag * self.inner
                          - (mag * self.inner).amax(-1, keepdim=True))
            mag_sm = e / e.sum(-1, keepdim=True) * self.outer
            unit = _safe_div(xr, torch.linalg.norm(xr, dim=-1, keepdim=True))
            return (unit * mag_sm[..., None]).reshape(x.shape)
        if k in ("twist_to_matrix", "axis_angle_translation"):
            fac = self.fac if k == "axis_angle_translation" else 1.0
            w, v = x[..., :3], x[..., 3:6]
            if fac != 1.0:
                w, v = w * fac, v * fac
            R = axis_angle_to_matrix(w)
            return torch.cat([R.reshape(x.shape[:-1] + (9,)), v], -1)
        raise ValueError(k)


def get_activation(cfg):
    """str or {'type': ...} config -> activation (reference
    nlf/activations.py:566-570)."""
    if cfg is None:
        return Activation("identity")
    t = cfg if isinstance(cfg, str) else cfg.get("type", "identity")
    if t in ("identity", "sigmoid", "tanh", "softplus"):
        return Activation(t, *_affine_params(cfg))
    if t in ("alpha", "rgba"):
        return Activation("sigmoid")
    if t in ("relu", "abs", "zero"):
        return Activation(t)
    if t == "leaky_relu":
        return Activation(t, a=float(_cfg_get(cfg, "a", 0.01)))
    if t == "identity_tanh":
        return Activation(t, a=float(_cfg_get(cfg, "fac", 1.0)))
    if t == "power":
        return Activation(t, a=float(_cfg_get(cfg, "power", 1.0)))
    if t == "gaussian":
        return Activation(t, a=float(_cfg_get(cfg, "sigma", 1.0)))
    if t == "ease_value":
        return EaseValue(get_activation(cfg["activation"]),
                         float(cfg.get("start_value", 0.0)),
                         float(cfg.get("wait_iters", 0.0)),
                         float(cfg.get("window_iters", 0.0)))
    if t == "interp_value":
        return InterpValue(get_activation(cfg["act1"]),
                           get_activation(cfg["act2"]),
                           float(cfg.get("wait_iters", 0.0)),
                           float(cfg.get("window_iters", 0.0)))
    if t in VECTOR_KINDS:
        return VectorActivation(
            t, float(_cfg_get(cfg, "inner_fac", 1.0)),
            float(_cfg_get(cfg, "outer_fac", 1.0)),
            int(_cfg_get(cfg, "param_channels", 3)),
            float(_cfg_get(cfg, "fac", 1.0)))
    raise ValueError(f"unknown activation {t!r}")


def kernel_act(act):
    """True where K1 takes `act` (elementwise, at most MAX_LEAVES
    functions)."""
    return act.elementwise and act.n_leaves() <= MAX_LEAVES
