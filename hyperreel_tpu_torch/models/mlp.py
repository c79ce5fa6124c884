"""Skip-connection MLP (port of hyperreel_tpu/models/mlp.py BaseMLP;
reference nlf/nets/mlp.py:60-179).

Parameters are a dict {"layer_i": {"weight": [out, in], "bias": [out]}}
(the nn.Linear layout; `convert.params_from_jax` transposes the JAX
[in, out] weights). Skip layers take [input, hidden] concatenated, input
first. A net with its own `pe` encodes its input first (JAX mlp.py:60-65);
the skip layers then take the encoded input. The fused path's K1 does not
take such a net (hyperreel_tpu fused_eval.py:108): its chain runs the
general stages.

compute_dtype=torch.bfloat16 is the bench's precision policy as the JAX
general path (hyperreel_tpu BaseMLP.apply) runs it: bf16 operands, and
every layer's matmul, bias add and activation stored in bf16. The matmul
is an f32 matmul of the rounded operands, so every product of two bf16
values is exact and the sums are f32, on any device. The fused path runs
the MLP inside the pack-build kernel instead, under the JAX kernel's
policy (ops/kernels/pack_build.py).
"""

import math
from dataclasses import dataclass, field
from typing import List, Optional

import torch

from hyperreel_tpu_torch.models.activations import get_activation
from hyperreel_tpu_torch.models.pe import IdentityPE, get_pe


def round_to(x, dtype):
    """Round f32 values to `dtype` and back (identity for dtype None)."""
    return x if dtype is None else x.to(dtype).float()


def linear_init(gen, fan_in, fan_out, device, bias=True):
    """torch nn.Linear default init: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(max(fan_in, 1))

    def u(*shape):
        return (torch.rand(shape, generator=gen, dtype=torch.float32)
                * (2.0 * bound) - bound).to(device)

    p = {"weight": u(fan_out, fan_in)}
    if bias:
        p["bias"] = u(fan_out)
    return p


def linear(x, p, dtype=None):
    """x [N, in] f32 -> [N, out] f32 under the policy above: operands,
    product and biased sum rounded to `dtype` (no rounding for None)."""
    y = round_to(round_to(x, dtype) @ round_to(p["weight"], dtype).t(), dtype)
    if "bias" in p:
        y = round_to(y + round_to(p["bias"], dtype), dtype)
    return y


@dataclass
class BaseMLP:
    in_channels: int
    out_channels: int
    depth: int
    hidden: int
    skips: List[int] = field(default_factory=list)
    linear_last: bool = True
    bias: bool = True
    activation: str = "identity"
    layer_activation: str = "leaky_relu"
    compute_dtype: Optional[torch.dtype] = None
    pe_cfg: Optional[dict] = None

    def __post_init__(self):
        if self.depth == 0:
            raise NotImplementedError("depth-0 MLPs are not ported")
        self.pe = get_pe(self.in_channels, self.pe_cfg) if self.pe_cfg \
            else IdentityPE(self.in_channels)
        self.net_in = self.pe.out_channels
        self.out_act = get_activation(self.activation)
        self.layer_act = get_activation(self.layer_activation)

    @property
    def act_until(self):
        return self.depth if self.linear_last else self.depth + 1

    def fan_in(self, i):
        if i == 0:
            return self.net_in
        if i in self.skips:
            return self.hidden + self.net_in
        return self.hidden

    def fan_out(self, i):
        return self.out_channels if i == self.depth + 1 else self.hidden

    def init(self, gen, device):
        return {f"layer_{i}": linear_init(gen, self.fan_in(i),
                                          self.fan_out(i), device, self.bias)
                for i in range(self.depth + 2)}

    def apply(self, params, x, ctx=None):
        x = self.pe.apply(x, ctx)
        input_x = x
        cd = self.compute_dtype
        for i in range(self.depth + 2):
            if i in self.skips:
                x = torch.cat([input_x, x], -1)
            x = linear(x, params[f"layer_{i}"], cd)
            if i < self.act_until:
                x = round_to(self.layer_act(x, ctx, cd), cd)
        return self.out_act(x, ctx)


def build_net(in_channels, out_channels, cfg, compute_dtype=None):
    t = cfg.get("type", "base")
    if t not in ("base", "mlp"):
        raise NotImplementedError(
            f"net type {t!r} is not ported (ROADMAP.md: long tail)")
    return BaseMLP(
        in_channels=in_channels, out_channels=out_channels,
        depth=int(cfg.get("depth", 6)),
        hidden=int(cfg.get("hidden_channels", 256)),
        skips=list(cfg.get("skips", [])),
        linear_last=bool(cfg.get("linear_last", True)),
        bias=bool(cfg.get("bias", True)),
        activation=cfg.get("activation", "identity"),
        layer_activation=cfg.get("layer_activation", "leaky_relu"),
        compute_dtype=compute_dtype, pe_cfg=cfg.get("pe"))
