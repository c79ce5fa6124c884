"""Positional encodings (port of the windowed and basic PEs of
hyperreel_tpu/models/pe.py; reference nlf/pe.py:40-70, 130-224).

The frequency windows depend only on `ctx.it`, so the host evaluates
them as Python floats. The explicit-window, identity-window, ceil,
exclude-identity and base-multiplier variants raise NotImplementedError,
as does every other PE type.
"""

import math
from dataclasses import dataclass

import numpy as np
import torch

_NOT_PORTED = ("window_iters", "window_identity", "ceil",
               "exclude_identity")


@dataclass
class IdentityPE:
    in_channels: int

    @property
    def out_channels(self):
        return self.in_channels

    def apply(self, x, ctx=None):
        return x


class WindowedPE:
    """[x, w_j sin(f_j x), w_j cos(f_j x) ...] with frequency bands
    f = fm ** linspace(1, n, n); frequency j fades in with a cosine
    window over [a*j + wait, a*(j+1) + wait), a = max_freq_iter / n, and
    every weight is 1 when max_freq_iter == 0 (once it >= wait)."""

    def __init__(self, in_channels, cfg):
        if any(cfg.get(k) for k in _NOT_PORTED) \
                or float(cfg.get("base_multiplier", 1.0)) != 1.0:
            raise NotImplementedError(
                "this windowed-PE variant is not ported "
                "(ROADMAP.md: long tail)")
        self.in_channels = in_channels
        n = int(cfg.get("n_freqs", 0))
        self.wait = float(cfg.get("wait_iters", 0))
        self.max_freq_iter = float(cfg.get("max_freq_iter", 0))
        fm = float(cfg.get("freq_multiplier", 2.0))
        self.freq_bands = [float(f) for f in fm ** np.linspace(1.0, n, n)]
        self.window_after = self.max_freq_iter / n if n else 0.0
        self.out_channels = in_channels * (2 * n + 1)

    def weight(self, j, it):
        cur = float(np.float32(it) - np.float32(self.wait))
        if self.max_freq_iter == 0:
            return 0.0 if cur < 0.0 else 1.0
        if it > self.max_freq_iter:
            return 1.0
        if cur < 0.0:
            return 0.0
        a = self.window_after
        alpha = min(max((cur - a * j) / a, 0.0), 1.0)
        return (1.0 - math.cos(math.pi * alpha)) / 2.0

    def apply(self, x, ctx=None):
        out = [x]
        for j, freq in enumerate(self.freq_bands):
            w = self.weight(j, ctx.it) if ctx is not None else 1.0
            out += [w * torch.sin(freq * x), w * torch.cos(freq * x)]
        return torch.cat(out, -1)


class BasicPE:
    """[x, sin(f_j x_c) over every channel c and frequency j, then the
    cosines in the same order] with f = fm ** linspace(1, n, n): sin of
    all frequencies, then cos of all (hyperreel_tpu basic_pe)."""

    def __init__(self, in_channels, cfg):
        self.in_channels = in_channels
        n = int(cfg.get("n_freqs", 0))
        fm = float(cfg.get("freq_multiplier", 2.0))
        self.freq_bands = (fm ** np.linspace(1.0, n, n)).astype(np.float32)
        self.out_channels = in_channels * (2 * n + 1)

    def apply(self, x, ctx=None):
        if not len(self.freq_bands):
            return x
        arg = (x.new_tensor(self.freq_bands) * x[..., None]).reshape(
            x.shape[:-1] + (-1,))
        return torch.cat([x, torch.sin(arg), torch.cos(arg)], -1)


def get_pe(in_channels, cfg):
    if cfg is None or cfg.get("type") == "identity":
        return IdentityPE(in_channels)
    if cfg["type"] == "windowed":
        return WindowedPE(in_channels, cfg)
    if cfg["type"] == "basic":
        return BasicPE(in_channels, cfg)
    raise NotImplementedError(
        f"PE {cfg['type']!r} is not ported (ROADMAP.md: long tail)")
