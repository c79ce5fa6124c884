"""Positional encodings (port of every entry of hyperreel_tpu/models/pe.py
`pe_dict`; reference nlf/pe.py): identity, basic, windowed (with its
explicit windows, identity window, ceil, exclude-identity and base
multiplier), random, windowed_random, select and learnable.

The frequency windows depend only on `ctx.it`, so the host evaluates
them as numbers (in f32, as the JAX package's traced schedule). The
random PEs draw their matrix with numpy `default_rng(seed)`, as the JAX
package does, so both packages hold the same bank.
"""

import math
from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class IdentityPE:
    in_channels: int

    @property
    def out_channels(self):
        return self.in_channels

    def apply(self, x, ctx=None):
        return x


def _cos_window(cur, start, end, ceil):
    """Cosine window in [0, 1] over [start, end) at `cur` (f32)."""
    if end - start <= 0:
        return np.float32(1.0 if cur >= np.float32(start) else 0.0)
    alpha = np.clip((cur - np.float32(start)) / np.float32(end - start),
                    np.float32(0.0), np.float32(1.0))
    w = (np.float32(1.0) - np.cos(np.float32(np.pi) * alpha)) \
        / np.float32(2.0)
    return np.ceil(w) if ceil else w


class WindowedPE:
    """[x, w_j sin(b f_j x), w_j cos(b f_j x) ...] with frequency bands
    f = fm ** linspace(1, n, n) and base multiplier b; frequency j fades
    in with a cosine window over [a*j + wait, a*(j+1) + wait), a =
    max_freq_iter / n (or the explicit `window_iters`; with
    `window_identity` the identity takes the first window and the
    frequencies the next ones), and every weight is 1 when no window is
    set (once it >= wait) or past the last window (reference
    nlf/pe.py:130-224)."""

    def __init__(self, in_channels, cfg):
        self.in_channels = in_channels
        n = int(cfg.get("n_freqs", 0))
        self.wait = float(cfg.get("wait_iters", 0))
        max_freq_iter = float(cfg.get("max_freq_iter", 0))
        fm = float(cfg.get("freq_multiplier", 2.0))
        self.base_mult = float(cfg.get("base_multiplier", 1.0))
        self.ceil = bool(cfg.get("ceil", False))
        self.exclude_identity = bool(cfg.get("exclude_identity", False))
        self.window_identity = 1 if cfg.get("window_identity", False) else 0
        self.freq_bands = [float(f) for f in fm ** np.linspace(1.0, n, n)] \
            if n else []
        explicit = cfg.get("window_iters")
        self.windows = []
        self.max_freq = max_freq_iter
        if max_freq_iter > 0 or explicit is not None:
            a = max_freq_iter / n if n else 0.0
            if explicit is not None:
                self.windows = [tuple(w) for w in explicit]
                self.max_freq = float(np.max(np.asarray(explicit)))
            elif self.window_identity:
                self.windows = [(self.wait, a + self.wait)] + [
                    (a * i + self.wait, a * (i + 1) + self.wait)
                    for i in range(1, n + 1)]
                self.max_freq = (n + 1) * a
            else:
                self.windows = [(a * i + self.wait, a * (i + 1) + self.wait)
                                for i in range(n)]
        self.out_channels = in_channels * (
            2 * n + (0 if self.exclude_identity else 1))

    def weight(self, j, it):
        cur = np.float32(it) - np.float32(self.wait)
        if self.max_freq == 0:
            return 0.0 if cur < 0.0 else 1.0
        w0, w1 = self.windows[j]
        w = _cos_window(cur, w0 - self.wait, w1 - self.wait, self.ceil)
        if cur < 0.0:
            w = 0.0
        return 1.0 if np.float32(it) > np.float32(self.max_freq) \
            else float(w)

    def apply(self, x, ctx=None):
        out = [] if self.exclude_identity else [x]
        for j, freq in enumerate(self.freq_bands):
            w = self.weight(j + self.window_identity, ctx.it) \
                if ctx is not None else 1.0
            arg = x * (self.base_mult * freq)
            out += [w * torch.sin(arg), w * torch.cos(arg)]
        if not out:
            return x[..., :0]
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


def _project(x, B):
    """2 pi (x @ B) for a [in, n] bank B (on x's device)."""
    return 2.0 * math.pi * (x @ B.to(x.device))


def _bank(in_channels, n, sigma, seed):
    """The random PEs' Gaussian bank, drawn as the JAX package draws it."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((in_channels, n)) * sigma).astype(np.float32)


class RandomPE:
    """Gaussian random Fourier features [x, sin 2 pi x B, cos 2 pi x B]
    (reference nlf/pe.py:263-296)."""

    def __init__(self, in_channels, cfg):
        self.in_channels = in_channels
        n = int(cfg.get("n_freqs", 0))
        self.B = torch.from_numpy(_bank(in_channels, n,
                                        float(cfg.get("sigma", 1.0)),
                                        int(cfg.get("seed", 0))))
        self.out_channels = in_channels + 2 * n

    def apply(self, x, ctx=None):
        proj = _project(x, self.B)
        return torch.cat([x, torch.sin(proj), torch.cos(proj)], -1)


class WindowedRandomPE:
    """RandomPE with its columns ordered by frequency magnitude and a
    cosine window that anneals them in, low to high, over max_freq_iter
    iterations after wait_iters (reference nlf/pe.py:298+)."""

    def __init__(self, in_channels, cfg):
        self.in_channels = in_channels
        self.n = int(cfg.get("n_freqs", 0))
        self.wait = float(cfg.get("wait_iters", 0))
        self.max_freq_iter = float(cfg.get("max_freq_iter", 0))
        B = _bank(in_channels, self.n, float(cfg.get("sigma", 1.0)),
                  int(cfg.get("seed", 0)))
        self.B = torch.from_numpy(np.ascontiguousarray(
            B[:, np.argsort(np.linalg.norm(B, axis=0))]))
        self.out_channels = in_channels + 2 * self.n

    def weights(self, it):
        """The n window weights at iteration `it` (f32)."""
        cur = np.float32(it) - np.float32(self.wait)
        alpha = np.clip(cur / np.float32(self.max_freq_iter), 0.0,
                        1.0).astype(np.float32) * np.float32(self.n)
        j = np.arange(self.n, dtype=np.float32)
        return (np.float32(1.0) - np.cos(np.float32(np.pi) * np.clip(
            alpha - j, 0.0, 1.0).astype(np.float32))) / np.float32(2.0)

    def apply(self, x, ctx=None):
        proj = _project(x, self.B)
        s, c = torch.sin(proj), torch.cos(proj)
        if ctx is not None and self.max_freq_iter > 0:
            w = x.new_tensor(self.weights(ctx.it))
            s, c = s * w, c * w
        return torch.cat([x, s, c], -1)


class SelectPE:
    """An inner PE on channels [start, end); the others passed through
    around it, or discarded (reference nlf/pe.py:227-260)."""

    def __init__(self, in_channels, cfg):
        self.in_channels = in_channels
        self.start = int(cfg.get("select_start", 0))
        self.end = int(cfg.get("select_end", in_channels))
        self.discard = bool(cfg.get("discard", False))
        self.inner = get_pe(self.end - self.start, cfg["pe"])
        rest = 0 if self.discard else in_channels - (self.end - self.start)
        self.out_channels = self.inner.out_channels + rest

    def apply(self, x, ctx=None):
        sel = self.inner.apply(x[..., self.start:self.end], ctx)
        if self.discard:
            return sel
        return torch.cat([x[..., :self.start], sel, x[..., self.end:]], -1)


class LearnablePE:
    """A learnable frequency bank B [in, n] (reference nlf/pe.py:398+):
    [x, sin 2 pi x B, cos 2 pi x B]. No stage threads its params (the JAX
    RayPredictionEmbedding and BaseMLP call `apply(x, ctx)`, and no init
    draws B), so there the sin/cos columns are zeros, as in the JAX
    package (ROADMAP.md section 3)."""

    def __init__(self, in_channels, cfg):
        self.in_channels = in_channels
        self.n_freqs = int(cfg.get("n_freqs", 0))
        self.out_channels = in_channels + 2 * self.n_freqs

    def apply(self, x, ctx=None, params=None):
        if params is None:
            return torch.cat([x, x.new_zeros(x.shape[:-1]
                                             + (2 * self.n_freqs,))], -1)
        proj = _project(x, params["B"])
        return torch.cat([x, torch.sin(proj), torch.cos(proj)], -1)


PE_TYPES = {"basic": BasicPE, "windowed": WindowedPE,
            "windowed_random": WindowedRandomPE, "learnable": LearnablePE,
            "random": RandomPE, "select": SelectPE,
            "identity": lambda c, cfg=None: IdentityPE(c)}


def get_pe(in_channels, cfg):
    if cfg is None:
        return IdentityPE(in_channels)
    return PE_TYPES[cfg["type"]](in_channels, cfg)
