"""Loss registry (port of hyperreel_tpu/train/losses.py; reference
losses.py:11-165): `get_loss(cfg)` -> fn(inputs, targets, **kw) -> a 0-d
tensor."""

import torch


def mse_loss(cfg=None):
    def fn(inputs, targets, **kw):
        return ((inputs - targets) ** 2).mean()

    return fn


def mae_loss(cfg=None):
    def fn(inputs, targets, **kw):
        return (inputs - targets).abs().mean()

    return fn


def huber_loss(cfg=None):
    delta = float(cfg.get("delta", 1.0)) if cfg else 1.0

    def fn(inputs, targets, **kw):
        abs_err = (inputs - targets).abs()
        quad = torch.clamp_max(abs_err, delta)
        return (0.5 * quad ** 2 + delta * (abs_err - quad)).mean()

    return fn


def weighted_mse_loss(cfg=None):
    def fn(inputs, targets, weights=None, **kw):
        se = (inputs - targets) ** 2
        return se.mean() if weights is None else (se * weights).mean()

    return fn


def weighted_mae_loss(cfg=None):
    def fn(inputs, targets, weights=None, **kw):
        ae = (inputs - targets).abs()
        return ae.mean() if weights is None else (ae * weights).mean()

    return fn


def mse_top_n_loss(cfg=None):
    """Mean over the N largest per-element errors, N = frac of them
    (reference losses.py:108-129)."""
    frac = float(cfg.get("frac", 1.0)) if cfg else 1.0

    def fn(inputs, targets, **kw):
        se = ((inputs - targets) ** 2).reshape(-1)
        n = max(int(se.shape[0] * frac), 1)
        return torch.topk(se, n).values.mean()

    return fn


def mae_top_n_loss(cfg=None):
    frac = float(cfg.get("frac", 1.0)) if cfg else 1.0

    def fn(inputs, targets, **kw):
        ae = (inputs - targets).abs().reshape(-1)
        n = max(int(ae.shape[0] * frac), 1)
        return torch.topk(ae, n).values.mean()

    return fn


def complex_mse_loss(cfg=None):
    def fn(inputs, targets, **kw):
        d = inputs - targets
        return (d * d.conj()).real.mean()

    return fn


def complex_mae_loss(cfg=None):
    def fn(inputs, targets, **kw):
        return (inputs - targets).abs().mean()

    return fn


def tv_loss(cfg=None):
    """Mean squared differences along the last two axes."""
    def fn(inputs, targets=None, **kw):
        h = ((inputs[..., 1:, :] - inputs[..., :-1, :]) ** 2).mean()
        w = ((inputs[..., :, 1:] - inputs[..., :, :-1]) ** 2).mean()
        return h + w

    return fn


loss_dict = {
    "mse": mse_loss,
    "mae": mae_loss,
    "huber": huber_loss,
    "weighted_mse": weighted_mse_loss,
    "weighted_mae": weighted_mae_loss,
    "mse_top_n": mse_top_n_loss,
    "mae_top_n": mae_top_n_loss,
    "complex_mse": complex_mse_loss,
    "complex_mae": complex_mae_loss,
    "tv": tv_loss,
}


def get_loss(cfg):
    if cfg is None:
        return mse_loss()
    if isinstance(cfg, str):
        return loss_dict[cfg]()
    return loss_dict[cfg["type"]](cfg)
