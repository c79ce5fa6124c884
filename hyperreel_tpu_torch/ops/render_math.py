"""Volume-rendering math (port of hyperreel_tpu/ops/render_math.py;
reference utils/tensorf_utils.py:242-273).

`raw2alpha` keeps the log-direct transmittance: the exclusive cumulative
sum of max(-sigma*dist, log 1e-10), never log(1 - alpha).
"""

import torch

LOG_EPS = -23.025850929940457   # log(1e-10), the reference's cumprod epsilon
EXP_CLAMP = 70.0


def raw2alpha(sigma, dist):
    """sigma, dist [B, S] (dist already scaled) -> (alpha, weights,
    bg_weight [B, 1])."""
    x = torch.clamp(sigma * dist, -EXP_CLAMP, EXP_CLAMP)
    alpha = 1.0 - torch.exp(-x)
    log_t = torch.cumsum(torch.clamp_min(-x, LOG_EPS), -1)
    t_excl = torch.exp(torch.cat(
        [torch.zeros_like(log_t[..., :1]), log_t[..., :-1]], -1))
    return alpha, alpha * t_excl, torch.exp(log_t[..., -1:])


def alpha2weights(alpha):
    """Weights from pre-computed alphas (reference
    utils/tensorf_utils.py:256-265), with a floored log."""
    log_t = torch.cumsum(torch.log(torch.clamp_min(1.0 - alpha, 1e-10)), -1)
    t_excl = torch.exp(torch.cat(
        [torch.zeros_like(log_t[..., :1]), log_t[..., :-1]], -1))
    return alpha * t_excl


def scale_shift_color_all(rgb, color_scale, color_shift):
    """Per-sample affine colour calibration: rgb * (scale + 1) + shift."""
    return rgb * (color_scale + 1.0) + color_shift


def scale_shift_color_one(rgb_map, color_scale_global, color_shift_global):
    """Per-ray (global) affine calibration of the composited colour [B, 3]
    (reference utils/tensorf_utils.py:275-281)."""
    return rgb_map * (color_scale_global + 1.0) + color_shift_global


def transform_color_all(rgb, color_transform, color_shift):
    """Per-sample residual 3x3 colour transform (reference
    utils/tensorf_utils.py:283-306): rgb [B, S, 3], color_transform [B, S,
    3, 3], color_shift [B, S, 3] -> rgb_c + rgb . M[c, :] + shift_c."""
    mixed = torch.einsum("...i,...ci->...c", rgb, color_transform)
    return rgb + mixed + color_shift


def transform_color_one(rgb_map, color_transform_global, color_shift_global):
    """Per-ray residual 3x3 transform of the composited colour (reference
    utils/tensorf_utils.py:308-331): transform [B, 3, 3], shift [B, 3]."""
    mixed = torch.einsum("bi,bci->bc", rgb_map, color_transform_global)
    return rgb_map + mixed + color_shift_global
