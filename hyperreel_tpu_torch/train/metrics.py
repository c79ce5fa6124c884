"""Image metrics (port of hyperreel_tpu/train/metrics.py; reference
metrics.py:25-58): PSNR, and SSIM with an 11x11 Gaussian window (sigma
1.5), the configuration of skimage's `structural_similarity(...,
gaussian_weights=True, sigma=1.5, use_sample_covariance=False,
data_range=1)` that the reference reports."""

import numpy as np
import torch


def psnr(img, gt, data_range=1.0):
    """Peak signal-to-noise ratio over whole images [H, W, C]."""
    mse = ((img - gt) ** 2).mean()
    return 10.0 * torch.log10((data_range ** 2) / torch.clamp_min(mse, 1e-12))


def _gaussian_kernel(size=11, sigma=1.5):
    x = np.arange(size) - (size - 1) / 2.0
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    g /= g.sum()
    return np.outer(g, g).astype(np.float32)


_SSIM_KERNEL = _gaussian_kernel()


def _filter2(img, kernel):
    """Depthwise 'valid' 2-D convolution over [H, W, C]."""
    C = img.shape[-1]
    x = img.permute(2, 0, 1)[None]                      # [1, C, H, W]
    k = kernel[None, None].expand(C, 1, *kernel.shape)
    out = torch.nn.functional.conv2d(x, k, groups=C)
    return out[0].permute(1, 2, 0)


def ssim(img, gt, data_range=1.0):
    """SSIM over [H, W, C] images; mean over valid windows and channels."""
    C1 = (0.01 * data_range) ** 2
    C2 = (0.03 * data_range) ** 2
    k = torch.as_tensor(_SSIM_KERNEL, device=img.device)
    mu_x = _filter2(img, k)
    mu_y = _filter2(gt, k)
    mu_x2, mu_y2, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    sigma_x2 = _filter2(img * img, k) - mu_x2
    sigma_y2 = _filter2(gt * gt, k) - mu_y2
    sigma_xy = _filter2(img * gt, k) - mu_xy
    num = (2 * mu_xy + C1) * (2 * sigma_xy + C2)
    den = (mu_x2 + mu_y2 + C1) * (sigma_x2 + sigma_y2 + C2)
    return (num / den).mean()


def get_mean_outputs(outputs_list):
    """Aggregate a list of per-image metric dicts into means
    (reference metrics.py:60-93)."""
    if not outputs_list:
        return {}
    keys = outputs_list[0].keys()
    return {k: float(np.mean([float(o[k]) for o in outputs_list]))
            for k in keys}
