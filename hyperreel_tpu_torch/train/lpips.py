"""LPIPS perceptual metric (port of hyperreel_tpu/train/lpips.py;
reference metrics.py:54-58, the `lpips` package with net='vgg').

The pretrained VGG16 backbone and the LPIPS linear heads cannot be
downloaded here (DATASETS.md); the graph lights up where a weights file
exists: `HYPERREEL_LPIPS_WEIGHTS` or cfg `params.lpips_weights` names a
`.npz` of the JAX package's schema, or `convert_torch_weights` writes one
from the torch checkpoints.

npz schema
----------
  conv_{i}_w : [kh, kw, cin, cout] f32   (HWIO; i = 0..12, VGG16 convs)
  conv_{i}_b : [cout] f32
  lin_{k}_w  : [c_k] f32                 (k = 0..4, the LPIPS 1x1 heads,
                                          non-negative per-channel weights)

Forward (the lpips package's LPIPS(net='vgg') eval path): inputs in [0, 1]
-> scaled to [-1, 1] -> per-channel shift/scale -> VGG16 conv stack, taps
at relu1_2/relu2_2/relu3_3/relu4_3/relu5_3 -> each tap unit-normalized over
its channels -> squared difference -> per-channel lin weights -> spatial
mean -> sum over taps. `load_weights` keeps the convolutions' weights as
OIHW tensors on the device the caller names.
"""

import os

import numpy as np
import torch
import torch.nn.functional as F

# VGG16 conv plan: output channels per conv, `None` marks 2x2 max-pool
_VGG_PLAN = [64, 64, None, 128, 128, None, 256, 256, 256, None,
             512, 512, 512, None, 512, 512, 512]
# conv indices (0-based over convs only) after whose relu LPIPS taps
_TAPS = {1, 3, 6, 9, 12}

# lpips package ScalingLayer constants
_SHIFT = np.asarray([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.asarray([0.458, 0.448, 0.450], np.float32)


def default_weights_path(cfg_params=None):
    p = (cfg_params or {}).get("lpips_weights") if cfg_params else None
    return p or os.environ.get("HYPERREEL_LPIPS_WEIGHTS")


def load_weights(path, device="cuda"):
    """Load the npz schema into a params dict of f32 tensors on `device`
    (the conv weights as OIHW)."""
    data = np.load(path)
    n_convs = sum(1 for c in _VGG_PLAN if c is not None)
    for i in range(n_convs):
        if f"conv_{i}_w" not in data.files:
            raise KeyError(f"missing conv_{i}_w in {path}")
    for k in range(len(_TAPS)):
        if f"lin_{k}_w" not in data.files:
            raise KeyError(f"missing lin_{k}_w in {path}")
    params = {}
    for k in data.files:
        v = np.asarray(data[k], np.float32)
        if k.startswith("conv_") and k.endswith("_w"):
            v = v.transpose(3, 2, 0, 1)               # HWIO -> OIHW
        params[k] = torch.tensor(np.ascontiguousarray(v), device=device)
    return params


def _vgg_taps(params, x):
    """x: [N, 3, H, W] normalized. Returns the 5 tapped feature maps."""
    taps = []
    ci = 0
    for spec in _VGG_PLAN:
        if spec is None:
            x = F.max_pool2d(x, 2, 2)
            continue
        x = F.conv2d(x, params[f"conv_{ci}_w"], params[f"conv_{ci}_b"],
                     padding=1)
        x = torch.clamp_min(x, 0.0)
        if ci in _TAPS:
            taps.append(x)
        ci += 1
    return taps


def lpips(params, img0, img1):
    """LPIPS distance between [H, W, 3] images in [0, 1] (tensors on the
    params' device) -> 0-d tensor."""
    dev = params["lin_0_w"].device
    shift = torch.as_tensor(_SHIFT, device=dev)
    scale = torch.as_tensor(_SCALE, device=dev)

    def prep(im):
        x = torch.as_tensor(im, dtype=torch.float32, device=dev) * 2.0 - 1.0
        x = (x - shift) / scale
        return x.permute(2, 0, 1)[None]                # [1, 3, H, W]

    with torch.no_grad():
        t0 = _vgg_taps(params, prep(img0))
        t1 = _vgg_taps(params, prep(img1))
        total = torch.zeros((), device=dev)
        for k, (a, b) in enumerate(zip(t0, t1)):
            na = a * torch.rsqrt((a * a).sum(1, keepdim=True) + 1e-10)
            nb = b * torch.rsqrt((b * b).sum(1, keepdim=True) + 1e-10)
            d = (na - nb) ** 2                          # [1, C, H, W]
            w = params[f"lin_{k}_w"][None, :, None, None]
            total = total + (d * w).sum(1).mean()
    return total


def convert_torch_weights(vgg_state, lin_state, out_path):
    """Convert torchvision VGG16 (`features.{n}.weight/bias`) + the lpips
    package's linear heads (`lin{k}.model.1.weight`, [1, C, 1, 1]) into
    the npz schema. Accepts dicts of torch tensors or numpy arrays."""
    def tonp(t):
        return t.detach().cpu().numpy() if torch.is_tensor(t) \
            else np.asarray(t)

    out = {}
    ci = 0
    feat_idx = 0
    for spec in _VGG_PLAN:
        if spec is None:
            feat_idx += 1  # the pool layer
            continue
        w = tonp(vgg_state[f"features.{feat_idx}.weight"])  # [co, ci, kh, kw]
        b = tonp(vgg_state[f"features.{feat_idx}.bias"])
        out[f"conv_{ci}_w"] = np.ascontiguousarray(
            w.transpose(2, 3, 1, 0)).astype(np.float32)
        out[f"conv_{ci}_b"] = b.astype(np.float32)
        ci += 1
        feat_idx += 2  # conv + relu
    for k in range(len(_TAPS)):
        lw = tonp(lin_state[f"lin{k}.model.1.weight"])
        out[f"lin_{k}_w"] = lw.reshape(-1).astype(np.float32)
    np.savez(out_path, **out)
    return out_path
