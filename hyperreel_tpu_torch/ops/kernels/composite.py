"""Ray-major alpha composite (K7): the standalone entry point
`composite_pallas` of the JAX package (reference math:
utils/tensorf_utils.py:242-253 and the weighted reduce of
tensorf_no_sample.py:231-233).

Replaces hyperreel_tpu/ops/pallas/composite.py:_composite_kernel. CUDA
source: csrc/composite.cu, on K2's warp-shuffle composite
(csrc/shade_core.cuh). Bound on the H100 by device-memory bytes (20 read
per sample, 16 written per ray). Nothing on the render path calls it: it
is a public entry point, like the JAX one.

sigma [B, S], sorted dist [B, S], rgb [B, S, 3] (f32, contiguous),
`scale` -> (rgb_map [B, 3], acc [B]): deltas with a last delta of 1e10,
x = clip(sigma*delta*scale, +-70), weights alpha * exp(exclusive sum of
max(-x, log 1e-10)).
"""

import torch

from hyperreel_tpu_torch.ops.kernels import build
from hyperreel_tpu_torch.ops.render_math import raw2alpha


def composite_plain(sigma, dist, rgb, scale):
    """Plain PyTorch version of the kernel (same inputs and outputs)."""
    deltas = torch.cat([dist[:, 1:] - dist[:, :-1],
                        torch.full_like(dist[:, :1], 1e10)], 1)
    _, w, _ = raw2alpha(sigma, deltas * scale)
    return (w[..., None] * rgb).sum(-2), w.sum(-1)


def _check(sigma, dist, rgb):
    B, S = sigma.shape
    for name, t, shape in (("sigma", sigma, (B, S)), ("dist", dist, (B, S)),
                           ("rgb", rgb, (B, S, 3))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous f32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != sigma.device:
            raise ValueError("sigma, dist and rgb lie on different devices")
    return B, S


def composite(sigma, dist, rgb, scale):
    """Run K7: returns (rgb_map f32 [B, 3], acc f32 [B]). CPU tensors go to
    `composite_plain`; CUDA tensors launch the kernel or raise. Counts
    launches in `composite.launches`."""
    B, S = _check(sigma, dist, rgb)
    if sigma.device.type == "cpu":
        return composite_plain(sigma, dist, rgb, scale)
    if sigma.device.type != "cuda":
        raise ValueError(f"composite has no kernel for {sigma.device}")
    if S > 32 or S & (S - 1):
        raise NotImplementedError(
            f"composite kernel: S={S} not built (a power of two <= 32)")
    out = torch.empty((B, 4), dtype=torch.float32, device=sigma.device)
    lib = build.load_library().lib
    with torch.cuda.device(sigma.device):
        stream = torch.cuda.current_stream().cuda_stream
        build.check_launch(lib.composite_launch(
            sigma.data_ptr(), dist.data_ptr(), rgb.data_ptr(),
            out.data_ptr(), B, S, float(scale), stream), "composite")
    composite.launches += 1
    return out[:, :3], out[:, 3]


composite.launches = 0
