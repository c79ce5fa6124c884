"""Chunked renderer (port of hyperreel_tpu/train/render.py;
reference nlf/rendering.py).

Rays are padded to a whole number of `ray_chunk` chunks by repeating the
last ray, as in the JAX package, so every chunk has one shape, and each
chunk runs through `model.apply` in eval on the renderer's device (on the
card the fused routes' kernels: K1 + K2 for the flagship, K1 + K5 for the
static multi-axis nets). The outputs stay on the device until the last
chunk and come to the host in one copy per key, as numpy.

The fused route's tables are built once per `render_rays` call
(`model.prepare_eval`) and passed to every chunk as
render_kwargs["cf_prepared"]; where the JAX package's compiled forward
builds them inside each trace. They are not cached across calls: a
trainer changes the params in place, and a cache keyed on the params
would go stale.
"""

import math

import numpy as np
import torch

from hyperreel_tpu_torch.models.ctx import StepCtx


class Renderer:
    def __init__(self, model, ray_chunk=65536, device="cuda"):
        self.model = model
        self.ray_chunk = int(ray_chunk)
        self.device = torch.device(device)

    def render_rays(self, params, rays, it=0, fields=()):
        """Chunked forward over [N, C] rays (numpy or a tensor) -> dict of
        [N, ...] numpy arrays."""
        rays = torch.as_tensor(np.asarray(rays, np.float32)
                               if not torch.is_tensor(rays) else rays,
                               dtype=torch.float32, device=self.device)
        n = rays.shape[0]
        chunk = self.ray_chunk
        n_chunks = int(math.ceil(n / chunk))
        pad = n_chunks * chunk - n
        if pad > 0:
            rays = torch.cat([rays, rays[-1:].expand(pad, -1)], 0)
        ctx = StepCtx(it=int(it), training=False)
        kw = {"fields": list(fields)} if fields else {}
        with torch.no_grad():
            prep = self.model.prepare_eval(params)
            if prep is not None:
                kw["cf_prepared"] = prep
            outs = [self.model.apply(params, rays[i * chunk:(i + 1) * chunk],
                                     ctx, kw) for i in range(n_chunks)]
            # a per-chunk scalar (a route's witness) keeps one value per
            # chunk, as the JAX package's concatenation does
            return {k: (torch.stack(v) if v[0].dim() == 0
                        else torch.cat(v)[:n]).cpu().numpy()
                    for k, v in ((k, [o[k] for o in outs])
                                 for k in outs[0])}

    def render_image(self, params, rays, wh, it=0, fields=()):
        W, H = wh
        out = self.render_rays(params, rays, it, fields)
        return {k: v.reshape(H, W, *v.shape[1:]) for k, v in out.items()}
