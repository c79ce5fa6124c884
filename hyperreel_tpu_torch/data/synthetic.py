"""A synthetic scene for tests and the card's training run, no download
needed (port of hyperreel_tpu/data/synthetic.py gaussian_blob_scene).

The ground truth is a dense ray march of an analytic density field (a few
coloured gaussian blobs), so a model that trains can fit it and its PSNR
means something. The rays are the JAX package's to the bit; the march runs
in torch on a device (a scene of millions of rays in seconds on the card),
its colours the JAX package's numpy march's within f32 rounding.
"""

import numpy as np
import torch

from hyperreel_tpu_torch.data.base import RayDataset
from hyperreel_tpu_torch.ops.ray_math import get_ray_directions_K, get_rays


def _march(rays_o, rays_d, blobs, near, far, device, n_steps=192,
           chunk=1 << 15):
    """Dense ray march of the blobs (density, rgb at each point from a
    list of (center[3], radius, color[3], peak)) on `device`, chunks of
    `chunk` rays -> rgb [N, 3] numpy."""
    t = torch.from_numpy(np.linspace(near, far, n_steps, dtype=np.float32)
                         ).to(device)
    delta = (far - near) / (n_steps - 1)
    o_all = torch.from_numpy(rays_o).to(device)
    d_all = torch.from_numpy(np.ascontiguousarray(rays_d)).to(device)
    out = []
    for s in range(0, len(rays_o), chunk):
        pts = o_all[s:s + chunk, None] + d_all[s:s + chunk, None] \
            * t[None, :, None]
        sigma = torch.zeros(pts.shape[:2], device=device)
        rgb_acc = torch.zeros(pts.shape, device=device)
        for center, radius, color, peak in blobs:
            d2 = ((pts - torch.from_numpy(center).to(device)) ** 2).sum(-1)
            dens = peak * torch.exp(-d2 / (2 * radius ** 2))
            sigma += dens
            rgb_acc += dens[..., None] * torch.from_numpy(color).to(device)
        rgb = rgb_acc / torch.clamp_min(sigma[..., None], 1e-8)
        alpha = 1.0 - torch.exp(-sigma * delta)
        T = torch.cumprod(1.0 - alpha + 1e-10, -1)
        T = torch.cat([torch.ones_like(T[:, :1]), T[:, :-1]], -1)
        out.append(((alpha * T)[..., None] * rgb).sum(1))
    return torch.cat(out).cpu().numpy()


_DEFAULT_BLOBS = [
    (np.array([0.0, 0.0, 0.0], np.float32), 0.25,
     np.array([0.9, 0.2, 0.2], np.float32), 12.0),
    (np.array([0.35, 0.2, 0.1], np.float32), 0.18,
     np.array([0.2, 0.8, 0.3], np.float32), 10.0),
    (np.array([-0.3, -0.25, -0.2], np.float32), 0.2,
     np.array([0.2, 0.3, 0.9], np.float32), 10.0),
]


def gaussian_blob_scene(n_views=8, wh=(32, 32), dynamic=False,
                        num_frames=8, num_keyframes=4, seed=0,
                        cam_distance=2.0, device="cuda"):
    """Forward-facing cameras on a small arc looking at blobs near the
    origin; the dynamic variant moves the first blob along x over the
    frames (rays [o, d, view, t], t = frame / (num_frames - 1)). The
    march runs on `device`, the card unless the caller names the CPU."""
    W, H = wh
    f = 1.2 * W
    K = [[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]]
    dirs = get_ray_directions_K(H, W, K, centered_pixels=True)

    coords_list, rgb_list = [], []
    frames = range(num_frames) if dynamic else [0]
    for view in range(n_views):
        ang = (view / max(n_views - 1, 1) - 0.5) * 0.6
        cx, cy = np.sin(ang) * 0.5, np.cos(ang) * 0.1 - 0.05
        c2w = np.array([
            [1.0, 0.0, 0.0, cx],
            [0.0, 1.0, 0.0, cy],
            [0.0, 0.0, 1.0, cam_distance],
        ], np.float32)
        rays_o, rays_d = get_rays(dirs, c2w)
        for fi in frames:
            t_norm = fi / max(num_frames - 1, 1)
            blobs = [list(b) for b in _DEFAULT_BLOBS]
            if dynamic:
                blobs[0][0] = blobs[0][0] + np.array(
                    [0.3 * t_norm, 0.0, 0.0], np.float32)
            blobs = [tuple(b) for b in blobs]
            rgb = _march(rays_o, rays_d, blobs, 0.5, 3.5, device)
            if dynamic:
                coords = np.concatenate([
                    rays_o, rays_d,
                    np.full((len(rays_o), 1), view, np.float32),
                    np.full((len(rays_o), 1), t_norm, np.float32),
                ], -1)
            else:
                coords = np.concatenate([rays_o, rays_d], -1)
            coords_list.append(coords.astype(np.float32))
            rgb_list.append(rgb)

    return RayDataset(
        all_coords=np.concatenate(coords_list, 0),
        all_rgb=np.concatenate(rgb_list, 0),
        img_wh=wh,
        num_images=n_views * len(list(frames)),
        num_keyframes=num_keyframes if dynamic else 1,
        num_frames=num_frames if dynamic else 1,
        num_views=n_views,
        near=0.5,
        far=3.5,
        depth_range=(0.5, 3.5),
    )
