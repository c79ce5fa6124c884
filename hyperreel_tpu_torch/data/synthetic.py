"""Synthetic scenes for tests and the card's training runs, no download
needed (port of hyperreel_tpu/data/synthetic.py).

The ground truth of the two scenes is a dense ray march of an analytic
field: a few coloured gaussian blobs (gaussian_blob_scene), or the hostile
scene's thin occluders, textured wall and specular sphere (hostile_scene),
so that a model that trains can fit it and its PSNR means something. The
rays are the JAX package's to the bit; the march runs in torch on a device
(a scene of millions of rays in seconds on the card), its colours the JAX
package's numpy march's within f32 rounding. random_ray_dataset draws its
rays and colours with numpy, as the JAX package's.
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


def _hostile_field(points, dirs, t_norm=0.0):
    """The hostile scene's density and view-dependent rgb at points [N, 3]
    seen along unit directions [N, 3] (hyperreel_tpu/data/synthetic.py
    _hostile_field): a textured back wall (a multi-band sinusoid times a
    checker), three thin near-opaque bars in front of it (hard occlusion
    edges; the middle bar moves with t_norm), and a sharp-edged sphere
    with a Blinn lobe (view-dependent colour)."""
    dev = points.device
    x, y, z = points[:, 0], points[:, 1], points[:, 2]

    def edge(v, k=200.0):
        return 1.0 / (1.0 + torch.exp(torch.clamp(-k * v, -30, 30)))

    def vec(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    # 1. the textured back wall: the slab z in [-0.85, -0.72]
    wall = 60.0 * edge(z - (-0.85)) * edge((-0.72) - z)
    tex = torch.stack([
        0.5 + 0.5 * torch.sin(19.0 * x) * torch.sin(23.0 * y),
        0.5 + 0.5 * torch.sin(31.0 * x + 1.3) * torch.cos(17.0 * y),
        0.5 + 0.5 * torch.cos(27.0 * x) * torch.sin(29.0 * y + 0.7),
    ], -1)
    checker = torch.remainder(torch.floor(x * 6.0) + torch.floor(y * 6.0),
                              2.0)
    tex = tex * (0.35 + 0.65 * checker[:, None])
    sigma = wall
    rgb_acc = wall[:, None] * tex

    # 2. the thin bars
    bar_x = [-0.45, -0.05 + 0.25 * t_norm, 0.40]
    bar_c = ([0.95, 0.45, 0.1], [0.15, 0.85, 0.35], [0.9, 0.15, 0.6])
    for bx, bc in zip(bar_x, bar_c):
        bar = (200.0 * edge(0.028 - torch.abs(x - bx), 400.0)
               * edge(0.7 - torch.abs(y)) * edge(z - 0.24) * edge(0.32 - z))
        sigma = sigma + bar
        rgb_acc = rgb_acc + bar[:, None] * vec(bc)

    # 3. the specular sphere
    rel = points - vec([0.1, -0.05, -0.2])
    r = torch.sqrt(torch.sum(rel ** 2, -1) + 1e-12)
    sph = 50.0 * edge(0.25 - r, 60.0)
    n = rel / r[:, None]
    light = np.array([0.5, 0.8, 0.6], np.float32)
    light /= np.linalg.norm(light)
    h = vec(light)[None] - dirs
    h = h / torch.clamp_min(torch.linalg.norm(h, dim=-1, keepdim=True), 1e-8)
    spec = torch.clamp_min(torch.sum(n * h, -1), 0.0) ** 64
    sph_rgb = vec([0.12, 0.18, 0.3])[None] + 0.9 * spec[:, None]
    sigma = sigma + sph
    rgb_acc = rgb_acc + sph[:, None] * sph_rgb

    rgb = rgb_acc / torch.clamp_min(sigma[:, None], 1e-8)
    return sigma, torch.clamp(rgb, 0.0, 1.0)


def _march_viewdep(rays_o, rays_d, t_norm, near, far, device, n_steps=512,
                   chunk=262144):
    """Dense ray march of the hostile field on `device`, chunks of `chunk`
    rays -> rgb [N, 3] numpy. 512 steps put ~10 samples in each 0.056-thick
    bar.

    The view directions are the JAX package's: it divides a chunk's
    directions by np.linalg.norm(d, -1), whose second argument is the
    norm's order, not its axis, so by the chunk's matrix norm of order -1
    (its least column sum of |d|), not ray by ray. The port keeps that,
    and the chunk of 262,144 rays, so that a seed makes the same scene in
    both packages; it leaves the sphere's highlight nearly
    view-independent (ROADMAP.md section 3)."""
    t = torch.from_numpy(np.linspace(near, far, n_steps, dtype=np.float32)
                         ).to(device)
    delta = (far - near) / (n_steps - 1)
    o_all = torch.from_numpy(np.ascontiguousarray(rays_o)).to(device)
    d_all = torch.from_numpy(np.ascontiguousarray(rays_d)).to(device)
    out = []
    for s in range(0, len(rays_o), chunk):
        o, d = o_all[s:s + chunk], d_all[s:s + chunk]
        pts = o[:, None, :] + d[:, None, :] * t[None, :, None]
        dn = d / torch.clamp_min(d.abs().sum(0).min(), 1e-8)
        dirs = dn[:, None, :].expand(pts.shape)
        sigma, rgb = _hostile_field(pts.reshape(-1, 3), dirs.reshape(-1, 3),
                                    t_norm)
        sigma = sigma.reshape(len(o), n_steps)
        rgb = rgb.reshape(len(o), n_steps, 3)
        alpha = 1.0 - torch.exp(-sigma * delta)
        T = torch.cumprod(1.0 - alpha + 1e-10, -1)
        T = torch.cat([torch.ones_like(T[:, :1]), T[:, :-1]], -1)
        out.append(((alpha * T)[..., None] * rgb).sum(1))
    return torch.cat(out).cpu().numpy()


def hostile_scene(n_views=8, wh=(96, 96), dynamic=False, num_frames=8,
                  num_keyframes=4, cam_distance=2.0, n_steps=512,
                  device="cuda"):
    """The hostile procedural scene: gaussian_blob_scene's cameras, ray
    layout and bounds, with thin occluders, high-frequency texture and
    specular view-dependent colour (`_hostile_field`). The march runs on
    `device`, the card unless the caller names the CPU."""
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
            rgb = _march_viewdep(rays_o, rays_d, t_norm, 0.5, 3.5, device,
                                 n_steps=n_steps)
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


def random_ray_dataset(n_rays=65536, dynamic=False, seed=0):
    """Random rays and colours from numpy's generator (the JAX package's
    draws), for runs where the content does not matter (the analogue of
    datasets/random.py)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.5, 0.5, (n_rays, 3)).astype(np.float32)
    o[:, 2] += 2.0
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 0.5
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    cols = [o, d]
    if dynamic:
        cols.append(rng.integers(0, 8, (n_rays, 1)).astype(np.float32))
        cols.append(rng.uniform(0, 1, (n_rays, 1)).astype(np.float32))
    coords = np.concatenate(cols, -1)
    rgb = rng.uniform(0, 1, (n_rays, 3)).astype(np.float32)
    return RayDataset(
        all_coords=coords, all_rgb=rgb, img_wh=(256, 256),
        num_images=n_rays // 65536 + 1,
        num_keyframes=4 if dynamic else 1,
        num_frames=8 if dynamic else 1,
        num_views=8,
        near=0.5, far=3.5, depth_range=(0.5, 3.5),
    )
