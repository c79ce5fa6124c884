"""Ray generation math (port of hyperreel_tpu/ops/ray_math.py
get_ray_directions_K and get_rays; reference utils/ray_utils.py), numpy on
the host: the datasets precompute their rays."""

import numpy as np


def get_ray_directions_K(H, W, K, centered_pixels=False, flipped=False):
    """Per-pixel camera-space ray directions from intrinsics K
    (reference utils/ray_utils.py:103-118): [H, W, 3], x right, y up, z
    backward: ((i - cx)/fx, -(j - cy)/fy, -1)."""
    j, i = np.meshgrid(np.arange(H, dtype=np.float32),
                       np.arange(W, dtype=np.float32), indexing="ij")
    off = 0.5 if centered_pixels else 0.0
    y = (j - K[1][2] + off) / K[1][1]
    return np.stack([(i - K[0][2] + off) / K[0][0],
                     y if flipped else -y, -np.ones_like(i)], -1)


def get_rays(directions, c2w, normalize=True):
    """Camera-space directions [..., 3] rotated into world space by c2w
    [3, 4], the origin broadcast (reference utils/ray_utils.py:120-135)
    -> (rays_o, rays_d), each [N, 3]."""
    c2w = np.asarray(c2w)
    rays_d = directions @ c2w[:, :3].T
    if normalize:
        rays_d = rays_d / np.maximum(
            np.linalg.norm(rays_d, axis=-1, keepdims=True), 1e-12)
    rays_o = np.broadcast_to(c2w[:, 3], rays_d.shape)
    return rays_o.reshape(-1, 3).copy(), rays_d.reshape(-1, 3)
