"""Ray generation math (port of hyperreel_tpu/ops/ray_math.py; reference
utils/ray_utils.py), numpy on the host: the datasets precompute their
rays."""

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


def get_ndc_rays_fx_fy(H, W, fx, fy, near, rays):
    """Rays [..., 6] moved to the near plane and projected to NDC
    (reference utils/ray_utils.py:137-164) -> [..., 6]."""
    rays_o, rays_d = rays[..., 0:3], rays[..., 3:6]
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d

    ox_oz = rays_o[..., 0] / rays_o[..., 2]
    oy_oz = rays_o[..., 1] / rays_o[..., 2]

    o0 = -1.0 / (W / (2.0 * fx)) * ox_oz
    o1 = -1.0 / (H / (2.0 * fy)) * oy_oz
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]

    d0 = -1.0 / (W / (2.0 * fx)) * (rays_d[..., 0] / rays_d[..., 2] - ox_oz)
    d1 = -1.0 / (H / (2.0 * fy)) * (rays_d[..., 1] / rays_d[..., 2] - oy_oz)
    d2 = 1.0 - o2

    return np.concatenate(
        [np.stack([o0, o1, o2], -1), np.stack([d0, d1, d2], -1)], -1)


def _normalize_rows(v):
    return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-12)


def get_lightfield_rays(U, V, s, t, aspect, st_scale=1.0, uv_scale=1.0,
                        near=-1.0, far=0.0):
    """The two-plane (s, t, u, v) ray grid of one camera (reference
    utils/ray_utils.py:14-45): the origin (s, t) on the z = near plane,
    the directions toward (u, v) on the z = far plane, v top-down ->
    [V * U, 6]."""
    u = np.linspace(-1.0, 1.0, U, dtype=np.float32)
    v = np.linspace(1.0, -1.0, V, dtype=np.float32) / aspect
    vg, ug = np.meshgrid(v, u, indexing="ij")
    u = (ug * uv_scale).reshape(-1)
    v = (vg * uv_scale).reshape(-1)
    s_arr = np.full_like(u, s * st_scale)
    t_arr = np.full_like(v, t * st_scale)

    dirs = np.stack([u - s_arr, v - t_arr, np.full_like(u, far - near)], -1)
    origins = np.stack([s_arr, t_arr, np.full_like(u, near)], -1)
    return np.concatenate([origins, _normalize_rows(dirs)], -1)


def get_epi_rays(U, v, S, t, aspect, st_scale=1.0, uv_scale=1.0,
                 near=-1.0, far=0.0):
    """Epipolar-plane rays: s and u swept for a fixed (v, t) (reference
    utils/ray_utils.py:47-78) -> [S * U, 6]."""
    u = np.linspace(-1.0, 1.0, U, dtype=np.float32)
    s = np.linspace(-1.0, 1.0, S, dtype=np.float32) / aspect
    sg, ug = np.meshgrid(s, u, indexing="ij")
    u = (ug * uv_scale).reshape(-1)
    s_arr = (sg * st_scale).reshape(-1)
    v_arr = np.full_like(u, v * uv_scale)
    t_arr = np.full_like(s_arr, t * st_scale)

    dirs = np.stack([u - s_arr, v_arr - t_arr, np.full_like(u, far - near)],
                    -1)
    origins = np.stack([s_arr, t_arr, np.full_like(u, near)], -1)
    return np.concatenate([origins, _normalize_rows(dirs)], -1)


def get_weight_map(rays, jitter_rays, softmax_temp=1.0):
    """Similarity weights of jittered ray pairs, summing to 1 (reference
    utils/ray_utils.py:166+, the ray-density regularizers)."""
    d = np.linalg.norm(rays - jitter_rays, axis=-1)
    w = np.exp(-d * softmax_temp)
    return w / np.maximum(w.sum(), 1e-12)
