"""LLFF-style static forward-facing dataset (port of
hyperreel_tpu/data/llff.py; reference datasets/llff.py).

poses_bounds.npy and images/: the poses corrected, a ray per pixel
(optionally NDC), the flat ray store made. Ray layout [o(3), d(3),
cam_idx(1)] = 7 (reference datasets/llff.py:125-143).
"""

import os

import numpy as np

from hyperreel_tpu_torch.data.base import RayDataset
from hyperreel_tpu_torch.data.image_io import image_size, read_rgb
from hyperreel_tpu_torch.ops.pose_math import correct_poses_bounds
from hyperreel_tpu_torch.ops.ray_math import (
    get_ndc_rays_fx_fy, get_ray_directions_K, get_rays)


def load_llff(root_dir, split="train", downsample=4, use_ndc=True,
              val_skip=8, val_set=(), val_all=False, img_wh=None):
    poses_bounds = np.load(os.path.join(root_dir, "poses_bounds.npy"))
    image_dir = os.path.join(root_dir, "images")
    image_paths = sorted(os.listdir(image_dir))
    n_images = len(image_paths)

    if img_wh is None:
        w0, h0 = image_size(os.path.join(image_dir, image_paths[0]))
        img_wh = (w0 // downsample, h0 // downsample)
    W_img, H_img = img_wh

    poses = poses_bounds[:, :15].reshape(-1, 3, 5)
    bounds = poses_bounds[:, -2:].copy()

    H, W, focal = poses[0, :, -1]
    K = np.eye(3)
    K[0, 0] = focal * W_img / W
    K[0, 2] = (W / 2.0) * W_img / W
    K[1, 1] = focal * H_img / H
    K[1, 2] = (H / 2.0) * H_img / H

    raw_poses = poses
    poses, _, bounds = correct_poses_bounds(poses[:, :, :4], bounds)

    if not use_ndc:
        # the reference divides by the translations before the correction
        # (llff.py:80-81 reads the uncorrected `poses`)
        bounds = bounds / np.max(np.abs(raw_poses[..., :3, 3]))

    near = bounds.min() * 0.95
    far = bounds.max() * 1.05

    directions = get_ray_directions_K(H_img, W_img, K, centered_pixels=True)

    # the split (reference llff.py:95-115)
    if val_set:
        val_indices = list(val_set)
    elif val_skip != "inf":
        val_indices = list(range(0, n_images, min(n_images, val_skip)))
    else:
        val_indices = []
    train_indices = [i for i in range(n_images) if i not in val_indices]
    if val_all:
        val_indices = list(train_indices)

    indices = train_indices if split == "train" else val_indices

    coords_list, rgb_list = [], []
    for idx in indices:
        c2w = poses[idx][:3, :4]
        rays_o, rays_d = get_rays(directions, c2w)
        rays = np.concatenate([rays_o, rays_d], -1).astype(np.float32)
        if use_ndc:
            # the reference projects at self.near = bounds.min() * 0.95
            # (llff.py:83, 120-123), not NeRF's near = 1
            rays = get_ndc_rays_fx_fy(
                H_img, W_img, K[0, 0], K[1, 1], near,
                rays).astype(np.float32)
        cam_idx = np.full((rays.shape[0], 1),
                          idx if split == "train" else 1, np.float32)
        coords_list.append(np.concatenate([rays, cam_idx], -1))
        rgb_list.append(read_rgb(os.path.join(image_dir, image_paths[idx]),
                                 img_wh).reshape(-1, 3))

    return RayDataset(
        all_coords=np.concatenate(coords_list, 0),
        all_rgb=np.concatenate(rgb_list, 0),
        img_wh=img_wh,
        num_images=len(indices),
        num_views=n_images,
        poses=np.asarray([poses[i][:3, :4] for i in indices], np.float32),
        intrinsics=np.asarray(K, np.float32),
        ndc_params=(float(K[0, 0]), float(K[1, 1]), float(near))
        if use_ndc else None,
        near=float(near) if not use_ndc else 0.0,
        far=float(far) if not use_ndc else 1.0,
        depth_range=(float(near * 2.0), float(far)),
    )
