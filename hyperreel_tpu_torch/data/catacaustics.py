"""Catacaustics dataset (port of hyperreel_tpu/data/catacaustics.py;
reference datasets/catacaustics.py): Bundler `bundle.out` cameras and one
numbered image per camera. Ray layout [o, d, cam_idx] = 7."""

import os

import numpy as np

from hyperreel_tpu_torch.data.base import RayDataset
from hyperreel_tpu_torch.data.image_io import image_size, read_rgb
from hyperreel_tpu_torch.ops.ray_math import get_ray_directions_K, get_rays

# the bounds every catacaustics scene is loaded with
NEAR, FAR = 0.1, 10.0


def scene_info():
    """The dataset_info bounds that load_catacaustics gives every scene."""
    return {"near": NEAR, "far": FAR, "depth_range": (NEAR, FAR)}


def read_bundle_folder(cameras_folder, W, H, extension=".png", name_ints=8):
    """Parse bundle.out (reference catacaustics.py:35-100): (poses [N, 3,
    4], intrinsics [N, 3, 3] at W x H, the image paths)."""
    poses, intrinsics, image_paths = [], [], []
    with open(os.path.join(cameras_folder, "bundle.out")) as f:
        f.readline()  # comment
        num_cameras, _ = [int(x) for x in f.readline().split()]
        for idx in range(num_cameras):
            cam_name = f"{idx:0{name_ints}d}{extension}"
            focal, _, _ = [float(x) for x in f.readline().split()]
            R = np.array([[float(x) for x in f.readline().split()]
                          for _ in range(3)])
            T = np.array([float(x) for x in f.readline().split()])
            pose = np.eye(4)
            pose[:3, :3] = R
            pose[:3, -1] = T
            pose = np.linalg.inv(pose)
            poses.append(pose[:3])

            image_path = os.path.join(cameras_folder, cam_name)
            iw, ih = image_size(image_path)
            K = np.eye(3)
            K[0, 0] = focal * W / iw
            K[0, 2] = W / 2.0
            K[1, 1] = focal * H / ih
            K[1, 2] = H / 2.0
            intrinsics.append(K)
            image_paths.append(image_path)
    return np.stack(poses, 0), np.stack(intrinsics, 0), image_paths


def load_catacaustics(root_dir, split="train", img_wh=(800, 533),
                      val_skip=8):
    W, H = img_wh
    sub = {"train": "cameras", "val": "cameras_validation",
           "test": "cameras_test", "render": "cameras_spiral"}.get(
        split, "cameras")
    folder = os.path.join(root_dir, sub)
    if not os.path.isdir(folder):
        folder = os.path.join(root_dir, "cameras")
    poses, intrinsics, image_paths = read_bundle_folder(folder, W, H)

    coords_list, rgb_list = [], []
    for idx in range(len(image_paths)):
        directions = get_ray_directions_K(H, W, intrinsics[idx],
                                          centered_pixels=True)
        rays_o, rays_d = get_rays(directions, poses[idx])
        coords_list.append(np.concatenate([
            rays_o, rays_d,
            np.full((rays_o.shape[0], 1), idx, np.float32),
        ], -1).astype(np.float32))
        rgb_list.append(read_rgb(image_paths[idx], img_wh).reshape(-1, 3))

    return RayDataset(
        all_coords=np.concatenate(coords_list, 0),
        all_rgb=np.concatenate(rgb_list, 0),
        img_wh=img_wh,
        num_images=len(image_paths),
        num_views=len(image_paths),
        **scene_info(),
    )
