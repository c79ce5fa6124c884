"""Blender synthetic dataset (port of hyperreel_tpu/data/blender.py;
reference datasets/blender.py).

transforms_{split}.json with camera_angle_x and each frame's
transform_matrix; RGBA images composited onto white (reference
datasets/blender.py:54-72). Ray layout [o, d, cam_idx] = 7.
"""

import json
import os

import numpy as np

from hyperreel_tpu_torch.data.base import RayDataset
from hyperreel_tpu_torch.data.image_io import read_rgb
from hyperreel_tpu_torch.ops.ray_math import get_ray_directions_K, get_rays


def read_composited(path, img_wh, white_bg=True):
    """An RGBA render resized in its own mode and composited onto white
    (or black) -> [H * W, 3]; an image with no alpha reads as opaque."""
    img = read_rgb(path, img_wh, alpha=True, resize_first=True)
    rgb = img[..., :3] * img[..., 3:] + (
        (1.0 - img[..., 3:]) if white_bg else 0.0)
    return rgb.reshape(-1, 3)


def load_blender(root_dir, split="train", img_wh=(800, 800), white_bg=True):
    meta_split = {"train": "train", "val": "val", "test": "test",
                  "render": "test"}[split]
    with open(os.path.join(root_dir,
                           f"transforms_{meta_split}.json")) as f:
        meta = json.load(f)

    W, H = img_wh
    focal = 0.5 * 800 / np.tan(0.5 * meta["camera_angle_x"])
    focal *= W / 800.0
    K = [[focal, 0, W / 2.0], [0, focal, H / 2.0], [0, 0, 1]]
    directions = get_ray_directions_K(H, W, K, centered_pixels=True)

    coords_list, rgb_list = [], []
    for idx, frame in enumerate(meta["frames"]):
        c2w = np.array(frame["transform_matrix"])[:3, :4]
        rays_o, rays_d = get_rays(directions, c2w)
        cam_idx = np.full((rays_o.shape[0], 1), idx, np.float32)
        coords_list.append(np.concatenate(
            [rays_o, rays_d, cam_idx], -1).astype(np.float32))
        rgb_list.append(read_composited(
            os.path.join(root_dir, frame["file_path"] + ".png"), img_wh,
            white_bg))

    return RayDataset(
        all_coords=np.concatenate(coords_list, 0),
        all_rgb=np.concatenate(rgb_list, 0),
        img_wh=img_wh,
        num_images=len(meta["frames"]),
        num_views=len(meta["frames"]),
        near=2.0,
        far=6.0,
        depth_range=(2.0, 6.0),
    )
