"""DoNeRF dataset: static scenes with ground-truth depth for the geometry
regularizers (port of hyperreel_tpu/data/donerf.py; reference
datasets/donerf.py).

transforms_{split}.json and dataset_info.json (camera_angle_x,
depth_range, the view cell); depth from `<image>_depth.npz`, made a
distance along the ray by dividing by |dir_z| and set to 0 outside [near,
far] (reference datasets/donerf.py:253-291). The extras carry `depth` [N,
1] and `points` [N, 3].
"""

import json
import os

import numpy as np

from hyperreel_tpu_torch.data.base import RayDataset
from hyperreel_tpu_torch.data.image_io import read_rgb, resize_nearest
from hyperreel_tpu_torch.ops.ray_math import get_ray_directions_K, get_rays


def load_donerf(root_dir, split="train", img_wh=(400, 400), val_num=10,
                center_poses=True):
    split_file = {
        "train": "transforms_train.json",
        "val": "transforms_val.json",
        "test": "transforms_test.json",
        "render": "cam_path_pan.json",
    }[split]
    with open(os.path.join(root_dir, split_file)) as f:
        meta = json.load(f)
    with open(os.path.join(root_dir, "dataset_info.json")) as f:
        info = json.load(f)

    if split == "val":
        meta["frames"] = meta["frames"][:val_num]

    W, H = img_wh
    focal = 0.5 * 800 / np.tan(0.5 * info["camera_angle_x"])
    focal *= W / 800.0
    K = [[focal, 0, W / 2.0], [0, focal, H / 2.0], [0, 0, 1]]
    near, far = info["depth_range"]
    origin = np.array(info["view_cell_center"], np.float32)

    directions = get_ray_directions_K(H, W, K, centered_pixels=True)
    dir_z = np.abs(directions[..., 2]).reshape(-1)

    coords_list, rgb_list, depth_list, points_list = [], [], [], []
    for idx, frame in enumerate(meta["frames"]):
        pose = np.array(frame["transform_matrix"])[:3, :4].astype(np.float32)
        if center_poses:
            pose[:3, -1] -= origin
        rays_o, rays_d = get_rays(directions, pose)
        cam_idx = np.full((rays_o.shape[0], 1), idx, np.float32)
        coords_list.append(np.concatenate(
            [rays_o, rays_d, cam_idx], -1).astype(np.float32))

        fp = frame.get("file_path")
        if fp is None:
            # a render path's camera: rays, no image
            rgb_list.append(np.zeros((rays_o.shape[0], 3), np.float32))
            depth_list.append(np.zeros((rays_o.shape[0], 1), np.float32))
            points_list.append(np.zeros((rays_o.shape[0], 3), np.float32))
            continue
        base = os.path.join(root_dir, fp)
        rgb_list.append(read_rgb(
            base + ".png" if not base.endswith(".png") else base, img_wh,
            resize_first=True).reshape(-1, 3))

        depth_path = base.replace(".png", "") + "_depth.npz"
        if os.path.exists(depth_path):
            with np.load(depth_path) as dz:
                depth = dz[dz.files[0]].astype(np.float32).reshape(800, 800)
            if img_wh != (800, 800):
                depth = resize_nearest(depth, img_wh)
            depth = depth.reshape(-1)
            # euclidean depth -> distance along the ray (donerf.py:253-285)
            dist = depth / np.maximum(dir_z, 1e-8)
            dist = np.where((dist < near) | (dist > far), 0.0, dist)
            depth_list.append(dist[:, None].astype(np.float32))
            points_list.append(
                (rays_o + rays_d * dist[:, None]).astype(np.float32))
        else:
            depth_list.append(np.zeros((rays_o.shape[0], 1), np.float32))
            points_list.append(np.zeros((rays_o.shape[0], 3), np.float32))

    return RayDataset(
        all_coords=np.concatenate(coords_list, 0),
        all_rgb=np.concatenate(rgb_list, 0),
        img_wh=img_wh,
        num_images=len(meta["frames"]),
        num_views=len(meta["frames"]),
        near=float(near),
        far=float(far),
        depth_range=(float(near), float(far)),
        extras={
            "depth": np.concatenate(depth_list, 0),
            "points": np.concatenate(points_list, 0),
        },
    )
