"""Spaces dataset (port of hyperreel_tpu/data/spaces.py; reference
datasets/spaces.py): a rig described by models.json (rotation vectors, a
pixel aspect per camera), the splits from train_image.txt and
val_image.txt, the scene bounds from planes.txt. Ray layout [o, d,
cam_idx] = 7.
"""

import json
import os

import numpy as np

from hyperreel_tpu_torch.data.base import RayDataset
from hyperreel_tpu_torch.data.image_io import read_rgb
from hyperreel_tpu_torch.data.immersive import rotvec_to_matrix
from hyperreel_tpu_torch.ops.ray_math import get_ray_directions_K, get_rays


def load_spaces(root_dir, split="train", img_wh=(800, 480)):
    W, H = img_wh
    with open(os.path.join(root_dir, "models.json")) as f:
        meta = json.load(f)

    def read_list(name):
        with open(os.path.join(root_dir, name)) as f:
            return [os.path.join(root_dir, line.strip())
                    for line in f.readlines() if line.strip()]

    train_images = read_list("train_image.txt")
    val_images = read_list("val_image.txt")
    wanted = set(train_images if split == "train" else val_images)

    planes_path = os.path.join(root_dir, "planes.txt")
    if os.path.exists(planes_path):
        with open(planes_path) as f:
            planes = [float(x) for x in f.read().strip().split(" ")]
        near, far = planes[0], planes[-1]
    else:
        near, far = 0.5, 100.0

    flip = np.diag([1.0, -1.0, -1.0, 1.0])
    coords_list, rgb_list = [], []
    cam_counter = 0
    count = 0
    for rig in meta:
        for camera in rig:
            image_path = os.path.join(root_dir, camera["relative_path"])
            cam_id = cam_counter
            cam_counter += 1
            if image_path not in wanted:
                continue
            wf = W / camera["width"]
            hf = H / camera["height"]
            pa = camera["pixel_aspect_ratio"]
            K = np.array([
                [camera["focal_length"] * wf, 0.0,
                 camera["principal_point"][0] * wf],
                [0.0, pa * camera["focal_length"] * hf,
                 camera["principal_point"][1] * hf],
                [0.0, 0.0, 1.0],
            ])
            R = rotvec_to_matrix(camera["orientation"])
            pose = np.eye(4)
            pose[:3, :3] = R.T
            pose[:3, -1] = np.array(camera["position"])
            pose = (flip @ pose @ flip)[:3, :4]

            directions = get_ray_directions_K(H, W, K, centered_pixels=True)
            rays_o, rays_d = get_rays(directions, pose)
            coords_list.append(np.concatenate([
                rays_o, rays_d,
                np.full((rays_o.shape[0], 1), cam_id, np.float32),
            ], -1).astype(np.float32))
            rgb_list.append(read_rgb(image_path, img_wh).reshape(-1, 3))
            count += 1

    return RayDataset(
        all_coords=np.concatenate(coords_list, 0),
        all_rgb=np.concatenate(rgb_list, 0),
        img_wh=img_wh,
        num_images=count,
        num_views=cam_counter,
        near=float(near),
        far=float(far),
        depth_range=(float(near), float(far)),
    )
