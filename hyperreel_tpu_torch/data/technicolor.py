"""Technicolor light-field video dataset, the flagship's (port of
hyperreel_tpu/data/technicolor.py; reference datasets/technicolor.py).

A 4 x 4 camera rig with quaternion poses in `cameras_parameters.txt`,
per-scene near and far, NDC rays, the rig's centre camera held out
(`val_pairs` [[2, 2]]), and keyframe-aware pixel subsampling: whole images
every `load_full_step` frames, 1/4 of the pixels on keyframes, 1/8
elsewhere, by a pixel-stride mask (reference technicolor.py:211-236). Ray
layout [o, d, cam_idx, time] = 8.
"""

import csv
import os

import numpy as np
import torch

from hyperreel_tpu_torch.data.base import RayDataset
from hyperreel_tpu_torch.data.image_io import read_rgb
from hyperreel_tpu_torch.ops.pose_math import correct_poses_bounds
from hyperreel_tpu_torch.ops.ray_math import (
    get_ndc_rays_fx_fy, get_ray_directions_K, get_rays)
from hyperreel_tpu_torch.ops.rotation import quaternion_to_matrix

SCENE_BOUNDS = {
    "painter": (1.75, 10.0),
    "trains": (0.65, 10.0),
    "theater": (0.65, 10.0),
    "fabien": (0.35, 2.0),
    "birthday": (1.75, 10.0),
}


def _quat_to_matrix(qx, qy, qz, qw):
    """The rotation of a camera's quaternion, in f32 as the JAX package
    computes it."""
    return quaternion_to_matrix(torch.tensor([qw, qx, qy, qz],
                                             dtype=torch.float32)).numpy()


def _load_cameras(path, img_wh):
    """Parse cameras_parameters.txt (reference technicolor.py:87-115): a
    row per camera, [focal, cx, cy, aspect, ?, qw, qx, qy, qz, ..., tx, ty,
    tz], at 2048 x 1088."""
    intrinsics, poses = [], []
    with open(path) as f:
        reader = csv.reader(f, delimiter=" ")
        for idx, row in enumerate(reader):
            if idx == 0:
                continue
            row = [float(c) for c in row if c.strip() != ""]
            K = np.eye(3)
            K[0, 0] = row[0] * img_wh[0] / 2048
            K[0, 2] = row[1] * img_wh[0] / 2048
            K[1, 1] = row[3] * row[0] * img_wh[1] / 1088
            K[1, 2] = row[2] * img_wh[1] / 1088
            intrinsics.append(K)

            R = _quat_to_matrix(row[6], row[7], row[8], row[5])
            pose = np.eye(4)
            pose[:3, :3] = R.T
            pose[:3, -1] = -R.T @ np.array(row[-3:]).T
            flip = np.diag([1.0, -1.0, -1.0, 1.0])
            pose = flip @ pose @ flip
            poses.append(pose[:3, :4])
    return intrinsics, poses


def subsample_mask(W, H, every, offset):
    """The pixels (i + j + offset) % every == 0 of a W x H image, flat
    (reference technicolor.py:228-236)."""
    j, i = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    return (((i + j + offset) % every) == 0).reshape(-1)


def load_technicolor(root_dir, split="train", collection=None,
                     img_wh=(2048, 1088), start_frame=0, num_frames=50,
                     keyframe_step=4, load_full_step=8,
                     subsample_keyframe_step=4, subsample_keyframe_frac=0.25,
                     subsample_frac=0.125, use_ndc=True,
                     rows=4, cols=4, val_pairs=((2, 2),), val_all=False,
                     lightfield_step=1):
    collection = collection or os.path.basename(os.path.normpath(root_dir))
    W, H = img_wh
    images_per_frame = rows * cols

    image_paths = sorted(os.listdir(os.path.join(root_dir, "images")))
    image_paths = image_paths[
        images_per_frame * start_frame:
        images_per_frame * (start_frame + num_frames)]
    num_frames = len(image_paths) // images_per_frame

    intrinsics, poses = _load_cameras(
        os.path.join(root_dir, "cameras_parameters.txt"), img_wh)
    intrinsics = np.stack(
        [intrinsics for _ in range(num_frames)]).reshape(-1, 3, 3)
    poses = np.stack([poses for _ in range(num_frames)]).reshape(-1, 3, 4)
    K0 = intrinsics[0]

    times = np.tile(np.linspace(0, 1, num_frames)[..., None],
                    (1, images_per_frame)).reshape(-1)

    near, far = SCENE_BOUNDS.get(collection, (0.65, 10.0))
    if collection == "birthday" and len(image_paths) > 377:
        # a broken frame, replaced by another (reference
        # technicolor.py:146-150)
        image_paths[377] = image_paths[361]
        poses[377] = poses[361]
        intrinsics[377] = intrinsics[361]
        times[377] = times[361]

    bounds = np.array([near, far])
    if use_ndc:
        poses, _, bounds = correct_poses_bounds(
            poses, bounds, flip=False, center=True)
    near = bounds.min() * 0.95
    far = bounds.max() * 1.05

    # the light-field holdout (reference technicolor.py:169-198): cameras
    # off the step lattice and the val_pairs validate; a step of 1 with no
    # pairs validates on all
    val_pairs = [list(p) for p in val_pairs]
    step = int(lightfield_step)
    val_all = val_all or (step == 1 and len(val_pairs) == 0)
    val_indices = []
    for row in range(rows):
        for col in range(cols):
            idx = row * rows + col
            if (row % step != 0 or col % step != 0
                    or [row, col] in val_pairs) and not val_all:
                val_indices += [f * images_per_frame + idx
                                for f in range(num_frames)]
    train_indices = [i for i in range(len(image_paths))
                     if i not in val_indices]
    if val_all:
        val_indices = list(train_indices)
    indices = train_indices if split == "train" else val_indices

    coords_list, rgb_list = [], []
    keyframe_offset = 0
    frame_offset = 0
    # a camera's rays are the same in every frame: made once per camera
    # (its intrinsics and pose), the same numbers as image by image
    camera_rays = {}
    for idx in indices:
        cam_idx = (idx % images_per_frame) if (split == "train" or val_all) \
            else 3
        K = intrinsics[idx]
        c2w = poses[idx]
        t = times[idx]
        key = (K.tobytes(), c2w.tobytes())
        if key not in camera_rays:
            directions = get_ray_directions_K(H, W, K, centered_pixels=True)
            rays_o, rays_d = get_rays(directions, c2w)
            rays = np.concatenate([rays_o, rays_d], -1).astype(np.float32)
            if use_ndc:
                rays = get_ndc_rays_fx_fy(
                    H, W, K0[0, 0], K0[1, 1], near, rays).astype(np.float32)
            camera_rays[key] = rays
        rays = camera_rays[key]
        coords = np.concatenate([
            rays,
            np.full((rays.shape[0], 1), cam_idx, np.float32),
            np.full((rays.shape[0], 1), t, np.float32),
        ], -1)
        rgb = read_rgb(os.path.join(root_dir, "images", image_paths[idx]),
                       img_wh).reshape(-1, 3)

        if split == "train":
            frame = int(np.round(t * (num_frames - 1)))
            if (frame % load_full_step) == 0:
                mask = None
            elif (frame % subsample_keyframe_step) == 0:
                every = int(np.round(1.0 / subsample_keyframe_frac))
                mask = subsample_mask(W, H, every, keyframe_offset)
                keyframe_offset += 1
            else:
                every = int(np.round(1.0 / subsample_frac))
                mask = subsample_mask(W, H, every, frame_offset)
                frame_offset += 1
            if mask is not None:
                coords = coords[mask]
                rgb = rgb[mask]

        coords_list.append(coords.astype(np.float32))
        rgb_list.append(rgb)

    return RayDataset(
        all_coords=np.concatenate(coords_list, 0),
        all_rgb=np.concatenate(rgb_list, 0),
        img_wh=img_wh,
        num_images=len(indices),
        poses=np.asarray(poses[:images_per_frame], np.float32),
        intrinsics=np.asarray(K0, np.float32),
        ndc_params=(float(K0[0, 0]), float(K0[1, 1]), float(near))
        if use_ndc else None,
        num_keyframes=num_frames // keyframe_step,
        num_frames=num_frames,
        num_views=images_per_frame,
        near=float(near),
        far=float(far),
        depth_range=(float(near), float(far)),
    )
