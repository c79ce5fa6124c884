"""Video3D multi-view video datasets (port of hyperreel_tpu/data/video3d.py;
reference datasets/video3d_static.py, video3d_time.py,
video3d_ground_truth.py).

The layout: `images/`, `cameras/*.json` with normalized intrinsics and
`camera_to_world` matrices (optionally corrected by a
`reference_world_to_camera`). The time variant adds a frame axis (images
grouped per frame); the ground-truth variant reads each view's depth from
`geometry/` (npz, or EXR through cv2), clamped to [near, far] and made a
distance along the ray (reference video3d_ground_truth.py:412-427).
"""

import json
import os

import numpy as np

from hyperreel_tpu_torch.data.base import RayDataset
from hyperreel_tpu_torch.data.image_io import read_rgb, resize_nearest
from hyperreel_tpu_torch.ops.pose_math import correct_poses_bounds
from hyperreel_tpu_torch.ops.ray_math import (
    get_ndc_rays_fx_fy, get_ray_directions_K, get_rays)


def _read_cameras(root_dir, W, H, use_reference=False):
    pose_paths = sorted(os.listdir(os.path.join(root_dir, "cameras")))
    poses = []
    K = np.eye(3)
    ref = np.eye(4)
    for i, p in enumerate(pose_paths):
        with open(os.path.join(root_dir, "cameras", p)) as f:
            meta = json.load(f)
        if i == 0:
            K[0, 0] = meta["normalized_focal_length_x"] * W
            K[0, 2] = meta["normalized_principal_point_x"] * W
            K[1, 1] = meta["normalized_focal_length_y"] * H
            K[1, 2] = meta["normalized_principal_point_y"] * H
            if use_reference and "reference_world_to_camera" in meta:
                ref = np.array(meta["reference_world_to_camera"])
        frame = np.array(meta["camera_to_world"])
        poses.append((ref @ frame)[:3, :4])
    return np.stack(poses, 0), K


def load_video3d_static(root_dir, split="train", img_wh=(512, 512),
                        use_ndc=False, use_reference=False, val_skip=8,
                        near=0.75, far=4.0):
    W, H = img_wh
    image_paths = sorted(os.listdir(os.path.join(root_dir, "images")))
    poses, K = _read_cameras(root_dir, W, H, use_reference)
    bounds = np.array([near, far])
    if use_ndc:
        poses, _, bounds = correct_poses_bounds(
            poses, bounds, flip=False, center=True)
        near, far = bounds.min() * 0.95, bounds.max() * 1.05

    val_indices = list(range(0, len(image_paths), val_skip))
    train_indices = [i for i in range(len(image_paths))
                     if i not in val_indices]
    indices = train_indices if split == "train" else val_indices

    directions = get_ray_directions_K(H, W, K, centered_pixels=True)
    coords_list, rgb_list = [], []
    for idx in indices:
        rays_o, rays_d = get_rays(directions, poses[idx])
        rays = np.concatenate([rays_o, rays_d], -1).astype(np.float32)
        if use_ndc:
            # the reference projects at self.near (video3d_static.py:196-199)
            rays = get_ndc_rays_fx_fy(
                H, W, K[0, 0], K[1, 1], near, rays).astype(np.float32)
        coords_list.append(np.concatenate([
            rays, np.full((rays.shape[0], 1), idx, np.float32)], -1))
        rgb_list.append(read_rgb(os.path.join(
            root_dir, "images", image_paths[idx]), img_wh).reshape(-1, 3))

    return RayDataset(
        all_coords=np.concatenate(coords_list, 0).astype(np.float32),
        all_rgb=np.concatenate(rgb_list, 0),
        img_wh=img_wh,
        num_images=len(indices),
        num_views=len(image_paths),
        near=float(near), far=float(far),
        depth_range=(float(near), float(far)),
    )


def load_video3d_time(root_dir, split="train", img_wh=(512, 512),
                      num_frames=None, keyframe_step=4, use_ndc=False,
                      use_reference=False, val_views=(0,),
                      near=0.75, far=4.0):
    """The frame-major layout images/<frame>/<view>.png."""
    W, H = img_wh
    poses, K = _read_cameras(root_dir, W, H, use_reference)
    n_views = len(poses)
    frame_dirs = sorted([d for d in os.listdir(
        os.path.join(root_dir, "images"))
        if os.path.isdir(os.path.join(root_dir, "images", d))])
    if num_frames:
        frame_dirs = frame_dirs[:num_frames]
    num_frames = len(frame_dirs)

    directions = get_ray_directions_K(H, W, K, centered_pixels=True)
    val_views = set(val_views)
    coords_list, rgb_list = [], []
    for f_idx, fd in enumerate(frame_dirs):
        t = f_idx / max(num_frames - 1, 1)
        files = sorted(os.listdir(os.path.join(root_dir, "images", fd)))
        for v_idx, fn in enumerate(files[:n_views]):
            in_val = v_idx in val_views
            if (split == "train") == in_val:
                continue
            rays_o, rays_d = get_rays(directions, poses[v_idx])
            rays = np.concatenate([rays_o, rays_d], -1).astype(np.float32)
            coords_list.append(np.concatenate([
                rays,
                np.full((rays.shape[0], 1), v_idx, np.float32),
                np.full((rays.shape[0], 1), t, np.float32)], -1))
            rgb_list.append(read_rgb(os.path.join(
                root_dir, "images", fd, fn), img_wh).reshape(-1, 3))

    return RayDataset(
        all_coords=np.concatenate(coords_list, 0).astype(np.float32),
        all_rgb=np.concatenate(rgb_list, 0),
        img_wh=img_wh,
        num_images=len(coords_list),
        num_keyframes=max(num_frames // keyframe_step, 1),
        num_frames=num_frames,
        num_views=n_views,
        near=float(near), far=float(far),
        depth_range=(float(near), float(far)),
    )


def _read_depth(path):
    """A depth map from an .npz (its first array) or, through cv2, an
    EXR's first channel."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return z[z.files[0]].astype(np.float32)
    os.environ["OPENCV_IO_ENABLE_OPENEXR"] = "1"
    import cv2

    d = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if d is None:
        raise OSError(f"cv2 could not read the depth map {path}")
    return d[..., 0] if d.ndim == 3 else d


def load_video3d_ground_truth(root_dir, split="train", img_wh=(512, 512),
                              near=0.75, far=4.0, **kwargs):
    """The static variant with each view's depth from geometry/."""
    ds = load_video3d_static(root_dir, split, img_wh, near=near, far=far,
                             **kwargs)
    geo_dir = os.path.join(root_dir, "geometry")
    if not os.path.isdir(geo_dir):
        return ds
    W, H = img_wh
    n_per = W * H
    depth_files = sorted(os.listdir(geo_dir))
    depths = []
    for i in range(ds.num_images):
        if i < len(depth_files):
            d = _read_depth(os.path.join(geo_dir, depth_files[i]))
            if d.shape != (H, W):
                d = resize_nearest(d, img_wh)
            dirs = ds.all_coords[i * n_per:(i + 1) * n_per, 3:6]
            dz = np.abs(dirs[:, 2])
            dist = d.reshape(-1) / np.maximum(dz, 1e-8)
            dist = np.clip(dist, near, far)
            depths.append(dist[:, None].astype(np.float32))
        else:
            depths.append(np.zeros((n_per, 1), np.float32))
    ds.extras["depth"] = np.concatenate(depths, 0)
    ds.extras["points"] = (
        ds.all_coords[:, :3]
        + ds.all_coords[:, 3:6] * ds.extras["depth"]).astype(np.float32)
    return ds
