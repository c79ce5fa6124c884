"""Google Immersive light-field video dataset (port of
hyperreel_tpu/data/immersive.py; reference datasets/immersive.py).

A fisheye rig described by models.json (focal, principal point, radial
distortion, rotation vector); the rays come from the pixel grid undistorted
by cv2.fisheye (reference immersive.py:43-48, 515-552), the frames from
cv2.VideoCapture, camera_0001 is held out, and the frames are subsampled
as Neural 3D's (the stride or the importance, immersive.py:294-321). Ray
layout [o, d, cam, t] = 8.
"""

import json
import os

import numpy as np
import torch

from hyperreel_tpu_torch.data.base import RayDataset
from hyperreel_tpu_torch.data.neural_3d import (
    KEYFRAME_STEP, NUM_FRAMES, subsample_frames, window_info)
from hyperreel_tpu_torch.ops.ray_math import get_ray_directions_K, get_rays
from hyperreel_tpu_torch.ops.rotation import axis_angle_to_matrix

SCENE_BOUNDS = {
    "01_Welder": (0.25, 6.0),
    "02_Flames": (1.0, 10.0),
    "04_Truck": (0.5, 10.0),
    "05_Horse": (0.5, 45.0),
    "07_Car": (0.5, 50.0),
    "09_Alexa_Meade_Exhibit": (0.5, 30.0),
    "10_Alexa_Meade_Face_Paint_1": (0.25, 6.0),
    "11_Alexa_Meade_Face_Paint_2": (0.25, 6.0),
    "12_Cave": (0.5, 30.0),
}


def scene_info(collection, num_frames=NUM_FRAMES,
               keyframe_step=KEYFRAME_STEP):
    """The dataset_info that load_immersive gives a scene of `collection`
    over a window of `num_frames`, which needs no file."""
    near, far = SCENE_BOUNDS.get(collection, (0.5, 10.0))
    return dict(window_info(num_frames, keyframe_step), near=float(near),
                far=float(far), depth_range=(float(near * 2.0), float(far)))


def rotvec_to_matrix(rv):
    """The rotation of a rotation vector, in f32 as the JAX package
    computes it."""
    return axis_angle_to_matrix(torch.tensor(rv, dtype=torch.float32)).numpy()


def _fisheye_directions(W, H, K, distortion):
    """Camera-space directions of the pixel grid undistorted by
    cv2.fisheye (reference immersive.py:43-48, 515-540)."""
    import cv2

    dirs = get_ray_directions_K(H, W, K, centered_pixels=True).reshape(-1, 3)
    pts = dirs[:, :2].astype(np.float32)
    und = cv2.fisheye.undistortPoints(
        pts[:, None], np.eye(3, dtype=np.float32),
        np.array([distortion[0], distortion[1], 0.0, 0.0], np.float32),
    )[:, 0]
    out = np.concatenate(
        [und[:, :1], und[:, 1:2], -np.ones_like(und[:, :1])], -1)
    return out / np.linalg.norm(out, axis=-1, keepdims=True)


def load_immersive(root_dir, split="train", collection=None,
                   img_wh=(1280, 960), start_frame=0, num_frames=NUM_FRAMES,
                   keyframe_step=KEYFRAME_STEP, load_full_step=8,
                   subsample_keyframe_step=4, subsample_keyframe_frac=0.25,
                   subsample_frac=0.125, val_all=False,
                   subsample_mode="regular"):
    import cv2

    collection = collection or os.path.basename(os.path.normpath(root_dir))
    W, H = img_wh
    with open(os.path.join(root_dir, "models.json")) as f:
        meta = json.load(f)

    video_paths, intrinsics, distortions, poses = [], [], [], []
    val_idx = 0
    for idx, camera in enumerate(meta):
        video_paths.append(os.path.join(root_dir, camera["name"] + ".mp4"))
        wf = W / 2560.0
        hf = H / 1920.0
        K = np.array([
            [camera["focal_length"] * wf, 0.0,
             camera["principal_point"][0] * wf],
            [0.0, camera["focal_length"] * hf,
             camera["principal_point"][1] * hf],
            [0.0, 0.0, 1.0],
        ])
        intrinsics.append(K)
        distortions.append(np.array(camera["radial_distortion"][:2]))
        R = rotvec_to_matrix(camera["orientation"])
        pose = np.eye(4)
        pose[:3, :3] = R.T
        pose[:3, -1] = np.array(camera["position"])
        flip = np.diag([1.0, -1.0, -1.0, 1.0])
        pose = flip @ pose @ flip
        poses.append(pose[:3, :4])
        if camera["name"] == "camera_0001":
            val_idx = idx

    n_cams = len(video_paths)
    if split == "train" and not val_all:
        cam_indices = [i for i in range(n_cams) if i != val_idx]
    elif split in ("val", "test") and not val_all:
        cam_indices = [val_idx]
    else:
        cam_indices = list(range(n_cams))

    coords_list, rgb_list = [], []
    for video_i, cam_i in enumerate(cam_indices):
        directions = _fisheye_directions(
            W, H, intrinsics[cam_i], distortions[cam_i])
        rays_o, rays_d = get_rays(directions, poses[cam_i])
        # the val split's rays carry camera id 1 (reference
        # immersive.py:494-507)
        cam_id = cam_i if split == "train" else 1
        rays = np.concatenate([
            rays_o, rays_d,
            np.full((rays_o.shape[0], 1), cam_id, np.float32),
        ], -1).astype(np.float32)

        def coords_of(t, rays=rays):
            return np.concatenate(
                [rays, np.full((rays.shape[0], 1), t, np.float32)], -1)

        cap = cv2.VideoCapture(video_paths[cam_i])
        try:
            cap.set(cv2.CAP_PROP_POS_FRAMES, start_frame)
            for coords, rgb in subsample_frames(
                    cap, img_wh, num_frames, split, coords_of, video_i,
                    load_full_step, subsample_keyframe_step,
                    subsample_keyframe_frac, subsample_frac,
                    subsample_mode):
                coords_list.append(coords)
                rgb_list.append(rgb)
        finally:
            cap.release()

    return RayDataset(
        all_coords=np.concatenate(coords_list, 0),
        all_rgb=np.concatenate(rgb_list, 0),
        img_wh=img_wh,
        num_images=len(cam_indices) * num_frames,
        poses=np.asarray(poses, np.float32),
        intrinsics=np.asarray(intrinsics[0], np.float32),
        num_views=n_cams,
        **scene_info(collection, num_frames, keyframe_step),
    )
