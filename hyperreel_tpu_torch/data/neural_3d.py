"""Neural 3D Video dataset (port of hyperreel_tpu/data/neural_3d.py;
reference datasets/neural_3d.py).

LLFF-style poses_bounds.npy and one mp4 per camera (decoded with cv2), NDC
rays, camera 0 held out, keyframe-aware pixel-stride subsampling (the
reference's regular_subsample) or, with subsample_mode "importance", the
pixels that changed most since the previous frame. Ray layout [o, d,
cam_idx, time] = 8.
"""

import glob
import os

import numpy as np

from hyperreel_tpu_torch.data.base import RayDataset
from hyperreel_tpu_torch.data.technicolor import subsample_mask
from hyperreel_tpu_torch.ops.pose_math import correct_poses_bounds
from hyperreel_tpu_torch.ops.ray_math import (
    get_ndc_rays_fx_fy, get_ray_directions_K, get_rays)

# the published window: 50 frames, a keyframe every 4
NUM_FRAMES = 50
KEYFRAME_STEP = 4


def window_info(num_frames=NUM_FRAMES, keyframe_step=KEYFRAME_STEP):
    """The dataset_info fields of a window of `num_frames` frames, which
    the loader gives without reading a file."""
    return {"num_keyframes": num_frames // keyframe_step,
            "num_frames": num_frames}


def importance_mask(rgb, last_rgb, num_take):
    """The pixels that changed most since the previous frame (reference
    neural_3d.py:194-207, immersive.py:294-310)."""
    diff = np.abs(rgb - last_rgb).mean(-1)
    thresh = np.sort(diff)[-num_take]
    return diff > thresh


def subsample_frames(cap, img_wh, num_frames, split, coords_of, first_offset,
                     load_full_step, subsample_keyframe_step,
                     subsample_keyframe_frac, subsample_frac,
                     subsample_mode):
    """Decode up to `num_frames` frames of `cap` (cv2.VideoCapture) at
    `img_wh` and keep, on the train split, each frame's pixels as the
    schedule says: whole every load_full_step frames, else the importance
    or the stride mask (the stride's offsets start at `first_offset`, the
    camera's place in the split). `coords_of(t)`: the coords of the frame
    at time t. Returns the (coords, rgb) of each frame read."""
    import cv2

    W, H = img_wh
    keyframe_offset = frame_offset = first_offset
    last_rgb = None
    out = []
    for frame in range(num_frames):
        ok, im = cap.read()
        if not ok:
            break
        im = cv2.cvtColor(im, cv2.COLOR_BGR2RGB)
        if (im.shape[1], im.shape[0]) != tuple(img_wh):
            im = cv2.resize(im, tuple(img_wh), interpolation=cv2.INTER_AREA)
        rgb = (im.astype(np.float32) / 255.0).reshape(-1, 3)
        t = frame / max(num_frames - 1, 1)
        coords = coords_of(t)

        mask = None
        if split == "train":
            if (frame % load_full_step) == 0:
                mask = None
            elif subsample_mode == "importance" and last_rgb is not None:
                frac = subsample_keyframe_frac \
                    if (frame % subsample_keyframe_step) == 0 \
                    else subsample_frac
                mask = importance_mask(rgb, last_rgb,
                                       int(round(rgb.shape[0] * frac)))
            elif (frame % subsample_keyframe_step) == 0:
                every = int(np.round(1.0 / subsample_keyframe_frac))
                mask = subsample_mask(W, H, every, keyframe_offset)
                keyframe_offset += 1
            else:
                every = int(np.round(1.0 / subsample_frac))
                mask = subsample_mask(W, H, every, frame_offset)
                frame_offset += 1
        if mask is not None:
            out.append((coords[mask], rgb[mask]))
        else:
            out.append((coords, rgb))
        last_rgb = rgb
    return out


def load_neural_3d(root_dir, split="train", img_wh=(1352, 1014),
                   start_frame=0, num_frames=NUM_FRAMES,
                   keyframe_step=KEYFRAME_STEP, load_full_step=8,
                   subsample_keyframe_step=4, subsample_keyframe_frac=0.25,
                   subsample_frac=0.125, val_set=(0,), val_all=False,
                   use_ndc=True, subsample_mode="regular"):
    import cv2

    W, H = img_wh
    poses_bounds = np.load(os.path.join(root_dir, "poses_bounds.npy"))
    video_paths = sorted(glob.glob(os.path.join(root_dir, "*.mp4")))
    images_per_frame = len(video_paths)

    poses = poses_bounds[:, :15].reshape(-1, 3, 5)
    bounds = poses_bounds[:, -2:].copy()
    H0, W0, focal = poses[0, :, -1]
    K = np.eye(3)
    K[0, 0] = focal * W / W0
    K[0, 2] = (W0 / 2.0) * W / W0
    K[1, 1] = focal * H / H0
    K[1, 2] = (H0 / 2.0) * H / H0

    poses, _, bounds = correct_poses_bounds(poses[:, :, :4], bounds)
    near = bounds.min() * 0.95
    far = bounds.max() * 1.05

    directions = get_ray_directions_K(H, W, K, centered_pixels=True)

    val_set = list(val_set)
    if split == "train" and not val_all:
        cam_indices = [i for i in range(images_per_frame) if i not in val_set]
    elif split in ("val", "test") and not val_all:
        cam_indices = val_set
    else:
        cam_indices = list(range(images_per_frame))

    coords_list, rgb_list = [], []
    for video_idx, cam_i in enumerate(cam_indices):
        c2w = poses[cam_i][:3, :4]
        rays_o, rays_d = get_rays(directions, c2w)
        rays = np.concatenate([rays_o, rays_d], -1).astype(np.float32)
        if use_ndc:
            # the reference projects at self.near = bounds.min() * 0.95
            # (neural_3d.py:105, 382-385)
            rays = get_ndc_rays_fx_fy(
                H, W, K[0, 0], K[1, 1], near, rays).astype(np.float32)

        def coords_of(t, rays=rays, cam_i=cam_i):
            return np.concatenate([
                rays,
                np.full((rays.shape[0], 1), cam_i, np.float32),
                np.full((rays.shape[0], 1), t, np.float32),
            ], -1)

        cap = cv2.VideoCapture(video_paths[cam_i])
        try:
            cap.set(cv2.CAP_PROP_POS_FRAMES, start_frame)
            for coords, rgb in subsample_frames(
                    cap, img_wh, num_frames, split, coords_of, video_idx,
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
        poses=np.asarray(poses[:, :3, :4], np.float32),
        intrinsics=np.asarray(K, np.float32),
        ndc_params=(float(K[0, 0]), float(K[1, 1]), float(near))
        if use_ndc else None,
        **window_info(num_frames, keyframe_step),
        num_views=images_per_frame,
        near=float(near),
        far=float(far),
        depth_range=(float(near * 2.0), float(far)),
    )
