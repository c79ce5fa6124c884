"""Stanford light-field dataset (port of hyperreel_tpu/data/stanford.py;
reference datasets/stanford.py and datasets/lightfield.py).

A rows x cols grid of images; each image's rays are two-plane rays: the
origin (s, t) on the z = -1 plane (the grid position in [-1, 1]), the
directions toward the (u, v) image plane at z = 0 (reference
StanfordLightfieldDataset.get_coords -> get_lightfield_rays,
stanford.py:108-128). Ray layout [o, d, cam_idx] = 7.
"""

import os

import numpy as np

from hyperreel_tpu_torch.data.base import RayDataset
from hyperreel_tpu_torch.data.image_io import image_size, read_rgb
from hyperreel_tpu_torch.ops.ray_math import get_lightfield_rays


def load_stanford_lightfield(root_dir, split="train", rows=17, cols=17,
                             step=4, img_wh=None, st_scale=1.0,
                             uv_scale=1.0, val_pairs=(), downsample=1):
    image_paths = sorted([
        p for p in os.listdir(root_dir)
        if p.lower().endswith((".png", ".jpg", ".jpeg"))
    ])
    if len(image_paths) < rows * cols:
        raise ValueError(f"{root_dir}: a {rows} x {cols} grid needs "
                         f"{rows * cols} images, found {len(image_paths)}")

    if img_wh is None:
        w0, h0 = image_size(os.path.join(root_dir, image_paths[0]))
        img_wh = (w0 // downsample, h0 // downsample)
    W, H = img_wh
    aspect = W / H

    val_pairs = [tuple(p) for p in val_pairs]

    coords_list, rgb_list = [], []
    count = 0
    for t_idx in range(0, rows, step):
        for s_idx in range(0, cols, step):
            is_val = (s_idx, t_idx) in val_pairs
            if split == "train" and is_val:
                continue
            if split in ("val", "test") and val_pairs and not is_val:
                continue
            s = (s_idx / max(cols - 1, 1)) * 2.0 - 1.0
            t = -((t_idx / max(rows - 1, 1)) * 2.0 - 1.0)
            rays = get_lightfield_rays(
                W, H, s, t, aspect, st_scale=st_scale, uv_scale=uv_scale)
            cam_idx = np.full((rays.shape[0], 1),
                              t_idx * cols + s_idx, np.float32)
            coords_list.append(np.concatenate(
                [rays, cam_idx], -1).astype(np.float32))
            rgb_list.append(read_rgb(os.path.join(
                root_dir, image_paths[t_idx * cols + s_idx]),
                img_wh).reshape(-1, 3))
            count += 1

    return RayDataset(
        all_coords=np.concatenate(coords_list, 0),
        all_rgb=np.concatenate(rgb_list, 0),
        img_wh=img_wh,
        num_images=count,
        num_views=rows * cols,
        near=-1.0,
        far=0.0,
        depth_range=(0.0, 1.0),
        num_rows=(rows + step - 1) // step,
        num_cols=(cols + step - 1) // step,
    )
