"""Dataset variants (port of hyperreel_tpu/data/variants.py; reference
datasets/stanford.py StanfordLLFFDataset, datasets/blender.py
BlenderLightfieldDataset and DenseBlenderDataset, datasets/shiny.py
DenseShinyDataset)."""

import json
import os

import numpy as np

from hyperreel_tpu_torch.data.base import RayDataset
from hyperreel_tpu_torch.data.blender import load_blender, read_composited
from hyperreel_tpu_torch.data.llff import load_llff
from hyperreel_tpu_torch.ops.ray_math import get_lightfield_rays


def load_stanford_llff(root_dir, split="train", downsample=4, use_ndc=True,
                       val_skip=8, **kwargs):
    """The pose-based Stanford variant: the LLFF layout (reference
    StanfordLLFFDataset, run_one_stanford_llff_ndc.sh)."""
    return load_llff(root_dir, split=split, downsample=downsample,
                     use_ndc=use_ndc, val_skip=val_skip, **kwargs)


def load_dense_shiny(root_dir, split="train", downsample=4, use_ndc=True,
                     **kwargs):
    """A dense Shiny capture: the LLFF layout, a view in 16 held out
    (reference DenseShinyDataset)."""
    return load_llff(root_dir, split=split, downsample=downsample,
                     use_ndc=use_ndc, val_skip=kwargs.pop("val_skip", 16),
                     **kwargs)


def load_dense_blender(root_dir, split="train", img_wh=(800, 800),
                       **kwargs):
    """A dense Blender capture (reference DenseBlenderDataset): the
    transforms-json layout."""
    return load_blender(root_dir, split=split, img_wh=img_wh, **kwargs)


def load_blender_lightfield(root_dir, split="train", img_wh=(256, 256),
                            rows=8, cols=8, st_scale=0.25, **kwargs):
    """A Blender light-field grid (reference BlenderLightfieldDataset): a
    rows x cols grid of renders with two-plane rays."""
    with open(os.path.join(root_dir, "transforms_train.json")) as f:
        meta = json.load(f)
    frames = meta["frames"]
    if len(frames) < rows * cols:
        raise ValueError(f"{root_dir}: a {rows} x {cols} grid needs "
                         f"{rows * cols} frames, found {len(frames)}")
    W, H = img_wh
    aspect = W / H

    coords_list, rgb_list = [], []
    for t_idx in range(rows):
        for s_idx in range(cols):
            fr = frames[t_idx * cols + s_idx]
            s = (s_idx / max(cols - 1, 1)) * 2.0 - 1.0
            t = -((t_idx / max(rows - 1, 1)) * 2.0 - 1.0)
            rays = get_lightfield_rays(W, H, s, t, aspect,
                                       st_scale=st_scale)
            cam = np.full((rays.shape[0], 1), t_idx * cols + s_idx,
                          np.float32)
            coords_list.append(
                np.concatenate([rays, cam], -1).astype(np.float32))
            rgb_list.append(read_composited(
                os.path.join(root_dir, fr["file_path"] + ".png"), img_wh))

    return RayDataset(
        all_coords=np.concatenate(coords_list, 0),
        all_rgb=np.concatenate(rgb_list, 0),
        img_wh=img_wh,
        num_images=rows * cols,
        num_views=rows * cols,
        near=-1.0,
        far=0.0,
        depth_range=(0.0, 1.0),
    )
