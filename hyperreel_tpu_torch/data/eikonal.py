"""Eikonal dataset (port of hyperreel_tpu/data/eikonal.py; reference
datasets/eikonal.py): LLFF-style poses_bounds, the size from the first
image, and a cap on the training views (eikonal.py:26-80)."""

from hyperreel_tpu_torch.data.llff import load_llff


def load_eikonal(root_dir, split="train", downsample=1, num_views=None,
                 use_ndc=False, val_skip=8, **kwargs):
    ds = load_llff(root_dir, split=split, downsample=downsample,
                   use_ndc=use_ndc, val_skip=val_skip, **kwargs)
    if num_views is not None and split == "train":
        W, H = ds.img_wh
        n = min(num_views, ds.num_images) * W * H
        ds.all_coords = ds.all_coords[:n]
        ds.all_rgb = ds.all_rgb[:n]
        ds.all_weights = ds.all_weights[:n]
        ds.num_images = min(num_views, ds.num_images)
    return ds
