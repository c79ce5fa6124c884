"""Auxiliary datasets of the regularizers (port of
hyperreel_tpu/data/aux_datasets.py; reference datasets/fourier.py and
datasets/random.py): the FFTs of the train images for frequency
supervision, and random rays jittered or interpolated from the train rays
for the ray-density regularizers."""

import numpy as np

from hyperreel_tpu_torch.data.base import RayDataset


def fourier_dataset(base_ds, **kwargs):
    """Per-image FFT magnitudes as supervision targets
    (reference datasets/fourier.py:14-70). Returns a RayDataset whose rgb
    holds the spatial-domain pixels and extras['fft'] the per-image
    magnitude spectra resampled per pixel."""
    W, H = base_ds.img_wh
    n_per = W * H
    ffts = []
    for i in range(base_ds.num_images):
        img = base_ds.all_rgb[i * n_per:(i + 1) * n_per]
        if img.shape[0] < n_per:
            break
        img2d = img.reshape(H, W, 3)
        mag = np.abs(np.fft.fft2(img2d, axes=(0, 1))).astype(np.float32)
        ffts.append(mag.reshape(-1, 3))
    n = len(ffts) * n_per
    return RayDataset(
        all_coords=base_ds.all_coords[:n].copy(),
        all_rgb=base_ds.all_rgb[:n].copy(),
        img_wh=base_ds.img_wh,
        num_images=len(ffts),
        num_views=base_ds.num_views,
        near=base_ds.near, far=base_ds.far,
        depth_range=base_ds.depth_range,
        extras={"fft": np.concatenate(ffts, 0)},
    )


def random_ray_view_dataset(base_ds, n_rays=65536, pos_std=0.05,
                            dir_std=0.05, seed=0, **kwargs):
    """Jittered random rays drawn from train-ray statistics
    (reference datasets/random.py RandomRayDataset family)."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, base_ds.num_rays, n_rays)
    coords = base_ds.all_coords[idx].copy()
    coords[:, :3] += rng.normal(0, pos_std, (n_rays, 3)).astype(np.float32)
    d = coords[:, 3:6] + rng.normal(0, dir_std, (n_rays, 3)).astype(np.float32)
    coords[:, 3:6] = d / np.maximum(
        np.linalg.norm(d, axis=-1, keepdims=True), 1e-12)
    return RayDataset(
        all_coords=coords,
        all_rgb=np.zeros((n_rays, 3), np.float32),
        img_wh=base_ds.img_wh,
        num_images=base_ds.num_images,
        num_views=base_ds.num_views,
        near=base_ds.near, far=base_ds.far,
        depth_range=base_ds.depth_range,
    )


def random_pixel_dataset(base_ds, n_rays=65536, seed=0, **kwargs):
    """Interpolated random pixels: blends of pairs of nearby train rays
    (reference datasets/random.py RandomPixelDataset family)."""
    rng = np.random.default_rng(seed)
    i0 = rng.integers(0, base_ds.num_rays, n_rays)
    i1 = np.clip(i0 + rng.integers(1, base_ds.img_wh[0], n_rays),
                 0, base_ds.num_rays - 1)
    w = rng.uniform(0, 1, (n_rays, 1)).astype(np.float32)
    coords = (w * base_ds.all_coords[i0]
              + (1 - w) * base_ds.all_coords[i1]).astype(np.float32)
    d = coords[:, 3:6]
    coords[:, 3:6] = d / np.maximum(
        np.linalg.norm(d, axis=-1, keepdims=True), 1e-12)
    rgb = (w * base_ds.all_rgb[i0] + (1 - w) * base_ds.all_rgb[i1])
    return RayDataset(
        all_coords=coords,
        all_rgb=rgb.astype(np.float32),
        img_wh=base_ds.img_wh,
        num_images=base_ds.num_images,
        num_views=base_ds.num_views,
        near=base_ds.near, far=base_ds.far,
        depth_range=base_ds.depth_range,
    )
