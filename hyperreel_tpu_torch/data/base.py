"""In-memory ray store (port of hyperreel_tpu/data/base.py; reference
datasets/base.py).

The rays are flat numpy arrays `all_coords` [N, 6/7/8] and `all_rgb` [N,
3]; the train split samples rows with replacement from a numpy generator
(`default_rng(seed)`, so a seed gives the JAX package's batches), val and
test take whole images. The trainer moves each batch to the
device. A loader also records its cameras (poses, intrinsics), the NDC
projection its rays went through and, for a camera grid, its rows and
columns: the render paths and the viewer make new rays from them.
"""

from dataclasses import dataclass, field
from typing import Dict, Iterator, Optional

import numpy as np


@dataclass
class RayDataset:
    all_coords: np.ndarray            # [N, 6/7/8]
    all_rgb: np.ndarray               # [N, 3]
    all_weights: Optional[np.ndarray] = None  # [N, 1]
    img_wh: tuple = (0, 0)
    num_images: int = 0
    # the dataset_info fields that the model builders read
    num_keyframes: int = 1
    num_frames: int = 1
    num_views: int = 1
    near: float = 0.0
    far: float = 1.0
    depth_range: tuple = (0.0, 1.0)
    extras: Dict[str, np.ndarray] = field(default_factory=dict)
    # camera-to-world poses [V, 3, 4] and intrinsics [3, 3], where the
    # loader has cameras (the spiral and other render paths start there)
    poses: Optional[np.ndarray] = None
    intrinsics: Optional[np.ndarray] = None
    # (fx, fy, near) where the rays are in NDC space: rays made for a
    # render path go through the same projection (reference
    # datasets/base.py get_coords_from_camera)
    ndc_params: Optional[tuple] = None
    # the camera grid (rows x cols) of a light-field loader (stanford):
    # the EPI visualizer reads its ground-truth EPIs from it (reference
    # nlf/visualizers/epipolar.py:93-101)
    num_rows: Optional[int] = None
    num_cols: Optional[int] = None

    def __post_init__(self):
        if self.all_weights is None:
            self.all_weights = np.ones((self.all_coords.shape[0], 1),
                                       np.float32)

    @property
    def num_rays(self):
        return self.all_coords.shape[0]

    def info(self):
        return {
            "num_keyframes": self.num_keyframes,
            "num_frames": self.num_frames,
            "num_views": self.num_views,
            "near": self.near,
            "far": self.far,
            "depth_range": self.depth_range,
        }

    def batch_iterator(self, batch_size,
                       seed=0) -> Iterator[Dict[str, np.ndarray]]:
        """Infinite sampler over the rays, with replacement (the
        reference's RandomSampler)."""
        rng = np.random.default_rng(seed)
        n = self.num_rays
        while True:
            idx = rng.integers(0, n, batch_size)
            batch = {
                "rays": self.all_coords[idx],
                "rgb": self.all_rgb[idx],
                "weights": self.all_weights[idx],
            }
            for k, v in self.extras.items():
                batch[k] = v[idx]
            yield batch

    def image(self, i):
        """Whole-image rays and rgb of image i (reference
        datasets/base.py:248-276)."""
        W, H = self.img_wh
        sl = slice(i * W * H, (i + 1) * W * H)
        return {"rays": self.all_coords[sl], "rgb": self.all_rgb[sl]}
