"""Shiny dataset (port of hyperreel_tpu/data/shiny.py; reference
datasets/shiny.py): LLFF-layout scenes (poses_bounds.npy and images/) of a
denser capture, loaded on the LLFF path with NDC and the per-scene
holdout."""

from hyperreel_tpu_torch.data.llff import load_llff


def load_shiny(root_dir, split="train", downsample=4, use_ndc=True,
               val_skip=8, **kwargs):
    return load_llff(root_dir, split=split, downsample=downsample,
                     use_ndc=use_ndc, val_skip=val_skip, **kwargs)
