"""PyTorch/CUDA port of hyperreel_tpu for NVIDIA Hopper (H100).

The JAX package `hyperreel_tpu` is the reference; this package mirrors its
module paths (`hyperreel_tpu_torch/models/fused_eval.py` <->
`hyperreel_tpu/models/fused_eval.py`, ...). It imports torch and never jax,
and nothing of `hyperreel_tpu`: the model configs it renders are its own
copy (`configs/presets.py`).

Covered so far: the flagship (`technicolor_z_plane`) eval render, through
the plain-torch stage chain (general path) and through the fused path on
hand-written CUDA kernels: the quad route (`ops/kernels/pack_build.py`,
`ops/kernels/shade.py`) and the coherent patch-gather route
(`ops/kernels/shade_patch.py`, or `ops/kernels/patch_blend.py` then the
pre-blended shade); and the standalone composite
(`ops/kernels/composite.py`).
"""
