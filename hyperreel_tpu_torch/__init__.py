"""PyTorch/CUDA port of hyperreel_tpu for NVIDIA Hopper (H100).

The JAX package `hyperreel_tpu` is the reference; this package mirrors its
module paths (`hyperreel_tpu_torch/models/fused_eval.py` <->
`hyperreel_tpu/models/fused_eval.py`, ...). It imports torch and never jax.
The only shared code is the stdlib-only config dicts of
`hyperreel_tpu.configs.presets`.

Covered so far: the flagship (`technicolor_z_plane`) eval render, through
the plain-torch stage chain (general path) and through the fused path on
two hand-written CUDA kernels (`ops/kernels/pack_build.py`,
`ops/kernels/shade.py`).
"""
