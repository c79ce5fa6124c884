"""PyTorch/CUDA port of hyperreel_tpu for NVIDIA Hopper (H100).

The JAX package `hyperreel_tpu` is the reference; this package mirrors its
module paths (`hyperreel_tpu_torch/models/fused_eval.py` <->
`hyperreel_tpu/models/fused_eval.py`, ...). It imports torch and never jax,
and nothing of `hyperreel_tpu`: the model configs it renders are its own
copy (`configs/presets.py`).

It covers the eval render of every model of README.md's port section (the
z-plane families on the fused path, the non-planar primitive presets
through the general chain and their colour nets' own fused routes, with
the render-time sample counts) on hand-written CUDA kernels for each of
the JAX package's seven Pallas kernels (`ops/kernels/`, sources in
`csrc/`) beside their plain PyTorch versions; the training of every ported
preset (`train/`); the data layer (`data/`: every loader, the native ray
store); and the user's entry points: the CLI (`python -m
hyperreel_tpu_torch.main`, `--device cpu` for the CPU), the config system
(`config.py`), `system.py` `System`, the chunked renderer
(`train/render.py`), the viewer (`viewer.py`), the mesh export
(`train/export.py`), LPIPS and the visualizers. README.md and ROADMAP.md
say what is not ported yet.
"""
