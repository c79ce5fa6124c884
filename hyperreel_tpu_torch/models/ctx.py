"""Step context threaded through every stage (port of
hyperreel_tpu/models/ctx.py).

`it` is a plain Python int: the iteration-scheduled activations and
encodings evaluate their weights on the host. A training step's random
draws come from `gen`, a torch.Generator that the trainer sets once per
step (the JAX package's per-step PRNG key); `draws` names draws that are
given instead (a test injects the JAX package's this way). A draw taken
from `gen` is kept in `draws`, so that a name gives one value per step, as
the JAX package's fold_in(rng, constant) does where a regularizer applies
the model a second time. Under data parallelism (parallel/mesh.py) a rank
applies the model to its rows lo:hi of an n-ray global batch
(`ray_shard` = (lo, hi, n)): a per-ray draw is then taken, or given, for
all n rays and the rank reads its rows, so that every rank's generator
draws what the one-process step's does. The named draws:
  "background"     the colour net's background coin, a 0-d uniform (JAX
                   fold_in(rng, 202));
  "flow_jitter"    AdvectPointsEmbedding's keyframe jitter, uniform of the
                   times' shape (fold_in(rng, 101)), a draw per ray;
  "num_samples"    GenerateNumSamplesEmbedding's sample count, a 0-d
                   uniform (fold_in(rng, 404));
  "voxel_sparsity" VoxelSparsityRegularizer's points, uniform [n, 3] in
                   the unit cube, scaled to the aabb (the step's rng
                   itself).
"""

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import torch


@dataclass(frozen=True)
class StepCtx:
    it: int = 0
    training: bool = False
    gen: Optional[torch.Generator] = None
    draws: Dict[str, object] = field(default_factory=dict)
    ray_shard: Optional[Tuple[int, int, int]] = None

    def uniform(self, name, shape, device, per_ray=False):
        """The draw `name`: U[0, 1) f32 of `shape` on `device`, taken from
        `draws` when it holds one, else from `gen` and kept in `draws`. A
        `per_ray` draw (leading axis the rays) under a `ray_shard` is
        taken for the whole batch and sliced to the rank's rows."""
        shape = tuple(shape)
        full = shape
        if per_ray and self.ray_shard is not None:
            lo, hi, n = self.ray_shard
            full = (n,) + shape[1:]
        if name not in self.draws:
            if self.gen is None:
                raise ValueError(f"the draw {name!r} needs a generator or "
                                 "an injected value")
            self.draws[name] = torch.rand(full, generator=self.gen,
                                          device=self.gen.device)
        v = torch.as_tensor(self.draws[name], dtype=torch.float32,
                            device=device).reshape(full)
        return v[lo:hi] if full != shape else v
