"""Step context threaded through every stage (port of
hyperreel_tpu/models/ctx.py).

`it` is a plain Python int: the iteration-scheduled activations and
encodings evaluate their weights on the host. A training step's random
draws come from `gen`, a torch.Generator that the trainer sets once per
step (the JAX package's per-step PRNG key); `draws` names draws that are
given instead (a test injects the JAX package's this way). The stages name
their draws: "background" (the colour net's background coin, a 0-d
uniform) and "flow_jitter" (AdvectPointsEmbedding's keyframe jitter,
uniform of the times' shape).
"""

from dataclasses import dataclass, field
from typing import Dict, Optional

import torch


@dataclass(frozen=True)
class StepCtx:
    it: int = 0
    training: bool = False
    gen: Optional[torch.Generator] = None
    draws: Dict[str, object] = field(default_factory=dict)

    def uniform(self, name, shape, device):
        """The draw `name`: U[0, 1) f32 of `shape` on `device`, taken from
        `draws` when it holds one, else from `gen`."""
        if name in self.draws:
            return torch.as_tensor(self.draws[name], dtype=torch.float32,
                                   device=device).reshape(shape)
        if self.gen is None:
            raise ValueError(f"the draw {name!r} needs a generator or an "
                             "injected value")
        return torch.rand(shape, generator=self.gen,
                          device=self.gen.device).to(device)
