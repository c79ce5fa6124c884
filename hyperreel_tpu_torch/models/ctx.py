"""Step context threaded through every stage (port of
hyperreel_tpu/models/ctx.py).

`it` is a plain Python int: the iteration-scheduled activations and
encodings evaluate their weights on the host. Only eval is ported, so the
context carries no random generator.
"""

from dataclasses import dataclass


@dataclass(frozen=True)
class StepCtx:
    it: int = 0
    training: bool = False
