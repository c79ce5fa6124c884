"""Embedding stages beyond the z-plane chains' own (port of
hyperreel_tpu/models/embeddings_extra.py): the render-time sample-count
stage `select_points` (reference nlf/embedding/point.py:402-480).
"""


class SelectPointsEmbedding:
    """Keep a subset of the samples in every per-sample field (each tensor
    of the state whose axis 1 has the S samples and that has a channel
    axis), at eval (hyperreel_tpu SelectPointsEmbedding, its inference
    regime):

      mode="stride" (the reference's arrangement; any mode but "first")
        keeps every (S // n)-th sample, v[:, ::S // n];
      mode="first" keeps the first n, v[:, :n]: after an intersect with
        invalid_sort_far the n nearest valid samples of the sorted
        distances (configs/presets.py with_compact_samples). The fields
        other than the distances stay in prediction order, so sorted
        position j pairs with prediction row j, as in the JAX package.

    n = `inference_samples`; without it, or with n >= S, the state passes
    unchanged. The training regime (samples past a drawn count masked
    invalid; `always_slice`) is not ported.
    """

    def __init__(self, cfg):
        self.cfg = cfg
        isamp = cfg.get("inference_samples")
        self.inference_samples = int(isamp) if isamp else None
        self.always_slice = bool(cfg.get("always_slice", False))
        self.mode = cfg.get("mode", "stride")

    def init(self, gen, device):
        return {}

    def apply(self, params, x, ctx, render_kwargs=None):
        if ctx.training:
            raise NotImplementedError(
                "select_points in training (the drawn sample count, "
                "always_slice) is not ported (ROADMAP.md: training beyond "
                "the flagship)")
        S = x["points"].shape[1]
        n = self.inference_samples
        if not n or n >= S:
            return x
        sel = slice(None, n) if self.mode == "first" \
            else slice(None, None, max(S // n, 1))
        for k, v in list(x.items()):
            if v.dim() >= 3 and v.shape[1] == S:
                x[k] = v[:, sel]
        return x
