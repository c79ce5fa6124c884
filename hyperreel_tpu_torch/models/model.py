"""Model composition (port of hyperreel_tpu/models/model.py; reference
nlf/models/models.py): rgb = color_net(embedding_chain(param(rays))).

Functional, like the JAX package: `init(gen, device) -> params`,
`apply(params, rays, ctx, render_kwargs) -> {"rgb": [B, 3], ...}`.
Training calls (ctx.training) take the general stage chain, as in the JAX
package. Eval calls take the fused path (models/fused_eval.py, the CUDA
kernels) when the chain is one of its patterns and `fused_render_cf` is on;
otherwise the general stage chain runs, and a colour net with
`fused_render` on then takes its own fused route after it
(models/tensorf.py FactoredNet.apply_fused: K2 for one axis, K5 for
three). The general chain with
the general colour net is the fused paths' reference.
"""

from hyperreel_tpu_torch.models import fused_eval
from hyperreel_tpu_torch.models.embeddings import build_embedding_chain
from hyperreel_tpu_torch.models.ray_param import get_ray_param
from hyperreel_tpu_torch.models.tensorf import build_color_net


class LightfieldModel:
    def __init__(self, cfg, dataset_info=None, compute_dtype=None):
        self.cfg = cfg
        self.dataset_info = dataset_info
        self.compute_dtype = compute_dtype
        self.ray_param = get_ray_param(cfg.get("param", {"fn": "identity"}))
        self.embedding = build_embedding_chain(cfg["embedding"], dataset_info,
                                               compute_dtype)
        self.color_net = build_color_net(cfg["color"]["net"], dataset_info)
        self._cf_eval = None
        if cfg["color"]["net"].get("fused_render_cf", True) \
                and fused_eval.cf_eligible(self):
            self._cf_eval = fused_eval.FusedCFEval(self)

    def init(self, gen, device):
        """Parameters drawn from the torch.Generator `gen`, on `device`."""
        return {"embedding": self.embedding.init(gen, device),
                "color": self.color_net.init(gen, device)}

    def apply(self, params, rays, ctx, render_kwargs=None):
        render_kwargs = render_kwargs or {}
        if self._cf_eval is not None and self._cf_eval.ok(ctx, render_kwargs):
            return self._cf_eval.apply(params, rays, ctx, render_kwargs)
        rays = self.ray_param.apply(rays)
        x = self.embedding.apply(params["embedding"], rays, ctx,
                                 render_kwargs)
        return self.color_net.apply(params["color"], x, ctx, render_kwargs)

    def param_groups(self, params):
        """The optimizer-group label of every leaf of `params` (hyperreel_tpu
        LightfieldModel.param_groups): an embedding stage's its `group`
        ("embedding" by default), the colour net's its own."""

        def label(tree, group):
            return {k: label(v, group) for k, v in tree.items()} \
                if isinstance(tree, dict) else group

        return {"embedding": {
            name: label(params["embedding"][name],
                        getattr(stage, "group", "embedding"))
            for name, stage in self.embedding.stages},
            "color": self.color_net.param_groups(params["color"])}

    def prepare_eval(self, params):
        """Per-checkpoint tables of the model's fused route: the
        channels-first path's (FusedCFEval.prepare), else the colour net's
        own route's (prepare_fused of TensorVMNoSample or
        TensorVMKeyframeTime), else None. Pass the result as
        render_kwargs["cf_prepared"]."""
        if self._cf_eval is not None:
            return self._cf_eval.prepare(params)
        net = self.color_net
        if net.fused_render and net.fused_eligible:
            return net.prepare_fused(params["color"])
        return None


def build_model(cfg, dataset_info=None, compute_dtype=None):
    if cfg.get("type", "lightfield") != "lightfield":
        raise NotImplementedError(f"model type {cfg['type']!r}")
    return LightfieldModel(cfg, dataset_info, compute_dtype)
