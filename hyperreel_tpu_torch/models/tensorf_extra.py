"""The other colour nets (port of hyperreel_tpu/models/tensorf_extra.py;
reference nlf/nets/tensorf_base.py TensorVM and TensorCP,
nlf/nets/nets.py MultipleNet): the joint-plane VM net (`tensor_vm`), the
CP decomposition (`tensor_cp`), the standalone net with its own ray march
(`tensor_vm_split`) and the cascade of colour nets (`multiple`).

The joint and CP nets keep the static net's forward (models/tensorf.py
TensorVMNoSample.apply: weights, filter, shading heads, colour transforms,
composite) and replace only how their factors are stored and sampled, as
the JAX package's do. They sample their f32 factors (no bf16 tables) and
take no fused route. Their grids train through the lookups' autograd
Functions (ops/grid_sample.py). The CP net's three lines per family are a
dict {"0", "1", "2"} where the JAX package keeps a list
(convert.params_from_jax maps one to the other).

`tensor_vm_split_reflect` (TensorVMReflect) is not ported: its normal is
the gradient of density with respect to position, and training it
differentiates that gradient again, a double backward that the lookups'
Functions do not have (ROADMAP.md: long tail).
"""

import dataclasses

import torch

from hyperreel_tpu_torch.models.mlp import linear_init
from hyperreel_tpu_torch.models.tensorf import (
    MAT_MODE, VEC_MODE, TensorVMNoSample)
from hyperreel_tpu_torch.ops.grid_sample import (
    grid_sample_1d, grid_sample_2d, linspace, resize_bilinear_2d,
    resize_linear_1d)


def _n_comp(value, default):
    v = default if value is None else value
    return int(v[0] if isinstance(v, (list, tuple)) else v)


class _OwnFactors(TensorVMNoSample):
    """The static net's forward over factors stored another way: the
    subclass gives `init_factors`, `sample_factors`, `upsample`."""

    DEFAULT_COMPS = None        # (density, appearance) components

    def __init__(self, cfg):
        cfg = dict(cfg)
        self.n_comp_density = _n_comp(cfg.get("n_lamb_sigma"),
                                      self.DEFAULT_COMPS[0])
        self.n_comp_app = _n_comp(cfg.get("n_lamb_sh"), self.DEFAULT_COMPS[1])
        cfg["n_lamb_sigma"] = [self.n_comp_density] * 3
        cfg["n_lamb_sh"] = [self.n_comp_app] * 3
        super().__init__(cfg)
        self.fused_eligible = False

    def init(self, gen, device):
        params = self.init_factors(gen, device)
        return self.init_heads(gen, device, params)

    def param_groups(self, params):
        """The factors "color", the basis and the render net "color_impl"
        (JAX TensorVMJoint / TensorCP param_groups)."""
        groups = {k: ({kk: "color" for kk in v} if isinstance(v, dict)
                      else "color")
                  for k, v in params.items()
                  if k not in ("basis_mat", "render")}
        groups["basis_mat"] = {k: "color_impl" for k in params["basis_mat"]}
        if "render" in params:
            groups["render"] = {layer: {k: "color_impl" for k in p}
                                for layer, p in params["render"].items()}
        return groups

    def sample(self, params, xyz):
        dens, app = self.sample_factors(params, xyz)
        return dens, app @ params["basis_mat"]["weight"].t()

    def sample_density(self, params, xyz):
        return self.sample_factors(params, xyz)[0]

    def shrink(self, params, new_aabb):
        raise NotImplementedError(
            f"{type(self).__name__} has no shrink (the JAX package's crops "
            "the split net's grids, which this net does not have)")


class TensorVMJoint(_OwnFactors):
    """Joint-plane TensorVM (JAX TensorVMJoint; reference
    tensorf_base.py:623-861): one plane stack [3, R, R, C] and one line
    stack [3, R, C], R the largest grid size, C = n_comp_app +
    n_comp_density; axis i's density is the sum over its last
    n_comp_density channels of plane times line, its appearance the first
    n_comp_app channels' products, concatenated over the axes."""

    DEFAULT_COMPS = (8, 24)

    def init_factors(self, gen, device):
        res = max(self.grid_size)
        C = self.n_comp_app + self.n_comp_density
        return {
            "plane_coef": (0.1 * torch.randn(3, res, res, C, generator=gen)
                           ).to(device),
            "line_coef": (0.1 * torch.randn(3, res, C, generator=gen)
                          ).to(device),
            "basis_mat": linear_init(gen, self.n_comp_app * 3, self.app_dim,
                                     device, bias=False)}

    def sample_factors(self, params, xyz):
        """xyz [N, 3] normalized -> (density feature [N], appearance
        features [N, 3 n_comp_app])."""
        nd, na = self.n_comp_density, self.n_comp_app
        dens, app = 0.0, []
        for i in range(3):
            m0, m1 = MAT_MODE[i]
            prod = grid_sample_2d(params["plane_coef"][i], xyz[:, [m0, m1]]) \
                * grid_sample_1d(params["line_coef"][i], xyz[:, VEC_MODE[i]])
            dens = dens + prod[:, -nd:].sum(-1)
            app.append(prod[:, :na])
        return dens, torch.cat(app, -1)

    def upsample(self, params, new_grid_size):
        """Both stacks resized to the largest new grid size (planes
        bilinearly, lines linearly); sets `grid_size` to it on every
        axis."""
        res = max(new_grid_size)
        new = dict(params)
        with torch.no_grad():
            new["plane_coef"] = torch.stack([
                resize_bilinear_2d(params["plane_coef"][i], res, res)
                for i in range(3)])
            new["line_coef"] = torch.stack([
                resize_linear_1d(params["line_coef"][i], res)
                for i in range(3)])
        self.grid_size = [res] * 3
        return new


class TensorCP(_OwnFactors):
    """CP decomposition (JAX TensorCP; reference tensorf_base.py:
    1235-1415): per family three lines [grid_size[VEC_MODE[i]], n_comp];
    density the sum over the components of the lines' product, appearance
    the product's components through the basis."""

    DEFAULT_COMPS = (96, 288)

    def init_factors(self, gen, device):
        gs = self.grid_size

        def lines(n):
            return {str(i): (0.2 * torch.randn(gs[VEC_MODE[i]], n,
                                               generator=gen)).to(device)
                    for i in range(3)}

        return {"density_line": lines(self.n_comp_density),
                "app_line": lines(self.n_comp_app),
                "basis_mat": linear_init(gen, self.n_comp_app, self.app_dim,
                                         device, bias=False)}

    @staticmethod
    def _product(lines, xyz):
        prod = None
        for i in range(3):
            v = grid_sample_1d(lines[str(i)], xyz[:, VEC_MODE[i]])
            prod = v if prod is None else prod * v
        return prod

    def sample_factors(self, params, xyz):
        return self._product(params["density_line"], xyz).sum(-1), \
            self._product(params["app_line"], xyz)

    def upsample(self, params, new_grid_size):
        """Every line resized linearly to the new grid; sets
        `grid_size`."""
        new = dict(params)
        with torch.no_grad():
            for fam in ("density_line", "app_line"):
                new[fam] = {str(i): resize_linear_1d(
                    params[fam][str(i)], new_grid_size[VEC_MODE[i]])
                    for i in range(3)}
        self.grid_size = list(new_grid_size)
        return new


class TensorVMStandalone(TensorVMNoSample):
    """TensoRF with its own ray march (JAX TensorVMStandalone; reference
    TensorBase.forward with sample_ray, tensorf_base.py:330-380, 555-620):
    nSamples stratified samples between near_far, then the static net's
    forward. In training each sample is moved by U[0, 1) (far - near) /
    nSamples, the draw "standalone_jitter" of the step context (from the
    caller's torch.Generator, or injected: models/ctx.py)."""

    def __init__(self, cfg):
        super().__init__(cfg)
        self.near_far = [float(v) for v in cfg.get("near_far", [2.0, 6.0])]
        self.n_samples = int(cfg.get("nSamples", 128))
        self.ndc_ray = bool(cfg.get("ndc_ray", 0))

    def march(self, params, rays, ctx, render_kwargs=None):
        """rays [B, 6+] (origin, direction) -> the render outputs."""
        B, n = rays.shape[0], self.n_samples
        near, far = self.near_far
        t = linspace(near, far, n, rays.device).expand(B, n)
        if ctx.training:
            t = t + ctx.uniform("standalone_jitter", (B, n), rays.device,
                                per_ray=True) * ((far - near) / n)
        pts = rays[:, None, :3] + rays[:, None, 3:6] * t[..., None]
        x = {"points": pts, "distances": t[..., None],
             "viewdirs": rays[:, None, 3:6].expand(B, n, 3),
             "weights": torch.ones(B, n, 1, device=rays.device)}
        return self.apply(params, x, ctx, render_kwargs)


class MultipleNet:
    """A cascade of colour nets (JAX tensorf_extra.MultipleNet; reference
    nlf/nets/nets.py:36-134): net i is on while wait_iters[i] <= it <
    stop_iters[i] and sees the iteration it - wait_iters[i]; the outputs
    are those of net 0 with rgb the scale-weighted sum of the nets that
    are on (a net that is off adds 0 times its rgb). No grid events and
    no fused route: the cascade's own lists are empty."""

    fused_render = False
    fused_eligible = False
    upsamp_list, update_alphamask_list, n_voxel_list = (), (), ()

    def __init__(self, nets, wait_iters, stop_iters, scales=None):
        self.nets = nets
        self.wait_iters = wait_iters
        self.stop_iters = stop_iters
        self.scales = scales or [1.0] * len(nets)

    def init(self, gen, device):
        return {f"net_{i}": n.init(gen, device)
                for i, n in enumerate(self.nets)}

    def apply(self, params, x, ctx, render_kwargs=None):
        out = None
        for i, net in enumerate(self.nets):
            ctx_i = dataclasses.replace(
                ctx, it=ctx.it - int(self.wait_iters[i]))
            o = net.apply(params[f"net_{i}"], dict(x), ctx_i, render_kwargs)
            gate = float(self.wait_iters[i] <= ctx.it < self.stop_iters[i])
            rgb = o["rgb"] * (gate * self.scales[i])
            if out is None:
                out = dict(o, rgb=rgb)
            else:
                out["rgb"] = out["rgb"] + rgb
        return out

    def param_groups(self, params):
        return {f"net_{i}": n.param_groups(params[f"net_{i}"])
                for i, n in enumerate(self.nets)}
