"""Factored feature-grid colour nets (port of hyperreel_tpu/models/tensorf.py
TensorVMKeyframeTime and TensorVMNoSample: init, the general apply in eval
and in training with its render fields, the shading heads (SH of degree
0-4, RGB, RGBIdentity, the MLP_Fea render net; the dynamic net's RGBtLinear
and RGBtFourier) and density heads (the dynamic net's DensityLinear and
DensityFourier), the top-k weight filter, the per-sample and per-ray colour
transforms, each net's own fused route, the regularizer terms and the grid
events; reference nlf/nets/tensorf_dynamic.py,
nlf/nets/tensorf_no_sample.py). The other colour nets are in
models/tensorf_extra.py.

Grids are channels-last, as in the JAX package. The dynamic net holds per
active axis i a space plane [H, W, C] and a time plane [num_keyframes, TW,
C] for each of the density and appearance families ("space_i",
"time_i"); the static net a plane [H, W, C] and a line [L, C] ("plane_i",
"line_i"), axis i's plane spanning the points' components MAT_MODE[i] and
its line component VEC_MODE[i]. `basis_mat` is {"weight": [app_dim,
sum(app comps)]} (nn.Linear layout): app_dim 3 (deg + 1)^2 for SH of degree
deg (27 for degree 2), 3 for RGB; the dynamic net's time heads force it
(RGBtLinear 6, RGBtFourier 3 (2 frames_per_keyframe + 1)), as the JAX net
does. MLP_Fea adds "render" {"l0", "l1", "l2"} (nn.Linear layout), a
non-plain density head "basis_mat_density".
"""

import math

import numpy as np
import torch

from hyperreel_tpu_torch.models.mlp import linear_init
from hyperreel_tpu_torch.ops.grid_sample import (
    grid_sample_1d, grid_sample_2d, linspace, resize_bilinear_2d,
    resize_linear_1d)
from hyperreel_tpu_torch.ops.render_math import (
    alpha2weights, raw2alpha, scale_shift_color_all, scale_shift_color_one,
    transform_color_all, transform_color_one)
from hyperreel_tpu_torch.ops.sh import sh_render

MAT_MODE_SPACE = ((0, 1), (0, 2), (1, 2))
MAT_MODE_TIME = ((2, 3), (1, 3), (0, 3))
MAT_MODE = ((0, 1), (0, 2), (1, 2))
VEC_MODE = (2, 1, 0)


def n_to_reso(n_voxels, aabb):
    """Cube-root voxel count -> per-axis resolution, in f32 like the
    reference (utils/tensorf_utils.py:65-69)."""
    aabb = np.asarray(aabb, np.float32)
    ext = aabb[1] - aabb[0]
    voxel_size = np.power(ext.prod() / np.float32(n_voxels),
                          np.float32(1.0 / 3.0), dtype=np.float32)
    return [int(x) for x in (ext / voxel_size)]


def upsample_schedule(n_init, n_final, n_steps):
    """Log-spaced voxel-count schedule (reference
    nlf/nets/tensorf_base.py:171-198)."""
    return [int(round(float(x))) for x in np.exp(np.linspace(
        np.log(n_init), np.log(n_final), n_steps + 1))][1:]


def _tv2d(plane_hwc):
    """Mean squared difference TV of a plane [H, W, C], twice (reference
    utils/tensorf_utils.py:150-166: TVLoss with weight 1, h/w counts)."""
    h_tv = ((plane_hwc[1:] - plane_hwc[:-1]) ** 2).mean()
    w_tv = ((plane_hwc[:, 1:] - plane_hwc[:, :-1]) ** 2).mean()
    return 2.0 * (h_tv + w_tv)


# -- shading and density heads (hyperreel_tpu tensorf.py:83-198; reference
# utils/tensorf_utils.py:334-456, nlf/nets/tensorf_base.py:38-135) ---------

def time_fourier_basis(kw):
    """[..., 2 fpk + 1]: the time t, then cos and sin of each of the
    frames_per_keyframe frequencies at the ray's offset from its keyframe
    (JAX _time_fourier_basis)."""
    fpk, K, F = kw["frames_per_keyframe"], kw["num_keyframes"], \
        kw["total_num_frames"]
    time_offset = kw["time_offset"][..., :1] * (K * (F - 1) / F)
    t = kw["times"][..., :1]
    freqs = torch.arange(fpk, dtype=torch.float32, device=t.device)
    ang = time_offset * freqs * 2.0 * np.pi
    return torch.cat([t, torch.cos(ang), torch.sin(ang)], -1)


def linear_time_basis(kw):
    """[..., 2]: 1 and the time t (the linear heads)."""
    t = kw["times"][..., :1]
    return torch.cat([torch.ones_like(t), t], -1)


def time_colour(features, basis):
    """max(sum_j coeffs[c, j] basis_j + 0.5, 0) per colour channel c, the
    coefficients features [..., 3 * J] channel-major (RGBtLinear,
    RGBtFourier)."""
    coeffs = features.reshape(features.shape[:-1] + (3, basis.shape[-1]))
    return torch.clamp_min((basis[..., None, :] * coeffs).sum(-1) + 0.5, 0.0)


def time_density(features, basis):
    """sum_j features_j basis_j (DensityLinear, DensityFourier)."""
    return (basis * features).sum(-1)


def positional_encoding(x, n):
    """sin of every frequency 2^0 .. 2^(n-1) of every channel, then their
    cos (JAX _positional_encoding)."""
    freqs = 2.0 ** torch.arange(n, dtype=torch.float32, device=x.device)
    ang = (x[..., None] * freqs).reshape(x.shape[:-1] + (-1,))
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1)


def mlp_fea_init(gen, device, app_dim, viewpe, feape, hidden):
    """The MLP_Fea render net's layers (JAX _mlp_render_init: the last
    layer's bias zero)."""
    in_c = 2 * viewpe * 3 + 2 * feape * app_dim + 3 + app_dim
    l2 = linear_init(gen, hidden, 3, device)
    l2["bias"] = torch.zeros_like(l2["bias"])
    return {"l0": linear_init(gen, in_c, hidden, device),
            "l1": linear_init(gen, hidden, hidden, device), "l2": l2}


def mlp_fea(params, viewdirs, features, viewpe, feape):
    """MLPRender_Fea (reference nlf/nets/tensorf_base.py:38-69): sigmoid of
    a two-hidden-layer relu MLP of [features, viewdirs, PE(features),
    PE(viewdirs)]."""
    parts = [features, viewdirs]
    if feape > 0:
        parts.append(positional_encoding(features, feape))
    if viewpe > 0:
        parts.append(positional_encoding(viewdirs, viewpe))
    h = torch.cat(parts, -1)
    for name in ("l0", "l1"):
        h = torch.relu(h @ params[name]["weight"].t() + params[name]["bias"])
    return torch.sigmoid(h @ params["l2"]["weight"].t() + params["l2"]["bias"])


SHADING_MODES = ("SH", "RGB", "RGBIdentity", "MLP_Fea")
TIME_SHADING_MODES = ("RGBtLinear", "RGBtFourier")


class FactoredNet:
    """What the two nets share: the config, validity, normalisation, the
    parameter init of one family, and the shading and composite after
    the grid lookups (SH or RGB colour, per-sample colour scale/shift).
    GRIDS names the two factors of an axis in the params."""

    GRIDS = None

    def __init__(self, cfg):
        self.cfg = dict(cfg)
        self.shading_mode = cfg.get("shadingMode", "SH")
        self.fea2dense = cfg.get("fea2denseAct", "softplus")
        self.density_shift = float(cfg.get("density_shift", -10.0))
        if self.shading_mode not in SHADING_MODES + self.TIME_HEADS:
            raise ValueError(f"unsupported shadingMode {self.shading_mode}")
        if self.fea2dense not in ("relu", "softplus", "relu_abs"):
            raise ValueError(f"density activation {self.fea2dense!r}")
        # the render net of MLP_Fea (JAX _shading_mlp_fea)
        self.view_pe = int(cfg.get("view_pe", 6))
        self.fea_pe = int(cfg.get("fea_pe", 6))
        self.feature_c = int(cfg.get("featureC", 128))
        # the top-k weight filter (JAX tensorf.py:250-254)
        fcfg = cfg.get("filter")
        self.apply_filter_weights = fcfg is not None
        fcfg = fcfg or {}
        self.filter_weight_thresh = float(fcfg.get("weight_thresh", 1e-3))
        self.filter_max_samples = int(fcfg.get("max_samples", 32))
        self.filter_wait_iters = float(fcfg.get("wait_iters", 12000))
        # the kernels' shading flag: SH of degree sh_deg, or RGB =
        # sigmoid of the basis product (JAX tensorf.py _shading_rgb); the
        # other heads take the general chain
        self.shading = self.shading_mode.lower()
        self.table_dtype = torch.bfloat16 if cfg.get("bf16_tables", True) \
            else torch.float32
        self.white_bg = int(cfg.get("white_bg", 0))
        self.black_bg = int(cfg.get("black_bg", 0))
        self.distance_scale = float(cfg.get("distance_scale", 25.0))
        self.ray_march_weight_thres = float(
            cfg.get("rm_weight_mask_thre", 1e-4))
        self.aabb = np.asarray(cfg["aabb"], np.float32)
        self.density_n_comp = list(cfg.get("n_lamb_sigma", [8, 8, 8]))
        self.app_n_comp = list(cfg.get("n_lamb_sh", [24, 24, 24]))
        self.app_dim = int(cfg.get("data_dim_color", 27))
        self.sh_deg = int(round(math.sqrt(self.app_dim / 3))) - 1
        self.grid_size = n_to_reso(int(cfg["N_voxel_init"]), self.aabb)
        # the grid events (reference TensorBase.set_iter): the alpha-mask
        # iterations, the upsample iterations and their voxel counts
        self.upsamp_list = list(cfg.get("upsamp_list", []))
        self.update_alphamask_list = list(
            cfg.get("update_AlphaMask_list", []))
        self.n_voxel_list = upsample_schedule(
            int(cfg.get("N_voxel_init", 2097152)),
            int(cfg.get("N_voxel_final", 2097152)),
            len(self.upsamp_list)) if self.upsamp_list else []
        self.alpha_mask_thres = float(cfg.get("alpha_mask_thre", 1e-3))
        self.active_density = [i for i in range(3)
                               if self.density_n_comp[i] > 0]
        self.active_app = [i for i in range(3) if self.app_n_comp[i] > 0]
        self.fused_render = bool(cfg.get("fused_render", False))
        self.fused_eligible = (
            self.shading_mode in ("SH", "RGB")
            and not self.apply_filter_weights
            and len(self.active_density) >= 1
            and self.active_density == self.active_app
            and self.table_dtype == torch.bfloat16
            and self.ray_march_weight_thres == 0.0
            and self.fea2dense == "relu")

    def grid_value(self, gen, device, shape, scale, uniform):
        """scale * U[0, 1) clipped to [1e-2, 1e8] (the relu density init),
        or scale * N(0, 1)."""
        if uniform:
            return torch.clamp(scale * torch.rand(shape, generator=gen),
                               1e-2, 1e8).to(device)
        return (scale * torch.randn(shape, generator=gen)).to(device)

    # the time heads this net takes (the dynamic net's)
    TIME_HEADS = ()

    def init(self, gen, device):
        """Reference init scales (tensorf_base.py:895-991); relu density
        grids start uniform and clipped at 1e-2, softplus ones 0.1 N(0,
        1); the MLP_Fea render net where the net shades with it."""
        relu = self.fea2dense != "softplus"
        params = {
            "density": self.init_family(gen, device, self.density_n_comp,
                                        1e-2 if relu else 0.1, relu),
            "app": self.init_family(gen, device, self.app_n_comp, 0.1,
                                    False),
            "basis_mat": linear_init(gen, sum(self.app_n_comp),
                                     self.app_dim, device, bias=False),
        }
        return self.init_heads(gen, device, params)

    def init_heads(self, gen, device, params):
        """params with the render net of MLP_Fea added."""
        if self.shading_mode == "MLP_Fea":
            params["render"] = mlp_fea_init(gen, device, self.app_dim,
                                            self.view_pe, self.fea_pe,
                                            self.feature_c)
        return params

    def param_groups(self, params):
        """Optimizer-group labels of the params (reference
        tensorf_base.py:869-893): the grids are "color", the bases
        "color_impl" under an MLP head, else "color", the render net
        "color_impl"."""
        impl = "color_impl" if "MLP" in self.shading_mode else "color"
        groups = {fam: {k: "color" for k in params[fam]}
                  for fam in ("density", "app")}
        for key in ("basis_mat", "basis_mat_density"):
            if key in params:
                groups[key] = {k: impl for k in params[key]}
        if "render" in params:
            groups["render"] = {layer: {k: "color_impl" for k in p}
                                for layer, p in params["render"].items()}
        return groups

    def density_l1(self, params):
        """Mean |.| of every density grid, summed (reference
        tensorf_base.py:1024-1057)."""
        first, second = self.GRIDS
        total = 0.0
        for i in self.active_density:
            for g in (first, second):
                v = params["density"][f"{g}_{i}"]
                # |v| with jnp.abs's gradient 1 at v = 0 (torch's is 0)
                total = total + torch.where(v >= 0, v, -v).mean()
        return total

    def tv_loss_density(self, params):
        return sum(_tv2d(params["density"][f"{self.GRIDS[0]}_{i}"]) * 1e-2
                   for i in self.active_density)

    def tv_loss_app(self, params):
        return sum(_tv2d(params["app"][f"{self.GRIDS[0]}_{i}"]) * 1e-2
                   for i in self.active_app)

    def axis_grids(self, params):
        """Per active axis (i, its plane [H, W, C], its second factor: the
        line [L, C] or the time plane [TH, TW, C]), the density and
        appearance channels concatenated, density first; a generator, so
        that a caller building tables frees each axis's before the next."""
        first, second = self.GRIDS
        for i in self.active_density:
            yield (i, *(torch.cat([params["density"][f"{g}_{i}"],
                                   params["app"][f"{g}_{i}"]], -1)
                        for g in (first, second)))

    def normalize_coord(self, pts):
        aabb = torch.as_tensor(self.aabb, device=pts.device)
        return (pts - aabb[0]) * (2.0 / (aabb[1] - aabb[0])) - 1.0

    def valid_mask(self, pts):
        aabb = torch.as_tensor(self.aabb, device=pts.device)
        return ~((pts < aabb[0]) | (pts > aabb[1])).any(-1)

    def feature2density(self, feat):
        """softplus(feat + density_shift), as log(exp(.) + 1) (the JAX
        net's jnp.logaddexp(., 0)); relu as 0.5 (x + |x|): the same values,
        and at x = 0 the gradient 0.5 of jnp.maximum(x, 0) (the JAX net's
        feature2density), where torch's relu passes 1 (a density grid
        trained to exactly 0); relu_abs as where(x >= 0, x, -x): |x|,
        with the gradient 1 of jnp.abs at 0 (JAX tensorf.py:484)."""
        if self.fea2dense == "softplus":
            return torch.logaddexp(feat + self.density_shift,
                                   torch.zeros_like(feat))
        if self.fea2dense == "relu_abs":
            return torch.where(feat >= 0, feat, -feat)
        return 0.5 * (feat + feat.abs())

    def filter_valid(self, ray_valid, w_pred, ctx):
        """The top-k weight filter (reference tensorf_no_sample.py:
        159-167): from wait_iters on, keep a sample only where its
        predicted weight is at least the ray's k-th largest (less 1e-8:
        ties at the k-th all stay) and above weight_thresh."""
        if not self.apply_filter_weights or ctx.it < self.filter_wait_iters:
            return ray_valid
        kth = torch.topk(w_pred, self.filter_max_samples, -1).values[..., -1:]
        return ray_valid & (w_pred >= kth - 1e-8) \
            & (w_pred > self.filter_weight_thresh)

    def colour(self, params, x, app, B, S, kw):
        """The shading head: appearance [B*S, app_dim] -> rgb [B, S, 3]."""
        mode = self.shading_mode
        if mode == "SH":
            viewdirs = x["viewdirs"].reshape(B * S, 3)
            return sh_render(viewdirs, app, deg=self.sh_deg).reshape(B, S, 3)
        app = app.reshape(B, S, -1)
        if mode == "RGB":
            return torch.sigmoid(app)
        if mode == "RGBIdentity":
            return (app + 0.5).abs()
        if mode == "MLP_Fea":
            return mlp_fea(params["render"], x["viewdirs"].reshape(B, S, 3),
                           app, self.view_pe, self.fea_pe)
        if mode == "RGBtLinear":
            return time_colour(app, linear_time_basis(kw))
        return time_colour(app, time_fourier_basis(kw))

    def shade(self, params, x, feat, app, ray_valid, dists, ctx,
              render_kwargs, pred_weights, kw=None):
        """density feature [B, S] and appearance [B*S, app_dim] -> the
        composited outputs with the render fields (`render_fields`; the
        predicted weights [B, S], or None, for pred_weights_fields; kw
        what the time heads read)."""
        B, S = dists.shape
        deltas = torch.cat([dists[:, 1:] - dists[:, :-1],
                            torch.full_like(dists[:, :1], 1e10)], -1)
        sigma = torch.where(ray_valid, self.feature2density(feat), 0.0)
        alpha, weight, _ = raw2alpha(sigma, deltas * self.distance_scale)
        rgb = self.colour(params, x, app, B, S, kw)
        rgb = torch.where((weight > self.ray_march_weight_thres)[..., None],
                          rgb, 0.0)
        if "color_scale" in x:
            rgb = scale_shift_color_all(rgb, x["color_scale"].reshape(B, S, 3),
                                        x["color_shift"].reshape(B, S, 3))
        elif "color_transform" in x:
            rgb = transform_color_all(
                rgb, x["color_transform"].reshape(B, S, 3, 3),
                x["color_shift"].reshape(B, S, 3))
        acc_map = weight.sum(-1)
        rgb_map = (weight[..., None] * rgb).sum(-2)
        outputs = {"rgb": self.finish(rgb_map, acc_map, x, B, S, ctx)}
        return self.render_fields(outputs, x, weight, pred_weights,
                                  render_kwargs)

    @staticmethod
    def render_fields(outputs, x, weight, pred_weights, render_kwargs):
        """render_kwargs["fields"] into `outputs` (hyperreel_tpu tensorf.py
        :818-834): "render_weights" the weights [B, S]; a field of
        no_over_fields the state's [B, -1]; one of pred_weights_fields
        composited under alpha2weights of the predicted weights; any other
        composited under the render weights [B, channels]."""
        B, S = weight.shape
        no_over = render_kwargs.get("no_over_fields", [])
        pred_w = render_kwargs.get("pred_weights_fields", [])
        pw = alpha2weights(pred_weights) if pred_w else None
        for key in render_kwargs.get("fields", []):
            if key == "render_weights":
                outputs[key] = weight
            elif key in no_over:
                outputs[key] = x[key].reshape(B, -1)
            else:
                w = pw if key in pred_w else weight
                outputs[key] = (w[..., None]
                                * x[key].reshape(B, S, -1)).sum(-2)
        return outputs

    def finish(self, rgb_map, acc_map, x, B, S, ctx=None):
        """The composited colour [B, 3] and opacity [B] -> the rgb: the
        white background where the net has one (in training, without
        white_bg or black_bg, on the background coin: a draw < 0.5, JAX
        tensorf.py:1540-1546), the per-ray (global) colour scale and shift
        of sample 0 where the chain predicts them (reference
        utils/tensorf_utils.py:275-281), or else its global 3x3 transform
        and shift (a color_transform stage; utils/tensorf_utils.py:
        308-331), clamped to [0, 1] at eval."""
        training = ctx is not None and ctx.training
        if not self.black_bg:
            if self.white_bg:
                rgb_map = rgb_map + (1.0 - acc_map[:, None])
            elif training:
                coin = ctx.uniform("background", (), rgb_map.device) < 0.5
                rgb_map = torch.where(coin, rgb_map + (1.0 - acc_map[:, None]),
                                      rgb_map)
        if "color_scale_global" in x:
            rgb_map = scale_shift_color_one(
                rgb_map, x["color_scale_global"].reshape(B, S, 3)[:, 0],
                x["color_shift_global"].reshape(B, S, 3)[:, 0])
        elif "color_transform_global" in x:
            rgb_map = transform_color_one(
                rgb_map, x["color_transform_global"].reshape(B, S, 3, 3)[:, 0],
                x["color_shift_global"].reshape(B, S, 3)[:, 0])
        return rgb_map if training else torch.clamp(rgb_map, 0.0, 1.0)

    # -- the alpha grid of the grid events (hyperreel_tpu
    # compute_alpha_grid of both nets; reference tensorf_base.py:384-429,
    # tensorf_dynamic.py:442-520) ------------------------------------------

    # lattice points per block of x rows in compute_alpha_grid
    ALPHA_BLOCK = 1 << 22

    def compute_alpha_grid(self, params, grid_size=(200, 200, 200)):
        """The occupancy of a dense lattice over the aabb: per point the
        net's `lattice_alpha` (1 - exp(-0.01 feature2density(density)),
        the dynamic net's max over its keyframes), max-pooled 3^3 ("SAME",
        padded with -inf), thresholded at alpha_mask_thre -> (binary [gz,
        gy, gx] f32, the occupied points' box [2, 3], inf where none is
        occupied); x rows in blocks of at most ALPHA_BLOCK lattice
        points."""
        gx, gy, gz = grid_size
        dev = params["basis_mat"]["weight"].device
        aabb = torch.as_tensor(self.aabb, device=dev)
        xs, ys, zs = (linspace(0.0, 1.0, n, dev) for n in grid_size)
        rows = max(1, self.ALPHA_BLOCK // (gy * gz))
        alpha, pts_all = [], []
        with torch.no_grad():
            for r0 in range(0, gx, rows):
                grid = torch.stack(torch.meshgrid(
                    xs[r0:r0 + rows], ys, zs, indexing="ij"), -1)
                pts = aabb[0] * (1 - grid) + aabb[1] * grid
                a = self.lattice_alpha(
                    params, self.normalize_coord(pts.reshape(-1, 3)))
                alpha.append(a.reshape(-1, gy, gz))
                pts_all.append(pts)
            alpha = torch.clamp(torch.cat(alpha), 0.0, 1.0)
            alpha_t = alpha.permute(2, 1, 0)[None, None]
            pooled = torch.nn.functional.max_pool3d(alpha_t, 3, 1, 1)[0, 0]
            binary = (pooled >= self.alpha_mask_thres).float()
            occupied = (binary > 0.5)[..., None]
            pts_t = torch.cat(pts_all).permute(2, 1, 0, 3)
            inf = torch.full((3,), float("inf"), device=dev)
            mins = torch.where(occupied, pts_t, inf).amin((0, 1, 2))
            maxs = torch.where(occupied, pts_t, -inf).amax((0, 1, 2))
        return binary, torch.stack([mins, maxs])

    def density_alpha(self, feat):
        """1 - exp(-0.01 feature2density(feat)): a lattice point's
        alpha."""
        return 1.0 - torch.exp(-self.feature2density(feat) * 0.01)

    # -- the net's own fused route (hyperreel_tpu TensorVMNoSample and
    # TensorVMKeyframeTime _fused_ok, apply_fused, _apply_fused_multi,
    # _apply_fused_multi_time, _fused_out) --------------------------------

    # the second factors of the fused route are time planes (the dynamic
    # net), else lines; the pack has the weights row (the static net's
    # predicted weights; the dynamic net sets them to ones)
    TIME_PLANES = False
    FUSED_WEIGHTS = True

    def fused_ok(self, x, render_kwargs):
        """Whether an eval call takes the fused route: the config asks for
        it, the net is eligible, and neither x nor render_kwargs asks for
        what the kernels do not compute (a field but the distances)."""
        return (self.fused_render and self.fused_eligible
                and "color_transform" not in x
                and all(f == "distances"
                        for f in render_kwargs.get("fields", []))
                and not render_kwargs.get("pred_weights_fields")
                and not render_kwargs.get("no_over_fields"))

    def prepare_fused(self, params):
        """Per-checkpoint tables of the fused route: per active axis the
        plane's bf16 quad table and its f32 second factor (the line, or
        the time plane [TH, L, C]), and the basis table on the host (with
        zero density columns for the single-axis form, which runs K2; over
        the appearance channels for K5)."""
        # imported here: the kernel modules import this one
        from hyperreel_tpu_torch.ops.kernels.shade import basis_table
        from hyperreel_tpu_torch.ops.kernels.shade_multi import (
            axis_tables, multi_basis_table)
        axes, quads, lines, _ = axis_tables(self.axis_grids(params),
                                            self.density_n_comp,
                                            self.TIME_PLANES)
        w = params["basis_mat"]["weight"]
        wb = basis_table(w, axes[0].nd) if len(axes) == 1 \
            else multi_basis_table(w)
        return {"axes": axes, "quads": quads, "lines": lines, "wb": wb}

    def fused_time(self, x, B):
        """The ray pack's time coordinate [B] (0 for a static net)."""
        return x["viewdirs"].new_zeros(B)

    def fused_pack(self, x):
        """The general chain's fields x -> (the pack f32 [10, B*S], or [11,
        B*S] with the weights row: points normalised, distances, colour
        scale and shift, the predicted weights; the ray pack f32 [B, 8]
        with the view direction of each ray's sample 0, zero origin, and
        the time coordinate of its sample 0, `fused_time`)."""
        B = x["viewdirs"].shape[0]
        pts = x["points"].reshape(B, -1, 3)
        N = pts.shape[0] * pts.shape[1]
        rows = [self.normalize_coord(pts).reshape(N, 3).t(),
                x["distances"].reshape(1, N)]
        for key in ("color_scale", "color_shift"):
            rows.append(x[key].reshape(N, 3).t() if key in x
                        else pts.new_zeros(3, N))
        if self.FUSED_WEIGHTS:
            rows.append(x["weights"].reshape(1, N) if "weights" in x
                        else pts.new_ones(1, N))
        vd = x["viewdirs"].reshape(B, -1, 3)[:, 0].float()
        ray_pack = torch.cat([torch.zeros_like(vd), vd, vd.new_zeros(B, 1),
                              self.fused_time(x, B).float()[:, None]],
                             1).contiguous()
        return torch.cat(rows).float().contiguous(), ray_pack

    def fused_spec(self, prep, S):
        """The kernel spec of the fused route for S samples per ray: K2's
        ShadeSpec for one axis (a static net's z line its premixed table,
        a dynamic net's time plane its time table), K5's MultiSpec for
        more; RGB or SH, with the weights row on the static net."""
        from hyperreel_tpu_torch.ops.kernels.shade import ShadeSpec
        from hyperreel_tpu_torch.ops.kernels.shade_multi import MultiSpec
        axes = prep["axes"]
        if len(axes) > 1:
            return MultiSpec(S=S, axes=axes, deg=self.sh_deg,
                             distance_scale=self.distance_scale,
                             shading=self.shading,
                             weights=self.FUSED_WEIGHTS)
        a, = axes
        if a.index != 0:
            raise NotImplementedError(
                f"the single-axis fused route takes axis 0, not {a.index} "
                "(as the JAX package's apply_fused)")
        return ShadeSpec(S=S, W=a.W, H=a.H, TW=a.L, TH=a.TH, C=a.C, nd=a.nd,
                         deg=self.sh_deg, distance_scale=self.distance_scale,
                         shading=self.shading, weights=self.FUSED_WEIGHTS)

    def apply_fused(self, params, x, render_kwargs):
        """The fused eval render after the general stage chain: the
        samples' pack (`fused_pack`) and its ray pack, then one kernel. One
        axis (a plane over x, y times a z line or a z-t time plane) runs K2
        (a static net's line as its premixed [L, C] table, TH = 0, which
        computes what the JAX package's degenerate TH = 1 time plane does:
        its t weights put 1 on the one row); more axes run K5. Both kernels
        load their texels themselves, where the JAX route gathers the quad
        rows in the host graph. The kernels read the time coordinate per
        ray where the JAX route packs it per sample: the chain broadcasts
        each ray's base time to its samples (AdvectPointsEmbedding,
        AddPointOutputsEmbedding), so sample 0's is every sample's. The
        tables come from render_kwargs["cf_prepared"] (prepare_fused) or
        are built here."""
        from hyperreel_tpu_torch.ops.kernels.shade import shade
        from hyperreel_tpu_torch.ops.kernels.shade_multi import shade_multi
        prep = render_kwargs.get("cf_prepared") or self.prepare_fused(params)
        pack, ray_pack = self.fused_pack(x)
        B = ray_pack.shape[0]
        S = pack.shape[1] // B
        spec = self.fused_spec(prep, S)
        if len(prep["axes"]) == 1:
            out = shade(prep["quads"][0], pack, ray_pack, prep["lines"][0],
                        prep["wb"], spec)
        else:
            out = shade_multi(prep["quads"], prep["lines"], pack, ray_pack,
                              prep["wb"], spec)
        outputs = {"rgb": self.finish(out[:, :3], out[:, 3], x, B, S)}
        if "distances" in render_kwargs.get("fields", []):
            outputs["distances"] = out[:, 4:5]
        return outputs


class TensorVMKeyframeTime(FactoredNet):
    """The dynamic net: per active axis a space plane times a keyframe time
    plane (reference nlf/nets/tensorf_dynamic.py)."""

    GRIDS = ("space", "time")
    TIME_HEADS = TIME_SHADING_MODES
    DENSITY_MODES = ("Density", "DensityLinear", "DensityFourier")

    def __init__(self, cfg, num_keyframes=1, total_num_frames=1):
        cfg = dict(cfg)
        self.num_keyframes = num_keyframes
        self.total_num_frames = total_num_frames
        self.frames_per_keyframe = int(cfg.get(
            "frames_per_keyframe",
            max(total_num_frames // max(num_keyframes, 1), 1)))
        self.density_mode = cfg.get("densityMode", "Density")
        if self.density_mode not in self.DENSITY_MODES:
            raise ValueError(self.density_mode)
        # the density head's channels (JAX tensorf.py:978-987)
        self.data_dim_density = {
            "Density": 1, "DensityLinear": 2,
            "DensityFourier": self.frames_per_keyframe * 2 + 1}[
                self.density_mode]
        # the time heads fix the colour net's output (JAX :989-992)
        shading = cfg.get("shadingMode", "SH")
        if shading == "RGBtLinear":
            cfg["data_dim_color"] = 2 * 3
        elif shading == "RGBtFourier":
            cfg["data_dim_color"] = (self.frames_per_keyframe * 2 + 1) * 3
        super().__init__(cfg)
        self.fused_eligible = self.fused_eligible \
            and self.density_mode == "Density"
        self.time_scale_factor = (total_num_frames - 1) / total_num_frames
        self.time_pixel_offset = 0.5 / num_keyframes

    def init(self, gen, device):
        """FactoredNet.init, and the density head's basis where the head
        is not plain density."""
        params = super().init(gen, device)
        if self.density_mode != "Density":
            params["basis_mat_density"] = linear_init(
                gen, sum(self.density_n_comp), self.data_dim_density, device,
                bias=False)
        return params

    def time_kw(self, times, time_offset):
        """What the time heads read (the JAX apply's kw) at the samples'
        times and offsets from their keyframes."""
        return {"frames_per_keyframe": self.frames_per_keyframe,
                "num_keyframes": self.num_keyframes,
                "total_num_frames": self.total_num_frames,
                "times": times, "time_offset": time_offset}

    def decode_density(self, params, dens, kw):
        """The density features [N, sum of density channels] -> the density
        feature [N]: their sum (Density), or the density basis's output
        [N, data_dim_density] dotted with the time basis (DensityLinear,
        DensityFourier; JAX _density_linear, _density_fourier)."""
        if self.density_mode == "Density":
            return dens.sum(-1)
        out = dens @ params["basis_mat_density"]["weight"].t()
        basis = linear_time_basis(kw) if self.density_mode == "DensityLinear" \
            else time_fourier_basis(kw)
        return time_density(out, basis.reshape(out.shape[0], -1))

    def init_family(self, gen, device, n_comp, scale, uniform):
        params = {}
        gs, K = self.grid_size, self.num_keyframes
        for i in range(3):
            if n_comp[i] == 0:
                continue
            ms0, ms1 = MAT_MODE_SPACE[i]
            mt0, _ = MAT_MODE_TIME[i]
            shapes = {"space": (gs[ms1], gs[ms0], n_comp[i]),
                      "time": (K, gs[mt0], n_comp[i])}
            for kind, shape in shapes.items():
                params[f"{kind}_{i}"] = self.grid_value(gen, device, shape,
                                                        scale, uniform)
        return params

    def normalize_time_coord(self, t):
        """(reference tensorf_dynamic.py:615-616)."""
        return (t * self.time_scale_factor + self.time_pixel_offset) \
            * 2.0 - 1.0

    def sample(self, params, xyzt, kw=None):
        """xyzt [N, 4] normalized -> (density feature [N], app [N, app_dim])
        from the products of space and time lookups at table precision,
        the density decoded by the density head (kw the time heads')."""
        dens, app = [], []
        for i, space, timep in self.axis_grids(params):
            ms0, ms1 = MAT_MODE_SPACE[i]
            mt0, mt1 = MAT_MODE_TIME[i]
            nd = self.density_n_comp[i]
            prod = grid_sample_2d(space.to(self.table_dtype),
                                  xyzt[:, [ms0, ms1]]) \
                * grid_sample_2d(timep.to(self.table_dtype),
                                 xyzt[:, [mt0, mt1]])
            dens.append(prod[:, :nd])
            app.append(prod[:, nd:])
        feat = torch.cat(app, -1)
        return self.decode_density(params, torch.cat(dens, -1), kw), \
            feat @ params["basis_mat"]["weight"].t()

    # the fused route's second factors are the time planes; the pack has no
    # weights row (the net sets the predicted weights to ones, JAX
    # tensorf.py:1484-1486)
    TIME_PLANES = True
    FUSED_WEIGHTS = False

    def fused_time(self, x, B):
        """The normalised base time of each ray's sample 0 [B]."""
        return self.normalize_time_coord(
            x["base_times"].reshape(B, -1)[:, 0])

    def apply(self, params, x, ctx, render_kwargs=None):
        """The general apply (eval and training; in training no clamp and
        the background coin, `finish`), or at eval the net's own fused
        route. The predicted weights are not applied (the net sets them to
        ones, JAX tensorf.py:1484-1486); pred_weights_fields read them."""
        render_kwargs = render_kwargs or {}
        if not ctx.training and self.fused_ok(x, render_kwargs):
            return self.apply_fused(params, x, render_kwargs)
        B = x["viewdirs"].shape[0]
        pts = x["points"].reshape(B, -1, 3)
        S = pts.shape[1]
        base_times = x["base_times"].reshape(B, S, 1)
        dists = x["distances"].reshape(B, S)
        ray_valid = self.valid_mask(pts) & (dists > 0)
        pred = x["weights"].reshape(B, S) if "weights" in x else None
        if self.apply_filter_weights:
            ray_valid = self.filter_valid(ray_valid, pred, ctx)
        xyzt = torch.cat([self.normalize_coord(pts),
                          self.normalize_time_coord(base_times)], -1)
        kw = self.time_kw(x["times"].reshape(B, S, 1),
                          x["time_offset"].reshape(B, S, 1)) \
            if self.density_mode != "Density" \
            or self.shading_mode in TIME_SHADING_MODES else None
        dens, app = self.sample(params, xyzt.reshape(-1, 4), kw)
        return self.shade(params, x, dens.reshape(B, S), app, ray_valid,
                          dists, ctx, render_kwargs, pred, kw)

    # -- grid events (hyperreel_tpu TensorVMKeyframeTime upsample, shrink,
    # compute_alpha_grid; reference tensorf_dynamic.py:395-520) -----------

    def upsample(self, params, new_grid_size):
        """Every space plane resized bilinearly to the new grid, every time
        plane along its space axis (its keyframe rows kept); sets
        `grid_size`. Returns new params (fresh leaves)."""
        new = {k: dict(v) for k, v in params.items()}
        with torch.no_grad():
            for fam, comps in (("density", self.density_n_comp),
                               ("app", self.app_n_comp)):
                for i in range(3):
                    if comps[i] == 0:
                        continue
                    ms0, ms1 = MAT_MODE_SPACE[i]
                    mt0, _ = MAT_MODE_TIME[i]
                    new[fam][f"space_{i}"] = resize_bilinear_2d(
                        params[fam][f"space_{i}"], new_grid_size[ms1],
                        new_grid_size[ms0])
                    new[fam][f"time_{i}"] = resize_bilinear_2d(
                        params[fam][f"time_{i}"], self.num_keyframes,
                        new_grid_size[mt0])
        self.grid_size = list(new_grid_size)
        return new

    def shrink(self, params, new_aabb):
        """The dynamic net keeps its grids and only tightens the aabb (as
        the JAX package's; the reference's shipped configs never shrink
        it)."""
        self.aabb = np.asarray(new_aabb, np.float32)
        return params

    def sample_density(self, params, xyzt):
        """The density feature [N] at normalized xyzt [N, 4] from the f32
        grids (hyperreel_tpu _sample_density_t), decoded by the density
        head at time 0 and offset 0 (its compute_alpha_grid)."""
        dens = []
        for i in self.active_density:
            ms0, ms1 = MAT_MODE_SPACE[i]
            mt0, mt1 = MAT_MODE_TIME[i]
            dens.append(grid_sample_2d(params["density"][f"space_{i}"],
                                       xyzt[:, [ms0, ms1]])
                        * grid_sample_2d(params["density"][f"time_{i}"],
                                         xyzt[:, [mt0, mt1]]))
        zeros = xyzt.new_zeros(xyzt.shape[0], 1)
        return self.decode_density(params, torch.cat(dens, -1),
                                   self.time_kw(zeros, zeros))

    def lattice_alpha(self, params, xyz):
        """The alpha of normalized lattice points xyz [N, 3]: the max over
        the keyframes (JAX compute_alpha_grid's one_t over t_norm)."""
        t_norm = self.normalize_time_coord(
            linspace(0.0, 1.0, self.num_keyframes, xyz.device))
        a = None
        for t in t_norm:
            xyzt = torch.cat([xyz, t.expand(xyz.shape[0], 1)], -1)
            at = self.density_alpha(self.sample_density(params, xyzt))
            a = at if a is None else torch.maximum(a, at)
        return a


class TensorVMNoSample(FactoredNet):
    """The static net: per active axis a plane times a line, the full VM
    decomposition (reference nlf/nets/tensorf_no_sample.py)."""

    GRIDS = ("plane", "line")

    def init_family(self, gen, device, n_comp, scale, uniform):
        params = {}
        gs = self.grid_size
        for i in range(3):
            if n_comp[i] == 0:
                continue
            m0, m1 = MAT_MODE[i]
            params[f"plane_{i}"] = self.grid_value(
                gen, device, (gs[m1], gs[m0], n_comp[i]), scale, uniform)
            params[f"line_{i}"] = self.grid_value(
                gen, device, (gs[VEC_MODE[i]], n_comp[i]), scale, uniform)
        return params

    def sample(self, params, xyz):
        """xyz [N, 3] normalized -> (density feature [N], app [N, app_dim]):
        per axis the density and appearance planes and lines packed
        channel-wise, looked up at table precision (hyperreel_tpu
        TensorVMNoSample._sample_density_and_app_cf)."""
        dens, app = 0.0, []
        for i, plane, line in self.axis_grids(params):
            m0, m1 = MAT_MODE[i]
            nd = self.density_n_comp[i]
            prod = grid_sample_2d(plane.to(self.table_dtype),
                                  xyz[:, [m0, m1]]) \
                * grid_sample_1d(line.to(self.table_dtype),
                                 xyz[:, VEC_MODE[i]])
            dens = dens + prod[:, :nd].sum(-1)
            app.append(prod[:, nd:])
        return dens, torch.cat(app, -1) @ params["basis_mat"]["weight"].t()

    def fused_ok(self, x, render_kwargs):
        return super().fused_ok(x, render_kwargs) and "weights_shift" not in x

    def apply(self, params, x, ctx, render_kwargs=None):
        """The general apply (eval and training), or at eval the net's own
        fused route. The predicted sample weights (ones where the chain
        gives none) scale the density feature before the activation, and
        a predicted weights_shift is added to it (reference
        tensorf_no_sample.py:184-192)."""
        render_kwargs = render_kwargs or {}
        if not ctx.training and self.fused_ok(x, render_kwargs):
            return self.apply_fused(params, x, render_kwargs)
        B = x["viewdirs"].shape[0]
        pts = x["points"].reshape(B, -1, 3)
        S = pts.shape[1]
        dists = x["distances"].reshape(B, S)
        weights = x["weights"].reshape(B, S) if "weights" in x \
            else torch.ones_like(dists)
        ray_valid = self.filter_valid(
            self.valid_mask(pts) & (dists > 0), weights, ctx)
        dens, app = self.sample(params,
                                self.normalize_coord(pts).reshape(-1, 3))
        feat = dens.reshape(B, S) * weights
        if "weights_shift" in x:
            feat = feat + x["weights_shift"].reshape(B, S)
        return self.shade(params, x, feat, app, ray_valid, dists, ctx,
                          render_kwargs, weights)

    # -- grid events (hyperreel_tpu TensorVMNoSample upsample, shrink,
    # compute_alpha_grid; reference tensorf_base.py:384-429, 1151-1232) ----

    def sample_density(self, params, xyz):
        """The density feature [N] at normalized xyz [N, 3] from the f32
        grids (hyperreel_tpu TensorVMNoSample._sample_density)."""
        total = 0.0
        for i in self.active_density:
            m0, m1 = MAT_MODE[i]
            prod = grid_sample_2d(params["density"][f"plane_{i}"],
                                  xyz[:, [m0, m1]]) \
                * grid_sample_1d(params["density"][f"line_{i}"],
                                 xyz[:, VEC_MODE[i]])
            total = total + prod.sum(-1)
        return total

    def lattice_alpha(self, params, xyz):
        """The alpha of normalized lattice points xyz [N, 3]."""
        return self.density_alpha(self.sample_density(params, xyz))

    def upsample(self, params, new_grid_size):
        """Every plane resized bilinearly and every line linearly to the
        new grid; sets `grid_size`. Returns new params (fresh leaves)."""
        new = {k: dict(v) for k, v in params.items()}
        with torch.no_grad():
            for fam, comps in (("density", self.density_n_comp),
                               ("app", self.app_n_comp)):
                for i in range(3):
                    if comps[i] == 0:
                        continue
                    m0, m1 = MAT_MODE[i]
                    new[fam][f"plane_{i}"] = resize_bilinear_2d(
                        params[fam][f"plane_{i}"], new_grid_size[m1],
                        new_grid_size[m0])
                    new[fam][f"line_{i}"] = resize_linear_1d(
                        params[fam][f"line_{i}"], new_grid_size[VEC_MODE[i]])
        self.grid_size = list(new_grid_size)
        return new

    def shrink(self, params, new_aabb):
        """Crop every plane and line to the texels of the box new_aabb
        [2, 3] (the corners rounded to the nearest texel, in float64 as the
        JAX package computes them), set the aabb to the cropped texels' box
        and `grid_size` to their counts. Returns new params (fresh
        leaves)."""
        aabb = np.asarray(self.aabb, np.float64)
        gs = np.asarray(self.grid_size)
        units = (aabb[1] - aabb[0]) / (gs - 1)
        new_aabb = np.asarray(new_aabb)
        t_l = np.round(np.round((new_aabb[0] - aabb[0]) / units)).astype(int)
        b_r = np.round((new_aabb[1] - aabb[0]) / units).astype(int) + 1
        b_r = np.minimum(b_r, gs)
        t_l = np.maximum(t_l, 0)
        new = {k: dict(v) for k, v in params.items()}
        for fam, comps in (("density", self.density_n_comp),
                           ("app", self.app_n_comp)):
            for i in range(3):
                if comps[i] == 0:
                    continue
                m0, m1 = MAT_MODE[i]
                v = VEC_MODE[i]
                new[fam][f"plane_{i}"] = params[fam][f"plane_{i}"][
                    t_l[m1]:b_r[m1], t_l[m0]:b_r[m0]].clone()
                new[fam][f"line_{i}"] = params[fam][f"line_{i}"][
                    t_l[v]:b_r[v]].clone()
        t_l_r = t_l / (gs - 1)
        b_r_r = (b_r - 1) / (gs - 1)
        self.aabb = np.stack([(1 - t_l_r) * aabb[0] + t_l_r * aabb[1],
                              (1 - b_r_r) * aabb[0] + b_r_r * aabb[1]]
                             ).astype(np.float32)
        self.grid_size = [int(n) for n in (b_r - t_l)]
        return new


def build_color_net(cfg, dataset_info=None):
    dataset_info = dataset_info or {}
    if cfg["type"] == "tensor_vm_split_time":
        return TensorVMKeyframeTime(
            cfg, num_keyframes=int(dataset_info.get("num_keyframes", 1)),
            total_num_frames=int(dataset_info.get("num_frames", 1)))
    if cfg["type"] == "tensor_vm_split_no_sample":
        return TensorVMNoSample(cfg)
    # imported here: tensorf_extra imports this module
    from hyperreel_tpu_torch.models import tensorf_extra
    extra = {"tensor_vm": tensorf_extra.TensorVMJoint,
             "tensor_cp": tensorf_extra.TensorCP,
             "tensor_vm_split": tensorf_extra.TensorVMStandalone}
    if cfg["type"] in extra:
        return extra[cfg["type"]](cfg)
    if cfg["type"] == "multiple":
        # the cascade of colour nets (JAX tensorf.py:1696-1706)
        nets = cfg["nets"]
        return tensorf_extra.MultipleNet(
            [build_color_net(nc, dataset_info) for nc in nets],
            [float(nc.get("wait_iters", 0)) for nc in nets],
            [float(nc.get("stop_iters", float("inf"))) for nc in nets],
            [float(nc.get("scale", 1.0)) for nc in nets])
    if cfg["type"] == "tensor_vm_split_reflect":
        raise NotImplementedError(
            "colour net 'tensor_vm_split_reflect' is not ported: its normal "
            "is the gradient of density with respect to position, and "
            "training it needs a double backward through the grid lookups "
            "(ROADMAP.md: long tail)")
    raise NotImplementedError(
        f"colour net {cfg['type']!r} is not ported (ROADMAP.md: long tail)")
