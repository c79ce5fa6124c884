"""Dynamic factored feature-grid colour net (port of
hyperreel_tpu/models/tensorf.py TensorVMKeyframeTime with the parts of
TensorVMNoSample it uses: init and the general apply; reference
nlf/nets/tensorf_dynamic.py, nlf/nets/tensorf_no_sample.py).

Grids are channels-last, as in the JAX package: per active axis i a space
plane [H, W, C] and a time plane [num_keyframes, TW, C] for each of the
density and appearance families; `basis_mat` is {"weight": [app_dim,
sum(app comps)]} (nn.Linear layout).
"""

import math

import numpy as np
import torch

from hyperreel_tpu_torch.models.mlp import linear_init
from hyperreel_tpu_torch.ops.grid_sample import grid_sample_2d
from hyperreel_tpu_torch.ops.render_math import (
    raw2alpha, scale_shift_color_all)
from hyperreel_tpu_torch.ops.sh import sh_render

MAT_MODE_SPACE = ((0, 1), (0, 2), (1, 2))
MAT_MODE_TIME = ((2, 3), (1, 3), (0, 3))


def n_to_reso(n_voxels, aabb):
    """Cube-root voxel count -> per-axis resolution, in f32 like the
    reference (utils/tensorf_utils.py:65-69)."""
    aabb = np.asarray(aabb, np.float32)
    ext = aabb[1] - aabb[0]
    voxel_size = np.power(ext.prod() / np.float32(n_voxels),
                          np.float32(1.0 / 3.0), dtype=np.float32)
    return [int(x) for x in (ext / voxel_size)]


class TensorVMKeyframeTime:
    def __init__(self, cfg, num_keyframes=1, total_num_frames=1):
        self.cfg = dict(cfg)
        self.num_keyframes = num_keyframes
        self.total_num_frames = total_num_frames
        self.time_scale_factor = (total_num_frames - 1) / total_num_frames
        self.time_pixel_offset = 0.5 / num_keyframes
        self.density_mode = cfg.get("densityMode", "Density")
        self.shading_mode = cfg.get("shadingMode", "SH")
        self.fea2dense = cfg.get("fea2denseAct", "softplus")
        if self.density_mode != "Density" or self.shading_mode != "SH" \
                or self.fea2dense != "relu" or cfg.get("filter"):
            raise NotImplementedError(
                "only the flagship's Density/SH/relu colour net is ported "
                "(ROADMAP.md: K5/K6 and the other net families)")
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
        self.active_density = [i for i in range(3)
                               if self.density_n_comp[i] > 0]
        self.active_app = [i for i in range(3) if self.app_n_comp[i] > 0]
        self.fused_render = bool(cfg.get("fused_render", False))
        self.fused_eligible = (
            len(self.active_density) >= 1
            and self.active_density == self.active_app
            and self.table_dtype == torch.bfloat16
            and self.ray_march_weight_thres == 0.0)

    # -- params ------------------------------------------------------------

    def _init_family(self, gen, device, n_comp, scale, uniform):
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
                if uniform:
                    v = torch.clamp(scale * torch.rand(shape, generator=gen),
                                    1e-2, 1e8)
                else:
                    v = scale * torch.randn(shape, generator=gen)
                params[f"{kind}_{i}"] = v.to(device)
        return params

    def init(self, gen, device):
        """Reference init scales (tensorf_base.py:895-991); relu density
        grids start uniform and clipped at 1e-2."""
        return {
            "density": self._init_family(gen, device, self.density_n_comp,
                                         1e-2, True),
            "app": self._init_family(gen, device, self.app_n_comp, 0.1,
                                     False),
            "basis_mat": linear_init(gen, sum(self.app_n_comp),
                                     self.app_dim, device, bias=False),
        }

    # -- general eval path -------------------------------------------------

    def normalize_coord(self, pts):
        aabb = torch.as_tensor(self.aabb, device=pts.device)
        return (pts - aabb[0]) * (2.0 / (aabb[1] - aabb[0])) - 1.0

    def normalize_time_coord(self, t):
        """(reference tensorf_dynamic.py:615-616)."""
        return (t * self.time_scale_factor + self.time_pixel_offset) \
            * 2.0 - 1.0

    def valid_mask(self, pts):
        aabb = torch.as_tensor(self.aabb, device=pts.device)
        return ~((pts < aabb[0]) | (pts > aabb[1])).any(-1)

    def sample(self, params, xyzt):
        """xyzt [N, 4] normalized -> (density feature [N], app [N, app_dim])
        from the products of space and time lookups at table precision."""
        dens, app = [], []
        for i in self.active_density:
            ms0, ms1 = MAT_MODE_SPACE[i]
            mt0, mt1 = MAT_MODE_TIME[i]
            nd = self.density_n_comp[i]
            space = torch.cat([params["density"][f"space_{i}"],
                               params["app"][f"space_{i}"]], -1)
            timep = torch.cat([params["density"][f"time_{i}"],
                               params["app"][f"time_{i}"]], -1)
            prod = grid_sample_2d(space.to(self.table_dtype),
                                  xyzt[:, [ms0, ms1]]) \
                * grid_sample_2d(timep.to(self.table_dtype),
                                 xyzt[:, [mt0, mt1]])
            dens.append(prod[:, :nd])
            app.append(prod[:, nd:])
        feat = torch.cat(app, -1)
        return torch.cat(dens, -1).sum(-1), \
            feat @ params["basis_mat"]["weight"].t()

    def apply(self, params, x, ctx, render_kwargs=None):
        if ctx.training:
            raise NotImplementedError(
                "training is not ported (ROADMAP.md: flagship training "
                "step)")
        render_kwargs = render_kwargs or {}
        fields = list(render_kwargs.get("fields", []))
        if any(f != "distances" for f in fields):
            raise NotImplementedError(
                f"render fields {fields} are not ported "
                "(ROADMAP.md: render CLI and viewer)")
        B = x["viewdirs"].shape[0]
        pts = x["points"].reshape(B, -1, 3)
        S = pts.shape[1]
        base_times = x["base_times"].reshape(B, S, 1)
        dists = x["distances"].reshape(B, S)
        deltas = torch.cat([dists[:, 1:] - dists[:, :-1],
                            torch.full_like(dists[:, :1], 1e10)], -1)
        viewdirs = x["viewdirs"].reshape(B, S, 3)
        ray_valid = self.valid_mask(pts) & (dists > 0)

        xyzt = torch.cat([self.normalize_coord(pts),
                          self.normalize_time_coord(base_times)], -1)
        dens, app = self.sample(params, xyzt.reshape(-1, 4))
        sigma = torch.where(ray_valid,
                            torch.clamp_min(dens.reshape(B, S), 0.0), 0.0)
        alpha, weight, _ = raw2alpha(sigma, deltas * self.distance_scale)
        rgb = sh_render(viewdirs.reshape(-1, 3), app,
                        deg=self.sh_deg).reshape(B, S, 3)
        rgb = torch.where((weight > self.ray_march_weight_thres)[..., None],
                          rgb, 0.0)
        if "color_scale" in x:
            rgb = scale_shift_color_all(rgb, x["color_scale"].reshape(B, S, 3),
                                        x["color_shift"].reshape(B, S, 3))
        acc_map = weight.sum(-1)
        rgb_map = (weight[..., None] * rgb).sum(-2)
        if not self.black_bg and self.white_bg:
            rgb_map = rgb_map + (1.0 - acc_map[:, None])
        outputs = {"rgb": torch.clamp(rgb_map, 0.0, 1.0)}
        if fields:
            outputs["distances"] = (weight * dists).sum(-1, keepdim=True)
        return outputs


def build_color_net(cfg, dataset_info=None):
    dataset_info = dataset_info or {}
    if cfg["type"] != "tensor_vm_split_time":
        raise NotImplementedError(
            f"colour net {cfg['type']!r} is not ported "
            "(ROADMAP.md: K5/K6 and the other net families)")
    return TensorVMKeyframeTime(
        cfg, num_keyframes=int(dataset_info.get("num_keyframes", 1)),
        total_num_frames=int(dataset_info.get("num_frames", 1)))
