"""Fused eval render of the flagship dynamic model on CUDA kernels (port of
hyperreel_tpu/models/fused_eval.py FusedCFEval, dyn1 routes).

  rays -> encodings -> K1 pack_build (the prediction MLP, its last
  layer's columns permuted field-major on the host; field activations, z,
  distances, sort, advection, offsets, normalisation: the per-sample
  pack) -> the space features, the time features, density, SH colour,
  composite -> rgb, on one of three routes:

  quad   K2 shade reads each sample's quad-table row;
  patch  (coherent_gather [px, py, R] in the net config) K3 shade_patch
         blends each (block, slot)'s patch row inside the shade kernel;
         with HYPERREEL_FUSED_PATCH=0 (or false), K4 patch_blend writes
         bf16 features and K2 shade_preblended reads them.

The patch route is the JAX package's coherent patch-gather: coherent
block j is the caller's rays R*j .. R*j+R-1 (R = 8 when the config asks
for 8, else 4); `render_kwargs["rays_phase_major"]` says the caller
delivers them phase-major (ray R*j+p at position p*(B/R)+j, as bench.py
does) and takes the outputs in that order. The kernels find a block's
rays by that stride, so no ray is permuted. The port takes the patch
route whenever B % R == 0 (the JAX package also needs its tile to
divide). It is exact where every block's footprint fits the patch and
zero-degrades where it does not; the call returns the witness
outputs["patch_coverage_viol"] = the fraction of (block, slot) pairs
whose valid samples' footprint exits the patch (ops/kernels/
patch_blend.py), for the caller to gate on (bench.py holds it to 1e-4).

`uniform_time` (every ray of the call shares one t, as in a frame render)
premixes the keyframe rows of the time plane for that t on the device,
and the call returns the witness outputs["uniform_time_viol"] = max |tn -
tn[0]|. Configurations that the JAX package renders on another fused
route raise NotImplementedError; chains that are not the flagship pattern
have no fused path and take the general stage chain, as in the JAX
package.
"""

import os

import numpy as np
import torch

from hyperreel_tpu_torch.models.activations import Activation
from hyperreel_tpu_torch.models.embeddings import get_base_time
from hyperreel_tpu_torch.ops.kernels.pack_build import (
    PackSpec, mlp_tables, pack_build)
from hyperreel_tpu_torch.ops.kernels.patch_blend import PatchSpec, patch_blend
from hyperreel_tpu_torch.ops.kernels.shade import (
    ShadeSpec, basis_table, premix_time, quad_table, shade, shade_preblended,
    time_table)
from hyperreel_tpu_torch.ops.kernels.shade_patch import shade_patch
from hyperreel_tpu_torch.ops.patch_gather import build_patch_table_2d

DYN_CHAIN = ["ray_prediction_0", "ray_intersect_0", "flow_0",
             "point_offset_0", "add_point_outputs_0", "extract_fields"]


def _stages(model):
    return dict(model.embedding.stages)


def cf_eligible(model):
    """Structural eligibility: the technicolor_z_plane-family chain
    (hyperreel_tpu/models/fused_eval.py cf_eligible, dynamic chain)."""
    names = [n for n, _ in model.embedding.stages]
    if names != DYN_CHAIN:
        return False
    st = _stages(model)
    pred, isect = st["ray_prediction_0"], st["ray_intersect_0"].intersect
    flow, po = st["flow_0"], st["point_offset_0"]
    net = model.color_net
    return (model.ray_param.name == "identity"
            and pred.net.activation == "identity"
            and isect.sort and isect.near == 0.0
            and isect.far == float("inf")
            and isect.mask_stop_iters == float("inf")
            and not np.any(isect.origin != 0.0)
            and flow.use_spatial_flow
            and "spatial_flow" in pred.output_names
            and "point_offset" in pred.output_names
            and (not po.use_sigma or po.in_density_field
                 in pred.output_names)
            and net.fused_eligible and net.fused_render)


class FusedCFEval:
    """Fused-path evaluator bound to one LightfieldModel."""

    def __init__(self, model):
        self.model = model
        st = _stages(model)
        self.pred = st["ray_prediction_0"]
        self.isect = st["ray_intersect_0"].intersect
        self.flow = st["flow_0"]
        self.po = st["point_offset_0"]
        self.net = model.color_net
        if len(self.net.active_density) != 1:
            raise NotImplementedError(
                "multi-axis fused render is not ported (ROADMAP.md: K5/K6 "
                "and the other net families)")
        # coherent patch-gather: [px, py] and the block size R (8 when
        # the config says 8, else 4, as the JAX package takes it)
        pc = self.net.cfg.get("coherent_gather")
        self.patch_cfg = (int(pc[0]), int(pc[1])) if pc else None
        self.patch_block = 8 if pc and len(pc) > 2 and int(pc[2]) == 8 \
            else 4
        self.S = self.pred.z_channels
        self.P = self.pred.preds_per_z
        offs, off = {}, 0
        for name, width in zip(self.pred.output_names,
                               self.pred.output_shapes):
            offs[name] = off
            off += width
        acts = dict(zip(self.pred.output_names, self.pred.activations))
        slots = {"z": "z_vals", "sigma": "sigma", "flow": "spatial_flow",
                 "poff": "point_offset", "cs": "color_scale",
                 "csh": "color_shift"}
        if self.po.use_sigma:
            slots["psig"] = self.po.in_density_field
        foff = {k: offs[n] for k, n in slots.items() if n in offs}
        fa = {k: acts[n] for k, n in slots.items() if n in offs}
        fa.update(isect=self.isect.activation,
                  flow_stage=self.flow.spatial_flow_activation,
                  po_stage=self.po.activation)
        for k, a in fa.items():
            if not isinstance(a, Activation):
                raise NotImplementedError(
                    f"activation {a!r} ({k}) has no pack-build kernel form "
                    "(ROADMAP.md: long tail)")
        self.spec = PackSpec(
            S=self.S, P=self.P, foff=foff, acts=fa,
            samples=np.broadcast_to(
                np.asarray(self.isect.samples, np.float32).reshape(-1),
                (self.S,)).copy(),
            z_scale=np.broadcast_to(
                np.asarray(self.isect.z_scale, np.float32).reshape(-1),
                (self.S,)).copy(),
            aabb=np.asarray(self.net.aabb, np.float32))

    def ok(self, ctx, render_kwargs):
        """Per-call gate (hyperreel_tpu FusedCFEval.ok)."""
        if ctx.training:
            return False
        if any(f != "distances" for f in render_kwargs.get("fields", [])):
            return False
        return not (render_kwargs.get("pred_weights_fields")
                    or render_kwargs.get("no_over_fields"))

    def prepare(self, params):
        """Per-checkpoint tables: K1's MLP tables (last layer field-major),
        the bf16 quad table of the space plane (and its bf16 patch table
        on the patch route), the f32 time plane and the host basis
        table."""
        cp = params["color"]
        # field-major column c*S + s <- the MLP's output column s*P + c
        perm = torch.as_tensor(np.arange(self.S * self.P).reshape(
            self.S, self.P).T.reshape(-1))
        mlp = mlp_tables(self.pred.net,
                         params["embedding"]["ray_prediction_0"]["net"], perm)
        space = torch.cat([cp["density"]["space_0"], cp["app"]["space_0"]],
                          -1)
        timep = torch.cat([cp["density"]["time_0"], cp["app"]["time_0"]],
                          -1)
        nd = self.net.density_n_comp[0]
        prep = {"mlp": mlp, "quad": quad_table(space),
                "ttab": time_table(timep),
                "wb": basis_table(cp["basis_mat"]["weight"], nd),
                "dims": (space.shape[0], space.shape[1], timep.shape[0],
                         timep.shape[1], space.shape[2], nd)}
        if self.patch_cfg is not None:
            prep["patch"] = build_patch_table_2d(space.to(torch.bfloat16),
                                                 *self.patch_cfg)
        return prep

    def ray_pack(self, rays):
        """[B, 8] rows o xyz, d xyz, dt = t - base_t, tn (keyframe time
        coordinate of base_t)."""
        t = rays[:, 7] if rays.shape[1] > 7 else rays.new_zeros(rays.shape[0])
        base_t = get_base_time(t, self.flow.num_keyframes,
                               self.flow.num_frames)
        tn = self.net.normalize_time_coord(base_t)
        return torch.cat([rays[:, :6], (t - base_t)[:, None], tn[:, None]],
                         1).contiguous()

    def apply(self, params, rays, ctx, render_kwargs=None):
        render_kwargs = render_kwargs or {}
        prep = render_kwargs.get("cf_prepared") or self.prepare(params)
        net_in = self.pred.net_input(rays, ctx).float().contiguous()
        rp = self.ray_pack(rays)
        pack = pack_build(net_in, prep["mlp"], rp, self.spec, ctx.it)

        H, W, TH, TW, C, nd = prep["dims"]
        ttab = prep["ttab"]
        outputs = {}
        if render_kwargs.get("uniform_time"):
            tn = rp[:, 7]
            outputs["uniform_time_viol"] = (tn - tn[0]).abs().max()
            ttab, TH = premix_time(ttab, tn[0]), 0
        spec = ShadeSpec(S=self.S, W=W, H=H, TW=TW, TH=TH, C=C, nd=nd,
                         deg=self.net.sh_deg,
                         distance_scale=self.net.distance_scale)
        B = rays.shape[0]
        if self.patch_cfg is not None and B % self.patch_block == 0:
            pspec = PatchSpec(
                R=self.patch_block, px=self.patch_cfg[0],
                py=self.patch_cfg[1], W=W, H=H, C=C, S=self.S,
                phase_major=bool(render_kwargs.get("rays_phase_major")))
            if os.environ.get("HYPERREEL_FUSED_PATCH", "1") not in (
                    "0", "false"):
                out, viol = shade_patch(prep["patch"], pack, rp, ttab,
                                        prep["wb"], spec, pspec)
            else:
                feats, viol = patch_blend(prep["patch"], pack, pspec)
                out = shade_preblended(feats, pack, rp, ttab, prep["wb"],
                                       spec)
            outputs["patch_coverage_viol"] = viol[0].float() / (
                B // pspec.R * self.S)
        else:
            out = shade(prep["quad"], pack, rp, ttab, prep["wb"], spec)
        rgb = out[:, :3]
        if not self.net.black_bg and self.net.white_bg:
            rgb = rgb + (1.0 - out[:, 3:4])
        outputs["rgb"] = torch.clamp(rgb, 0.0, 1.0)
        if "distances" in render_kwargs.get("fields", []):
            outputs["distances"] = out[:, 4:5]
        return outputs
