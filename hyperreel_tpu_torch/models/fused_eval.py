"""Fused eval render on CUDA kernels (port of hyperreel_tpu/models/
fused_eval.py FusedCFEval): the flagship's dynamic single-axis routes and
the multi-axis routes of the static llff_z_plane family and of the
dynamic neural_3d_z_plane family.

  rays -> encodings -> K1 pack_build (the prediction MLP, its last
  layer's columns permuted field-major on the host; field activations, z,
  the scene contraction, distances, sort, advection, offsets,
  normalisation: the per-sample pack) -> the grid features, density, SH
  or RGB colour, composite -> rgb, on one of three routes.

The flagship (dynamic, one space plane x one time plane):
  quad   K2 shade reads each sample's quad-table row;
  patch  (coherent_gather [px, py, R] in the net config) K3 shade_patch
         blends each (block, slot)'s patch row inside the shade kernel;
         with HYPERREEL_FUSED_PATCH=0 (or false), K4 patch_blend writes
         bf16 features and K2 shade_preblended reads them.
The multi-axis VM nets (three axes: a plane times a line for the static
net, the llff_z_plane and shiny_z_plane families, a space plane times a
keyframe time plane for the dynamic one):
  quad   K5 shade_multi reads each sample's three quad-table rows;
  patch  K4 patch_blend, one launch for the three planes (bf16
         features and the witness), then K5 shade_multi_preblended (the
         JAX package's default multi-axis patch route, one blend per
         plane there); with HYPERREEL_FUSED_PATCH_MULTI=1, K6
         shade_multi_patch blends the three planes inside the shade
         kernel.

The patch route is the JAX package's coherent patch-gather: coherent
block j is the caller's rays R*j .. R*j+R-1 (R = 8 when the config asks
for 8, else 4); `render_kwargs["rays_phase_major"]` says the caller
delivers them phase-major (ray R*j+p at position p*(B/R)+j, as bench.py
does) and takes the outputs in that order. The kernels find a block's
rays by that stride, so no ray is permuted. The port takes the patch
route whenever B % R == 0 (the JAX package also needs its tile to divide)
and every plane's channel count is a multiple of 8 (the JAX package's
structural gate, fused_eval.py:688-695; other counts take the quad
route). It is exact where every block's footprint fits the patch and
zero-degrades where it does not; the call returns the witness
outputs["patch_coverage_viol"] = the fraction of (block, slot) pairs
whose valid samples' footprint exits the patch on some plane axis
(ops/kernels/patch_blend.py), for the caller to gate on (bench.py holds
it to 1e-4).

`uniform_time` (every ray of the call shares one t, as in a frame render)
premixes the keyframe rows of each time plane for that t on the device
(a line, so K5/K6 run with TH = 0; otherwise they mix the two keyframe
rows around each ray's own t), and the call returns the witness
outputs["uniform_time_viol"] = max |tn - tn[0]|; static nets have no time
and ignore it.

The render-time sample counts (configs/presets.py with_compact_samples,
with_inference_samples) ride K1: a select_points stage of mode "first"
right after the intersect (with invalid_sort_far: invalid samples sort
last behind the far sentinel) keeps the first k sorted samples, one of
mode "stride" after the point offset every (S/k)-th, and the shade stage
(premix, patch tiling, witness) then runs at S = k (hyperreel_tpu
fused_eval.py S_shade, :597). The JAX package sends stride 2 (k = S/2)
to its XLA tail for the TPU's speed; the port has no such tail and runs
K1's stride branch at every stride >= 2.

The kernels take S a power of two up to 64 (K2/K3 up to 32; K3 and K4
from 4) and the [8, 4, 4] multi-axis layout; on a CUDA tensor anything
else raises NotImplementedError at the launch, never falling back to the
plain versions or the general path. Chains that are not the two fused
patterns have no fused path and take the general stage chain, as in the
JAX package.
"""

import dataclasses
import os

import numpy as np
import torch

from hyperreel_tpu_torch.models.activations import kernel_act
from hyperreel_tpu_torch.models.embeddings import get_base_time
from hyperreel_tpu_torch.models.intersect import FAR_SENTINEL
from hyperreel_tpu_torch.models.tensorf import (
    TensorVMKeyframeTime, TensorVMNoSample)
from hyperreel_tpu_torch.ops.kernels.pack_build import (
    PackSpec, mlp_tables, pack_build)
from hyperreel_tpu_torch.ops.kernels.patch_blend import PatchSpec, patch_blend
from hyperreel_tpu_torch.ops.kernels.shade import (
    ShadeSpec, basis_table, premix_time, quad_table, shade, shade_preblended,
    time_table)
from hyperreel_tpu_torch.ops.kernels.shade_multi import (
    MultiSpec, axis_tables, multi_basis_table, shade_multi,
    shade_multi_preblended)
from hyperreel_tpu_torch.ops.kernels.shade_multi_patch import (
    shade_multi_patch)
from hyperreel_tpu_torch.ops.kernels.shade_patch import shade_patch
from hyperreel_tpu_torch.ops.patch_gather import build_patch_table_2d

DYN_CHAIN = ["ray_prediction_0", "ray_intersect_0", "flow_0",
             "point_offset_0", "add_point_outputs_0", "extract_fields"]
STATIC_CHAIN = [n for n in DYN_CHAIN if n != "flow_0"]


def _chains():
    """Each chain with no sample-count stage, with the compaction stage
    right after the intersect, or with the stride stage right after the
    point offset (the positional stride commutes past the elementwise
    per-sample stages to just after the sort); never both."""
    out = []
    for want in (DYN_CHAIN, STATIC_CHAIN):
        i_po = want.index("point_offset_0") + 1
        out += [want, want[:2] + ["select_points_compact"] + want[2:],
                want[:i_po] + ["select_points_inference"] + want[i_po:]]
    return out


def _stages(model):
    return dict(model.embedding.stages)


def _is_pow2(k):
    return bool(k) and k & (k - 1) == 0


def _samples_ok(st, S):
    """The sample-count stages as the fused path takes them (hyperreel_tpu
    fused_eval.py:83-95, :120-133): compaction of mode "first", k a power
    of two, after an intersect with invalid_sort_far; a stride of mode
    "stride", k a power of two dividing S, k < S; and no far sentinel
    under a scene contraction, which would pull the sentinel's point onto
    the contraction's radius-2 sphere, inside the aabb. Compaction to k >
    S keeps every sample and takes the general path here (the JAX fused
    path would build a pack of k > S samples)."""
    isect = st["ray_intersect_0"].intersect
    sel = st.get("select_points_compact")
    if sel is not None and not (
            sel.mode == "first" and _is_pow2(sel.inference_samples)
            and isect.invalid_sort_far
            and sel.inference_samples <= S):
        return False
    sel = st.get("select_points_inference")
    if sel is not None and not (
            sel.mode == "stride" and _is_pow2(sel.inference_samples)
            and sel.inference_samples < S and S % sel.inference_samples == 0):
        return False
    return not (isect.invalid_sort_far and isect.contract.name != "identity")


def _acts_ok(pred, isect, po, flow):
    """K1 takes every activation of the chain: the prediction net's layer
    activation and its outputs', the intersect's, the point offset's and
    the flow's (hyperreel_tpu fused_eval.py:233-246, 821-826: the JAX
    gate, act_cfg_supported). The one difference: a vector activation
    (softmax, the norms, ...; or an ease_value / interp_value over one)
    takes the general chain here, where the JAX fused paths apply it to a
    channel's [S, B] rows and so mix rays (ROADMAP.md section 3); so does
    one whose schedules nest more than MAX_LEAVES functions."""
    acts = [pred.net.layer_act, isect.activation, po.activation,
            *pred.activations]
    if flow is not None:
        acts.append(flow.spatial_flow_activation)
    return all(kernel_act(a) for a in acts)


def cf_eligible(model):
    """Structural eligibility: the dynamic chain (the technicolor_z_plane
    and neural_3d_z_plane families) or the static chain (the llff_z_plane
    and shiny_z_plane families; not stanford_llff_z_plane, whose intersect
    masks near/far), each with or without one sample-count stage, and no
    stage gated by wait/stop iterations; no model-level ray param, no ray
    outputs, no PE inside the prediction net, no angular flow
    (hyperreel_tpu/models/fused_eval.py cf_eligible:45-159); activations
    that K1 takes (`_acts_ok`)."""
    names = [n for n, _ in model.embedding.stages]
    if names not in _chains() or any(model.embedding.windows.values()):
        return False
    st = _stages(model)
    pred, isect = st["ray_prediction_0"], st["ray_intersect_0"].intersect
    po = st["point_offset_0"]
    net = model.color_net
    if not _samples_ok(st, pred.z_channels):
        return False
    dynamic = "flow_0" in names
    flow = st.get("flow_0")
    if dynamic:
        chain_ok = (isinstance(net, TensorVMKeyframeTime)
                    and flow.use_spatial_flow and not flow.use_angular_flow
                    and "spatial_flow" in pred.output_names)
    else:
        chain_ok = isinstance(net, TensorVMNoSample)
    S = pred.z_channels
    return (chain_ok
            and isect.cfg.get("type") == "z_plane"
            and model.ray_param.name == "identity"
            and pred.total_ray_out == 0
            and not pred.net.pe_cfg
            and pred.net.activation == "identity"
            and _acts_ok(pred, isect, po, flow)
            and isect.sort and isect.near == 0.0
            and isect.far == float("inf")
            and isect.mask_stop_iters == float("inf")
            and not np.any(isect.origin != 0.0)
            and "point_offset" in pred.output_names
            and (not po.use_sigma or po.in_density_field
                 in pred.output_names)
            and S & (S - 1) == 0
            and net.fused_eligible and net.fused_render)


class FusedCFEval:
    """Fused-path evaluator bound to one LightfieldModel."""

    def __init__(self, model):
        self.model = model
        st = _stages(model)
        self.pred = st["ray_prediction_0"]
        self.isect = st["ray_intersect_0"].intersect
        self.flow = st.get("flow_0")          # None for static chains
        self.po = st["point_offset_0"]
        self.net = model.color_net
        self.S = self.pred.z_channels
        self.P = self.pred.preds_per_z
        # the samples K1 keeps and the shade stage runs at: the first k
        # (compaction) or every (S/k)-th (stride), else all S
        sel = st.get("select_points_compact")
        compact_k = sel.inference_samples if sel is not None else None
        sel = st.get("select_points_inference")
        stride_k = sel.inference_samples if sel is not None else None
        self.k = stride_k or compact_k or self.S
        # one space plane x one time plane (the flagship's K2/K3 routes);
        # otherwise the multi-axis routes (K5/K6), with time planes when
        # the chain is dynamic (hyperreel_tpu _plan_meta `dyn1`)
        self.dyn1 = self.flow is not None \
            and len(self.net.active_density) == 1
        # coherent patch-gather: [px, py] and the block size R (8 when
        # the config says 8, else 4, as the JAX package takes it); planes
        # whose channel count is not a multiple of 8 take the quad route
        # (the JAX package's structural gate, fused_eval.py:688-695)
        pc = self.net.cfg.get("coherent_gather")
        chans = [self.net.density_n_comp[i] + self.net.app_n_comp[i]
                 for i in self.net.active_density]
        self.patch_cfg = (int(pc[0]), int(pc[1])) \
            if pc and not any(c % 8 for c in chans) else None
        self.patch_block = 8 if pc and len(pc) > 2 and int(pc[2]) == 8 \
            else 4
        offs, off = {}, 0
        for name, width in zip(self.pred.output_names,
                               self.pred.output_shapes):
            offs[name] = off
            off += width
        acts = dict(zip(self.pred.output_names, self.pred.activations))
        slots = {"z": "z_vals", "sigma": "sigma", "poff": "point_offset",
                 "cs": "color_scale", "csh": "color_shift"}
        if self.flow is not None:
            slots["flow"] = "spatial_flow"
        if self.po.use_sigma:
            slots["psig"] = self.po.in_density_field
        foff = {k: offs[n] for k, n in slots.items() if n in offs}
        fa = {k: acts[n] for k, n in slots.items() if n in offs}
        fa.update(isect=self.isect.activation, po_stage=self.po.activation)
        if self.flow is not None:
            fa["flow_stage"] = self.flow.spatial_flow_activation
        # the aabb is read from the net at each call (`spec`): the
        # alpha-mask event's shrink replaces it (hyperreel_tpu
        # fused_eval.py reads net.aabb per call)
        self._spec = PackSpec(
            S=self.S, P=self.P, foff=foff, acts=fa,
            samples=np.broadcast_to(
                np.asarray(self.isect.samples, np.float32).reshape(-1),
                (self.S,)).copy(),
            z_scale=np.broadcast_to(
                np.asarray(self.isect.z_scale, np.float32).reshape(-1),
                (self.S,)).copy(),
            aabb=np.asarray(self.net.aabb, np.float32),
            contract=self.isect.contract, k=self.k,
            stride=self.S // stride_k if stride_k else None,
            far_sentinel=FAR_SENTINEL if self.isect.invalid_sort_far
            else None)

    @property
    def spec(self):
        """K1's PackSpec with the net's aabb of now."""
        return dataclasses.replace(
            self._spec, aabb=np.asarray(self.net.aabb, np.float32))

    def ok(self, ctx, render_kwargs):
        """Per-call gate (hyperreel_tpu FusedCFEval.ok)."""
        if ctx.training:
            return False
        if any(f != "distances" for f in render_kwargs.get("fields", [])):
            return False
        return not (render_kwargs.get("pred_weights_fields")
                    or render_kwargs.get("no_over_fields"))

    def prepare(self, params):
        """Per-checkpoint tables: K1's MLP tables (last layer field-major)
        and the grid tables of the net's shade kernels (with the patch
        tables on the patch route)."""
        # field-major column c*S + s <- the MLP's output column s*P + c
        perm = torch.as_tensor(np.arange(self.S * self.P).reshape(
            self.S, self.P).T.reshape(-1))
        prep = {"mlp": mlp_tables(
            self.pred.net, params["embedding"]["ray_prediction_0"]["net"],
            perm, self.spec)}
        cp = params["color"]
        if self.dyn1:
            prep.update(self._prepare_dyn1(cp))
        else:
            prep.update(self._prepare_multi(cp))
        return prep

    def _prepare_dyn1(self, cp):
        """The bf16 quad table of the space plane (and its bf16 patch
        table on the patch route), the f32 time plane and the host basis
        table."""
        (_, space, timep), = self.net.axis_grids(cp)
        nd = self.net.density_n_comp[0]
        prep = {"quad": quad_table(space), "ttab": time_table(timep),
                "wb": basis_table(cp["basis_mat"]["weight"], nd),
                "dims": (space.shape[0], space.shape[1], timep.shape[0],
                         timep.shape[1], space.shape[2], nd)}
        if self.patch_cfg is not None:
            prep["patch"] = build_patch_table_2d(space.to(torch.bfloat16),
                                                 *self.patch_cfg)
        return prep

    def _prepare_multi(self, cp):
        """Per axis the bf16 quad table of its plane (and its bf16 patch
        table on the patch route) and its f32 second factor: the line of
        a static net, the time plane [TH, TW, C] of a dynamic one; the host
        basis table over the concatenated appearance channels."""
        axes, quads, lines, ptabs = axis_tables(
            self.net.axis_grids(cp), self.net.density_n_comp,
            self.flow is not None, self.patch_cfg)
        prep = {"quads": quads, "lines": lines, "axes": axes,
                "wb": multi_basis_table(cp["basis_mat"]["weight"])}
        if ptabs:
            prep["ptabs"] = ptabs
        return prep

    def ray_pack(self, rays):
        """[B, 8] rows o xyz, d xyz, dt = t - base_t, tn (keyframe time
        coordinate of base_t); dt = tn = 0 for static chains."""
        B = rays.shape[0]
        if self.flow is None:
            return torch.cat([rays[:, :6], rays.new_zeros(B, 2)],
                             1).contiguous()
        t = rays[:, 7] if rays.shape[1] > 7 else rays.new_zeros(B)
        base_t = get_base_time(t, self.flow.num_keyframes,
                               self.flow.num_frames)
        tn = self.net.normalize_time_coord(base_t)
        return torch.cat([rays[:, :6], (t - base_t)[:, None], tn[:, None]],
                         1).contiguous()

    def patch_specs(self, axes, phase_major):
        """One PatchSpec per plane: (W, H, C, coordinate rows m0, m1)."""
        return [PatchSpec(R=self.patch_block, px=self.patch_cfg[0],
                          py=self.patch_cfg[1], W=W, H=H, C=C, S=self.k,
                          phase_major=phase_major, m0=m0, m1=m1)
                for W, H, C, m0, m1 in axes]

    def apply(self, params, rays, ctx, render_kwargs=None):
        render_kwargs = render_kwargs or {}
        prep = render_kwargs.get("cf_prepared") or self.prepare(params)
        net_in = self.pred.net_input(rays, ctx).float().contiguous()
        rp = self.ray_pack(rays)
        pack = pack_build(net_in, prep["mlp"], rp, self.spec, ctx.it)
        B = rays.shape[0]
        patch = self.patch_cfg is not None and B % self.patch_block == 0
        pm = bool(render_kwargs.get("rays_phase_major"))
        outputs = {}
        shade_fn = self._shade_dyn1 if self.dyn1 else self._shade_multi
        out, viol = shade_fn(prep, pack, rp, render_kwargs, outputs, patch,
                             pm)
        if patch:
            outputs["patch_coverage_viol"] = viol.float() / (
                B // self.patch_block * self.k)
        rgb = out[:, :3]
        if not self.net.black_bg and self.net.white_bg:
            rgb = rgb + (1.0 - out[:, 3:4])
        outputs["rgb"] = torch.clamp(rgb, 0.0, 1.0)
        if "distances" in render_kwargs.get("fields", []):
            outputs["distances"] = out[:, 4:5]
        return outputs

    def _uniform_tn(self, rp, render_kwargs, outputs):
        """With `uniform_time` on a dynamic chain: the witness into
        `outputs` and the 0-d time coordinate to premix for; else None."""
        if self.flow is None or not render_kwargs.get("uniform_time"):
            return None
        tn = rp[:, 7]
        outputs["uniform_time_viol"] = (tn - tn[0]).abs().max()
        return tn[0]

    def _shade_dyn1(self, prep, pack, rp, render_kwargs, outputs, patch, pm):
        """K2, K3 or K4 + K2-preblended: (out [B, 5], the coverage count
        or None)."""
        H, W, TH, TW, C, nd = prep["dims"]
        ttab = prep["ttab"]
        tn0 = self._uniform_tn(rp, render_kwargs, outputs)
        if tn0 is not None:
            ttab, TH = premix_time(ttab, tn0), 0
        spec = ShadeSpec(S=self.k, W=W, H=H, TW=TW, TH=TH, C=C, nd=nd,
                         deg=self.net.sh_deg,
                         distance_scale=self.net.distance_scale,
                         shading=self.net.shading)
        if not patch:
            return shade(prep["quad"], pack, rp, ttab, prep["wb"],
                         spec), None
        pspec, = self.patch_specs([(W, H, C, 0, 1)], pm)
        if os.environ.get("HYPERREEL_FUSED_PATCH", "1") not in ("0",
                                                                "false"):
            out, viol = shade_patch(prep["patch"], pack, rp, ttab,
                                    prep["wb"], spec, pspec)
        else:
            (feats,), viol = patch_blend([prep["patch"]], pack, [pspec])
            out = shade_preblended(feats, pack, rp, ttab, prep["wb"], spec)
        return out, viol[0]

    def _shade_multi(self, prep, pack, rp, render_kwargs, outputs, patch,
                     pm):
        """K5, K6 or K4 per plane + K5-preblended: (out [B, 5], the
        coverage count or None)."""
        axes, lines, wb = prep["axes"], prep["lines"], prep["wb"]
        tn0 = self._uniform_tn(rp, render_kwargs, outputs)
        if tn0 is not None:
            lines = [premix_time(t, tn0) for t in lines]
            axes = tuple(dataclasses.replace(a, TH=0) for a in axes)
        spec = MultiSpec(S=self.k, axes=axes, deg=self.net.sh_deg,
                         distance_scale=self.net.distance_scale,
                         shading=self.net.shading)
        if not patch:
            return shade_multi(prep["quads"], lines, pack, rp, wb,
                               spec), None
        pspecs = self.patch_specs(
            [(a.W, a.H, a.C, a.m0, a.m1) for a in axes], pm)
        if os.environ.get("HYPERREEL_FUSED_PATCH_MULTI") == "1":
            out, viol = shade_multi_patch(prep["ptabs"], lines, pack, rp,
                                          wb, spec, pspecs)
            return out, viol[0]
        feats, viol = patch_blend(prep["ptabs"], pack, pspecs)
        out = shade_multi_preblended(feats, lines, pack, rp, wb, spec)
        return out, viol[0]
