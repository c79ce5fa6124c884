"""Validation-time visualizers (port of hyperreel_tpu/train/visualizers.py;
reference nlf/visualizers/).

Each visualizer produces numpy images from a trained state through the
System's chunked Renderer (train/render.py); the System writes them as
PNGs next to the validation images.
"""

from dataclasses import dataclass

import numpy as np

from hyperreel_tpu_torch.ops.ray_math import (
    get_epi_rays, get_lightfield_rays)


def _normalize_img(x):
    lo, hi = np.percentile(x, 1), np.percentile(x, 99)
    return np.clip((x - lo) / max(hi - lo, 1e-8), 0, 1)


def get_warp_dimensions(embedding, k=3):
    """Pick the top-variance channels for visualization
    (reference utils/visualization.py:11-23)."""
    flat = embedding.reshape(-1, embedding.shape[-1])
    var = flat.var(0)
    return list(np.argsort(var)[::-1][:k])


def visualize_warp(embedding, dims):
    """Normalize selected channels into an RGB image
    (reference utils/visualization.py:25-52)."""
    sel = embedding[..., dims]
    return _normalize_img(sel)


@dataclass
class EmbeddingVisualizer:
    """Render per-stage embedding outputs and visualize the top-variance
    channels (reference nlf/visualizers/embedding.py:37-111)."""

    cfg: dict

    def render(self, system, state, rays, wh):
        fields = list(self.cfg.get("fields", ["points"]))
        out = system.renderer.render_rays(
            state.params, rays, it=state.it, fields=fields)
        W, H = wh
        images = {}
        for f in fields:
            emb = out[f].reshape(H, W, -1)
            dims = get_warp_dimensions(emb)
            images[f"embedding_{f}"] = visualize_warp(emb, dims)
        return images


@dataclass
class EPIVisualizer:
    """Epipolar-plane image slices (reference
    nlf/visualizers/epipolar.py:20-141): predicted EPI from
    get_epi_rays at fixed (v, t), plus the ground-truth EPI extracted
    from a lightfield grid dataset (center row, center scanline) when the
    dataset exposes its (rows, cols) structure."""

    cfg: dict

    def _gt_epi(self, system):
        ds = system.train_dataset
        rows = getattr(ds, "num_rows", None)
        cols = getattr(ds, "num_cols", None)
        if not rows or not cols:
            return None
        W, H = ds.img_wh
        try:
            all_rgb = ds.all_rgb.reshape(rows, cols, H, W, 3)
        except ValueError:
            return None
        # center camera row, center image scanline: [cols, W, 3]
        return all_rgb[rows // 2, :, H // 2, :, :]

    def render(self, system, state, rays, wh):
        W, H = wh
        v = float(self.cfg.get("v", 0.0))
        t = float(self.cfg.get("t", 0.0))
        st_scale = float(self.cfg.get("st_scale", 1.0))
        uv_scale = float(self.cfg.get("uv_scale", 1.0))
        near = float(self.cfg.get("near", -1.0))
        far = float(self.cfg.get("far", 0.0))
        if self.cfg.get("H"):
            H = int(self.cfg["H"])
        epi_rays = get_epi_rays(
            W, v, H, t, aspect=W / H, st_scale=st_scale,
            uv_scale=uv_scale, near=near, far=far).astype(np.float32)
        width = system.train_dataset.all_coords.shape[-1]
        if width > 6:
            pad = np.zeros((epi_rays.shape[0], width - 6), np.float32)
            epi_rays = np.concatenate([epi_rays, pad], -1)
        out = system.renderer.render_rays(state.params, epi_rays,
                                          it=state.it)
        images = {"epi_pred": np.clip(out["rgb"].reshape(H, W, 3), 0, 1)}
        gt = self._gt_epi(system)
        if gt is not None:
            images["epi_gt"] = np.asarray(gt, np.float32)
        return images


@dataclass
class FocusVisualizer:
    """Synthetic refocusing (reference nlf/visualizers/focus.py:13-160):
    renders the in-focus pinhole lightfield image (`rgb_ray`) and an
    aperture-averaged refocused image (`rgb_cone`) where each aperture
    offset (ds, dt) shifts (u, v) by du = (focal - far) * ds /
    (far - near) — the same cone geometry the reference feeds its
    PE-weight filter. (The reference's frequency-clamped PE path needs
    its affine models' embed_params; for the z-plane family the cone is
    realized by explicit aperture sampling.)"""

    cfg: dict

    def render(self, system, state, rays, wh):
        W, H = wh
        s = float(self.cfg.get("s", 0.0))
        t = float(self.cfg.get("t", 0.0))
        ds_ap = float(self.cfg.get("ds", 1.0))
        dt_ap = float(self.cfg.get("dt", 1.0))
        near = float(self.cfg.get("near", -1.0))
        far = float(self.cfg.get("far", 0.0))
        focal = float(self.cfg.get("focal", 0.0))
        st_scale = float(self.cfg.get("st_scale", 1.0))
        uv_scale = float(self.cfg.get("uv_scale", 1.0))
        n_ap = int(self.cfg.get("aperture_samples", 3))
        width = system.train_dataset.all_coords.shape[-1]

        def lf_rays(ss, tt, du=0.0, dv=0.0):
            r = get_lightfield_rays(
                W, H, ss, tt, aspect=W / H, st_scale=st_scale,
                uv_scale=uv_scale, near=near, far=far).astype(np.float32)
            if du or dv:
                # shift the far-plane intersection: d = (u - s, v - t, ..)
                r = r.copy()
                r[:, 3] += du
                r[:, 4] += dv
                nrm = np.linalg.norm(r[:, 3:6], axis=-1, keepdims=True)
                r[:, 3:6] /= np.maximum(nrm, 1e-12)
            if width > 6:
                r = np.concatenate(
                    [r, np.zeros((r.shape[0], width - 6), np.float32)], -1)
            return r

        def render(r):
            out = system.renderer.render_rays(state.params, r, it=state.it)
            return out["rgb"].reshape(H, W, 3)

        images = {"focus_rgb_ray": np.clip(render(lf_rays(s, t)), 0, 1)}

        offs = np.linspace(-1.0, 1.0, n_ap)
        acc = np.zeros((H, W, 3), np.float32)
        denom = max(far - near, 1e-8)
        for a in offs:
            for b in offs:
                dss, dtt = a * ds_ap, b * dt_ap
                du = (focal - far) * dss / denom
                dv = (focal - far) * dtt / denom
                acc += render(lf_rays(s + dss * st_scale,
                                      t + dtt * st_scale, du, dv))
        images["focus_rgb_cone"] = np.clip(acc / (n_ap * n_ap), 0, 1)
        return images


@dataclass
class ClosestViewVisualizer:
    """Nearest training view for a rendered pose
    (reference nlf/visualizers/closest_view.py:12-60)."""

    cfg: dict

    def render(self, system, state, rays, wh):
        ds = system.train_dataset
        W, H = wh
        n_per = W * H
        target_o = rays[:, :3].mean(0)
        best, best_d = 0, np.inf
        for i in range(ds.num_images):
            o = ds.all_coords[i * n_per:(i + 1) * n_per, :3]
            if len(o) < n_per:
                break
            d = np.linalg.norm(o.mean(0) - target_o)
            if d < best_d:
                best, best_d = i, d
        img = ds.all_rgb[best * n_per:(best + 1) * n_per]
        if img.shape[0] == n_per:
            return {"closest_view": img.reshape(H, W, 3)}
        return {}


@dataclass
class TensorVisualizer:
    """Dump raw feature planes as images
    (reference nlf/visualizers/tensor.py:12-70)."""

    cfg: dict

    def render(self, system, state, rays, wh):
        images = {}
        color = state.params["color"]
        for fam in ("density", "app"):
            for key, arr in color.get(fam, {}).items():
                arr = arr.detach().float().cpu().numpy()
                if arr.ndim == 3:
                    img = _normalize_img(arr[..., :3] if arr.shape[-1] >= 3
                                         else arr[..., :1].repeat(3, -1))
                    images[f"tensor_{fam}_{key}"] = img
        return images


visualizer_dict = {
    "embedding": EmbeddingVisualizer,
    "epipolar": EPIVisualizer,
    "focus": FocusVisualizer,
    "closest_view": ClosestViewVisualizer,
    "tensor": TensorVisualizer,
}


def build_visualizers(cfgs):
    out = []
    for name, cfg in (cfgs or {}).items():
        t = cfg.get("type", name)
        out.append((name, visualizer_dict[t](cfg=dict(cfg))))
    return out
