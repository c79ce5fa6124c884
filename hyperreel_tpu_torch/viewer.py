"""Interactive viewer (port of hyperreel_tpu/viewer.py; reference
utils/gui_utils.py NeRFGUI / OrbitCamera).

The contract is "render full frames at interactive rates given a pose and
time stream" (gui_utils.py:139-213):

  * OrbitCamera: the orbit / pan / zoom camera model;
  * InteractiveRenderer: frames at a ladder of resolutions with a frame
    budget. A frame's rays are made on the device from one [23] camera
    pack (K, pose, t, camera), every chunk goes through `model.apply`
    with the tables prepared once (on the card K1 + K2 or K5; K3 on a
    patch level; K1's compaction in fast mode), and the frame comes back
    as uint8 in one device-to-host copy;
  * serve / make_server: a minimal HTTP server, so that any browser can
    act as the display (a stand-in for the dearpygui window).
"""

import io
import time
from dataclasses import dataclass

import numpy as np
import torch

from hyperreel_tpu_torch.models.ctx import StepCtx
from hyperreel_tpu_torch.ops.ray_math import get_ray_directions_K, get_rays


class OrbitCamera:
    """Orbit camera (reference utils/gui_utils.py:17-72)."""

    def __init__(self, W, H, r=2.0, fovy=60.0):
        self.W, self.H = W, H
        self.radius = r
        self.fovy = fovy
        self.center = np.zeros(3, np.float32)
        self.rot = np.eye(3, dtype=np.float32)

    @property
    def pose(self):
        """Camera-to-world (reference utils/gui_utils.py:29-50: camera at
        -radius on z, rotated, then the y/z column flip into the -z-forward
        ray convention)."""
        res = np.eye(4, dtype=np.float32)
        res[2, 3] -= self.radius
        rot = np.eye(4, dtype=np.float32)
        rot[:3, :3] = self.rot
        res = rot @ res
        res[:3, 3] -= self.center
        res[..., 1] *= -1
        res[..., 2] *= -1
        return res[:3]

    @property
    def intrinsics(self):
        focal = self.H / (2.0 * np.tan(np.radians(self.fovy) / 2.0))
        return np.array([[focal, 0, self.W / 2],
                         [0, focal, self.H / 2],
                         [0, 0, 1]], np.float32)

    def orbit(self, dx, dy):
        def rotmat(axis, angle):
            c, s = np.cos(angle), np.sin(angle)
            x, y, z = axis
            K = np.array([[0, -z, y], [z, 0, -x], [-y, x, 0]], np.float32)
            return np.eye(3, dtype=np.float32) + s * K + (1 - c) * (K @ K)

        side = self.rot[:3, 0]
        up = np.array([0, 1, 0], np.float32)
        self.rot = rotmat(up, -0.005 * dx) @ rotmat(side, -0.005 * dy) @ self.rot

    def scale(self, delta):
        self.radius *= 1.1 ** (-delta)

    def pan(self, dx, dy, dz=0):
        self.center += 0.0005 * self.rot[:3, :3] @ np.array(
            [dx, dy, dz], np.float32)


def _on(tree, device):
    if isinstance(tree, dict):
        return {k: _on(v, device) for k, v in tree.items()}
    return tree.to(device) if torch.is_tensor(tree) else tree


@dataclass
class InteractiveRenderer:
    """Frame renderer with a resolution ladder and a frame budget
    (reference gui_utils.py:139-213: 200 ms target, downscale in [1/4, 1])
    on `device`, the card unless the caller names the CPU."""

    model: object
    params: object
    base_wh: tuple = (512, 512)
    frame_budget_s: float = 0.2
    ladder: tuple = (1.0, 0.7071, 0.5, 0.3536, 0.25)
    ray_width: int = 8
    it: int = 10 ** 6
    # optional coherent patch-gather clone of `model`
    # (with_coherent_gather): used per frame only when the coverage bound
    # for the current ladder level holds (high pixel density), so low
    # ladder levels keep the exact quad path
    patch_model: object = None
    # rays per chunk: frames above this render chunk by chunk
    chunk: int = 1 << 18
    device: str = "cuda"

    def __post_init__(self):
        self.device = torch.device(self.device)
        self._level = len(self.ladder) - 1  # start conservative
        self._frame_fns = {}
        self.params = _on(self.params, self.device)
        self._ctx = StepCtx(it=self.it, training=False)
        with torch.no_grad():
            self._prepared = self.model.prepare_eval(self.params)
        self._patch_gate_cache = {}
        self.last_used_patch = False
        self._patch_prepared = None
        if self.patch_model is not None and \
                getattr(self.patch_model, "_cf_eval", None) is not None:
            with torch.no_grad():
                self._patch_prepared = self.patch_model.prepare_eval(
                    self.params)
            cf = self.patch_model._cf_eval
            self._patch_res = max(
                max(plane.shape[0], plane.shape[1]) for _, plane, _ in
                cf.net.axis_grids(self.params["color"]))
            aabb = np.asarray(cf.net.aabb, np.float32)
            self._patch_extent = float((aabb[1] - aabb[0]).min())
            self._patch_diag = float(np.linalg.norm(aabb[1] - aabb[0]))
            self._patch_px = cf.patch_cfg[0]
            # coherent block size (rays per gathered patch row): the
            # phase-major reindex and the un-permute below follow it
            self._patch_R = cf.patch_block

    def _apply(self, model, prepared, rays, rk):
        """rgb [N, 3] of one chunk of rays through `model`."""
        rk = dict(rk)
        if prepared is not None:
            rk["cf_prepared"] = prepared
        return model.apply(self.params, rays, self._ctx,
                           render_kwargs=rk or None)["rgb"]

    def _fwd(self, rays, patch=False):
        """rgb [k, cs, 3] of rays [k, cs, C] (the probe's path), on the
        patch model with the rays phase-major per chunk where `patch`."""
        model, prep, rk = (self.patch_model, self._patch_prepared,
                           {"rays_phase_major": True}) if patch \
            else (self.model, self._prepared, {})
        with torch.no_grad():
            return torch.stack([self._apply(model, prep, r, rk)
                                for r in rays])

    def _patch_bound(self, focal_px, pose):
        """Analytic coverage bound: worst-case x-texel spread of an
        R-consecutive-pixel block is (R - 1) * t_max / focal_px
        world-per-px * texels-per-world; the patch is exact when that (+1
        bilinear corner, +1 jitter margin) fits the px budget.
        Conservative (t_max uses the full aabb diagonal), so a pass is
        trustworthy; a fail falls through to the empirical probe."""
        t_max = float(np.linalg.norm(np.asarray(pose)[:3, 3])) \
            + self._patch_diag
        spread = (self._patch_R - 1.0) * t_max / float(focal_px) \
            * (self._patch_res - 1) / self._patch_extent
        return spread <= self._patch_px - 3

    def _patch_probe_ok(self, rays, W, H, focal_px, pose):
        """Empirical gate when the analytic bound fails: render the
        worst-case block rows (top / middle / bottom of the frame, where
        ray angles are extreme) through both paths and compare. Patch
        exactness is per R-ray block (each block's footprint is
        independent), so block-row parity transfers to the frame. Cached
        per (W, H, radius bucket): the spread scales with camera distance,
        so big zoom changes re-probe."""
        r = float(np.linalg.norm(np.asarray(pose)[:3, 3]))
        key = (W, H, int(np.round(np.log1p(r) * 4)))
        hit = self._patch_gate_cache.get(key)
        if hit is not None:
            return hit
        rows = sorted({0, H // 2, H - 1})
        probe = np.concatenate([rays[y * W:(y + 1) * W] for y in rows], 0)
        pad = (-len(probe)) % 1024
        if pad:
            probe = np.concatenate(
                [probe, np.repeat(probe[-1:], pad, 0)], 0)
        n = len(probe)
        quad = self._fwd(torch.as_tensor(probe[None],
                                         device=self.device))[0]
        Rb = self._patch_R
        pm = probe.reshape(n // Rb, Rb, -1).transpose(
            1, 0, 2).reshape(n, -1)
        patch = self._fwd(torch.as_tensor(pm[None], device=self.device),
                          patch=True)[0]
        patch = patch.reshape(Rb, n // Rb, -1).transpose(0, 1).reshape(
            n, -1)
        ok = bool((patch - quad).abs().max() < 1e-3)
        self._patch_gate_cache[key] = ok
        return ok

    def _patch_ok(self, focal_px, pose, rays=None, W=None, H=None):
        if self._patch_prepared is None:
            return False
        if self._patch_bound(focal_px, pose):
            return True
        if rays is None:
            return False
        if callable(rays):
            r = float(np.linalg.norm(np.asarray(pose)[:3, 3]))
            key = (W, H, int(np.round(np.log1p(r) * 4)))
            if key in self._patch_gate_cache:   # no host rays on a hit
                return self._patch_gate_cache[key]
            rays = rays()
        return self._patch_probe_ok(rays, W, H, focal_px, pose)

    def _frame_fn(self, W, H, use_patch, ray_width):
        """The pose -> frame path of one (W, H, route): the rays are made
        on the device from a [3, 3] K and a [3, 4] pose (the per-frame
        upload is one [23] pack, not the rays), and the output is uint8
        on the device. The pixel grid is a constant made here, reindexed
        phase-major per chunk when the patch route is on. Returns (fn, k,
        cs, pad)."""
        key = (W, H, use_patch, ray_width)
        hit = self._frame_fns.get(key)
        if hit is not None:
            return hit
        n = W * H
        cs = self.chunk if n >= self.chunk else (n + 1023) // 1024 * 1024
        pad = (-n) % cs
        k = (n + pad) // cs
        # flat pixel coords, padded by replicating the last pixel
        jj, ii = np.meshgrid(np.arange(H, dtype=np.float32),
                             np.arange(W, dtype=np.float32),
                             indexing="ij")
        ii, jj = ii.reshape(-1), jj.reshape(-1)
        if pad:
            ii = np.concatenate([ii, np.repeat(ii[-1:], pad)])
            jj = np.concatenate([jj, np.repeat(jj[-1:], pad)])
        if use_patch:
            Rb = self._patch_R
            pm = (np.arange(k * cs).reshape(k, cs // Rb, Rb)
                  .transpose(0, 2, 1).reshape(-1))
            ii, jj = ii[pm], jj[pm]
        ii = torch.as_tensor(ii.reshape(k, cs), device=self.device)
        jj = torch.as_tensor(jj.reshape(k, cs), device=self.device)
        model, prepared = (self.patch_model, self._patch_prepared) \
            if use_patch else (self.model, self._prepared)
        base_rk = {"rays_phase_major": True} if use_patch else {}
        if ray_width == 8:
            # a viewer frame shares one t, so the uniform-time premix
            # always applies (the keyframe time mix hoists out of the
            # shade kernel); the witness is 0 here; models without the
            # channels-first route ignore the kwarg
            base_rk["uniform_time"] = True

        def fn(cam_pack):
            K = cam_pack[:9].reshape(3, 3)
            pose = cam_pack[9:21].reshape(3, 4)
            # get_ray_directions_K (centered_pixels) + get_rays
            x = (ii - K[0, 2] + 0.5) / K[0, 0]
            y = -(jj - K[1, 2] + 0.5) / K[1, 1]
            dirs = torch.stack([x, y, -torch.ones_like(x)], -1)
            d = dirs @ pose[:, :3].T
            d = d / torch.clamp_min(d.norm(dim=-1, keepdim=True), 1e-12)
            cols = [pose[:, 3].expand(d.shape), d]
            if ray_width >= 7:
                cols.append(cam_pack[22].expand(d.shape[:-1] + (1,)))
            if ray_width == 8:
                cols.append(cam_pack[21].expand(d.shape[:-1] + (1,)))
            rays = torch.cat(cols, -1)
            rgb = torch.stack([self._apply(model, prepared, r, base_rk)
                               for r in rays])
            return (torch.clamp(rgb, 0.0, 1.0) * 255.0).to(torch.uint8)

        self._frame_fns[key] = (fn, k, cs, pad)
        return self._frame_fns[key]

    def _wh_for(self, level):
        s = self.ladder[level]
        W = max(int(self.base_wh[0] * s) // 8 * 8, 32)
        H = max(int(self.base_wh[1] * s) // 8 * 8, 32)
        return W, H

    def precompile(self):
        """Render one frame at every ladder level up front (the JAX
        package compiles each level here; the port warms each level's
        pixel grid and the kernels' first launches)."""
        pose = np.eye(4, dtype=np.float32)[:3]
        pose[2, 3] = 2.0
        level = self._level
        for l in range(len(self.ladder)):
            self._level = l
            self.render_frame(pose)
        self._level = level

    def _host_rays(self, W, H, K, pose, t, cam_id):
        """Host-side ray build (the patch-gate probe path only; frames go
        through the device ray build, _frame_fn)."""
        dirs = get_ray_directions_K(H, W, K, centered_pixels=True)
        rays_o, rays_d = get_rays(dirs, np.asarray(pose, np.float32))
        rays = np.concatenate([rays_o, rays_d], -1).astype(np.float32)
        if self.ray_width >= 7:
            rays = np.concatenate(
                [rays, np.full((rays.shape[0], 1), cam_id, np.float32)],
                -1)
        if self.ray_width == 8:
            rays = np.concatenate(
                [rays, np.full((rays.shape[0], 1), t, np.float32)], -1)
        return rays

    def submit_frame(self, pose, K=None, t=0.0, cam_id=1.0):
        """Enqueue one frame's launches and return a handle for
        read_frame, without waiting for the device: submitting pose N+1
        before reading frame N overlaps the host's work with the
        device's."""
        W, H = self._wh_for(self._level)
        if K is None:
            focal = H / (2.0 * np.tan(np.radians(60.0) / 2.0))
            K = [[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]]
        else:
            K = np.asarray(K, np.float32).copy()
            K[0] *= W / self.base_wh[0]
            K[1] *= H / self.base_wh[1]
        K = np.asarray(K, np.float32)
        n = W * H

        use_patch = self._patch_ok(
            float(K[0, 0]), pose, W=W, H=H,
            rays=lambda: self._host_rays(W, H, K, pose, t, cam_id))
        self.last_used_patch = use_patch
        fn, k, cs, pad = self._frame_fn(W, H, use_patch, self.ray_width)

        t0 = time.perf_counter()
        cam_pack = np.concatenate([
            K.reshape(-1).astype(np.float32),
            np.asarray(pose, np.float32).reshape(-1),
            np.asarray([t, cam_id], np.float32)])
        with torch.no_grad():
            dev_out = fn(torch.as_tensor(cam_pack, device=self.device))
        return (dev_out, W, H, n, use_patch, k, cs, t0)

    def read_frame(self, handle):
        """A submit_frame handle -> (H x W x 3 uint8 frame, dt): the one
        device-to-host copy, the patch route's rows un-permuted. dt covers
        submit to readback of this frame."""
        dev_out, W, H, n, use_patch, k, cs, t0 = handle
        out_u8 = dev_out.cpu().numpy()
        if use_patch:
            Rb = self._patch_R
            out_u8 = out_u8.reshape(k, Rb, cs // Rb, 3).transpose(
                0, 2, 1, 3).reshape(-1, 3)
        else:
            out_u8 = out_u8.reshape(-1, 3)
        dt = time.perf_counter() - t0

        # ladder adaptation (discrete version of gui_utils.py:186-193)
        if dt > self.frame_budget_s and self._level < len(self.ladder) - 1:
            self._level += 1
        elif dt < self.frame_budget_s * 0.4 and self._level > 0:
            self._level -= 1

        return out_u8[:n].reshape(H, W, 3), dt

    def render_frame(self, pose, K=None, t=0.0, cam_id=1.0):
        """Render one frame synchronously (submit + read); adapts the
        ladder level to the measured frame time."""
        return self.read_frame(self.submit_frame(pose, K, t, cam_id))


def fast_mode_probe(model, params, fast_model, fast_params, coords,
                    it, n_rays=8192, gate_db=35.0, device="cuda"):
    """Scene-dependent quality gate for the viewer's auto fast mode.

    Renders a dataset-wide ray slice with the full model and the
    compact/stride fast model and compares them: `gate_db` between the
    two renders bounds the fast mode's quality loss. Returns (ok,
    psnr_db)."""
    from hyperreel_tpu_torch.train.metrics import psnr
    from hyperreel_tpu_torch.train.render import Renderer

    idx = np.linspace(0, len(coords) - 1, n_rays).astype(int)
    probe_rays = np.asarray(coords[idx])
    full_rgb = Renderer(model, ray_chunk=n_rays, device=device).render_rays(
        params, probe_rays, it=it)["rgb"]
    fast_rgb = Renderer(fast_model, ray_chunk=n_rays,
                        device=device).render_rays(
        fast_params, probe_rays, it=it)["rgb"]
    d = float(psnr(torch.as_tensor(fast_rgb), torch.as_tensor(full_rgb)))
    return d >= gate_db, d


_PAGE = (b"<html><body style='margin:0'>"
         b"<img id=v style='width:100vw;height:100vh;"
         b"object-fit:contain'>"
         b"<script>let yaw=0,pitch=0,drag=0;"
         b"document.onmousedown=()=>drag=1;"
         b"document.onmouseup=()=>drag=0;"
         b"document.onmousemove=e=>{if(drag){yaw+=e.movementX"
         b"*0.003;pitch+=e.movementY*0.003;}};"
         b"async function loop(){const r=await fetch("
         b"`/frame?yaw=${yaw}&pitch=${pitch}`);"
         b"const b=await r.blob();"
         b"v.src=URL.createObjectURL(b);"
         b"requestAnimationFrame(loop);}loop();"
         b"</script></body></html>")


def make_server(model, params, host="0.0.0.0", port=8090, wh=(512, 512),
                ray_width=8, time_loop_s=2.0, patch_model=None,
                device="cuda"):
    """The viewer's HTTP server, its ladder warmed up, not yet serving:
    GET / returns an HTML page with drag-to-orbit; GET
    /frame?yaw=..&pitch=..&r=..&t=.. returns a PNG frame with its
    X-Frame-Time header (the render contract of NeRFGUI.test_step,
    gui_utils.py:139-213). `serve` runs it; a caller that runs it in a
    thread stops it with shutdown() and server_close()."""
    from http.server import BaseHTTPRequestHandler, HTTPServer
    from urllib.parse import urlparse, parse_qs
    from PIL import Image

    cam = OrbitCamera(wh[0], wh[1])
    renderer = InteractiveRenderer(model=model, params=params, base_wh=wh,
                                   ray_width=ray_width,
                                   patch_model=patch_model, device=device)
    print("warming up the resolution ladder...")
    renderer.precompile()
    t_start = time.time()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            parsed = urlparse(self.path)
            if parsed.path == "/frame":
                q = parse_qs(parsed.query)
                yaw = float(q.get("yaw", [0])[0])
                pitch = float(q.get("pitch", [0])[0])
                cam.rot = np.eye(3, dtype=np.float32)
                cam.orbit(yaw * 200, pitch * 200)
                cam.radius = float(q.get("r", [2.0])[0])
                t = float(q.get(
                    "t", [((time.time() - t_start) % time_loop_s)
                          / time_loop_s])[0])
                img, dt = renderer.render_frame(cam.pose, t=t)
                buf = io.BytesIO()
                Image.fromarray(img).save(buf, "PNG")
                data = buf.getvalue()
                self.send_response(200)
                self.send_header("Content-Type", "image/png")
                self.send_header("X-Frame-Time", f"{dt:.3f}")
                self.end_headers()
                self.wfile.write(data)
            else:
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.end_headers()
                self.wfile.write(_PAGE)

    server = HTTPServer((host, port), Handler)
    server.renderer = renderer
    return server


def serve(model, params, host="0.0.0.0", port=8090, wh=(512, 512),
          ray_width=8, time_loop_s=2.0, patch_model=None, device="cuda"):
    """Serve the viewer until interrupted (make_server's server)."""
    server = make_server(model, params, host, port, wh, ray_width,
                         time_loop_s, patch_model, device)
    print(f"viewer at http://{host}:{server.server_address[1]}/")
    try:
        server.serve_forever()
    finally:
        server.server_close()
