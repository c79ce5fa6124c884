"""The viewer of the port (hyperreel_tpu_torch/viewer.py) against the JAX
package's: the orbit camera, a 64 x 64 frame of tiny_dynamic through the
device ray build and the fused route (within 1 uint8 level), the
resolution ladder's moves on set frame times, the patch route's coverage
bound, and the HTTP server on localhost in a thread."""

import threading
import urllib.request

import numpy as np
import pytest

import torch

from hyperreel_tpu import viewer as jax_viewer
from hyperreel_tpu.configs.presets import with_coherent_gather
from hyperreel_tpu.viewer import InteractiveRenderer as JaxRenderer
from hyperreel_tpu.viewer import OrbitCamera as JaxCamera
from hyperreel_tpu_torch import viewer as port_viewer
from hyperreel_tpu_torch.viewer import (
    InteractiveRenderer, OrbitCamera, make_server)

from torch_parity import INFO, build_jax, build_torch, flagship_cfg, \
    port_weights

IT = 20000


def _pose():
    pose = np.eye(4, dtype=np.float32)[:3]
    pose[2, 3] = 2.0
    return pose


def test_orbit_camera_as_in_jax():
    cams = [JaxCamera(64, 48, r=2.0), OrbitCamera(64, 48, r=2.0)]
    for cam in cams:
        cam.orbit(30, 10)
        cam.scale(1)
        cam.pan(5, -3, 2)
        cam.orbit(-12, 4)
    want, got = cams
    assert np.abs(got.pose - want.pose).max() <= 1e-6
    assert np.abs(got.intrinsics - want.intrinsics).max() <= 1e-6
    R = got.pose[:3, :3]
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-5)
    assert got.radius < 2.0


@pytest.fixture(scope="module")
def flagship():
    """tiny_dynamic on the fused route (bf16 tables, f32 MLP), its patch
    clone, and one set of weights: (JAX model, JAX patch model, JAX params,
    port model, port patch model, port params)."""
    cfg = flagship_cfg(tiny=True)
    pcfg = with_coherent_gather(cfg)
    jm, jpm = build_jax(cfg, dataset_info=INFO), build_jax(
        pcfg, dataset_info=INFO)
    tm, tpm = build_torch(cfg, dataset_info=INFO), build_torch(
        pcfg, dataset_info=INFO)
    jp, tp = port_weights(tm, density=0.5)
    return jm, jpm, jp, tm, tpm, tp


def test_frame_within_one_level_of_jax(flagship):
    jm, _, jp, tm, _, tp = flagship
    # a budget no frame exceeds: the ladder stays at level 0 (64 x 64)
    kw = dict(base_wh=(64, 64), ray_width=8, it=IT, frame_budget_s=1e9)
    want = JaxRenderer(jm, jp, **kw)
    got = InteractiveRenderer(tm, tp, device="cpu", **kw)
    assert got._prepared is not None
    for r in (want, got):
        r._level = 0
    a, _ = want.render_frame(_pose(), t=0.3)
    b, dt = got.render_frame(_pose(), t=0.3)
    assert b.dtype == np.uint8 and b.shape == a.shape == (64, 64, 3)
    assert np.isfinite(dt)
    diff = np.abs(a.astype(int) - b.astype(int))
    assert diff.max() <= 1, diff.max()
    assert np.ptp(b) > 10                     # not a blank frame

    # the device ray build against the host's, through the same model
    W, H = got._wh_for(got._level)
    focal = H / (2.0 * np.tan(np.radians(60.0) / 2.0))
    K = np.asarray([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]],
                   np.float32)
    img, _ = got.render_frame(_pose(), K=K, t=0.3)
    rays = got._host_rays(W, H, K, _pose(), 0.3, 1.0)
    rgb = got._fwd(torch.from_numpy(rays)[None]).numpy()[0]
    host = (np.clip(rgb, 0, 1) * 255).astype(np.uint8).reshape(H, W, 3)
    assert np.abs(img.astype(int) - host.astype(int)).max() <= 1


class _Clock:
    """A perf_counter that moves only when the test moves it."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        return self.now


def test_ladder_moves_as_in_jax(flagship, monkeypatch):
    """Frame times above the budget climb the ladder (smaller frames),
    below 0.4 budget descend it; the sizes at each level as in JAX. Both
    viewers read a clock the test sets, so that each frame takes the time
    given whatever the host's load."""
    jm, _, jp, tm, _, tp = flagship
    kw = dict(base_wh=(64, 64), ray_width=8, it=IT,
              ladder=(1.0, 0.5), frame_budget_s=0.2)
    rs = [JaxRenderer(jm, jp, **kw),
          InteractiveRenderer(tm, tp, device="cpu", **kw)]
    clock = _Clock()
    for mod in (jax_viewer, port_viewer):
        monkeypatch.setattr(mod, "time", clock)
    levels = [[], []]
    for dt in (0.1, 0.01, 0.01, 0.3, 0.3, 0.1):
        for r, lv in zip(rs, levels):
            h = r.submit_frame(_pose(), t=0.5)
            clock.now += dt
            img, took = r.read_frame(h)
            assert took == pytest.approx(dt)
            lv.append((r._level, img.shape))
    assert levels[1] == levels[0]
    assert [lv for lv, _ in levels[1]] == [1, 0, 0, 1, 1, 1]
    assert {s for _, s in levels[1]} == {(32, 32, 3), (64, 64, 3)}
    for level in (0, 1):
        assert rs[1]._wh_for(level) == rs[0]._wh_for(level)


def test_patch_bound_as_in_jax(flagship):
    jm, jpm, jp, tm, tpm, tp = flagship
    want = JaxRenderer(jm, jp, base_wh=(64, 64), patch_model=jpm, it=IT)
    got = InteractiveRenderer(tm, tp, base_wh=(64, 64), patch_model=tpm,
                              it=IT, device="cpu")
    for attr in ("_patch_res", "_patch_extent", "_patch_diag", "_patch_px",
                 "_patch_R"):
        assert getattr(got, attr) == getattr(want, attr), attr
    pose = _pose()
    for focal in (30.0, 64 * 1.2, 500.0, 5000.0, 64000.0):
        for r in (1.0, 2.0, 8.0):
            pose[2, 3] = r
            assert got._patch_bound(focal, pose) == \
                want._patch_bound(focal, pose), (focal, r)
    assert not got._patch_ok(64 * 1.2, pose)
    assert got._patch_ok(64000.0, pose)


def test_serve_answers_on_localhost(flagship):
    _, _, _, tm, _, tp = flagship
    server = make_server(tm, tp, host="127.0.0.1", port=0, wh=(32, 32),
                         device="cpu")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    # straight to localhost, whatever proxy the environment names
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        with opener.open(base + "/", timeout=60) as resp:
            assert resp.status == 200
            assert b"/frame?yaw=" in resp.read()
        for q in ("yaw=0.1&pitch=0.2", "yaw=-0.3&pitch=0.0&t=0.5&r=2.5"):
            with opener.open(f"{base}/frame?{q}",
                                        timeout=60) as resp:
                assert resp.headers["Content-Type"] == "image/png"
                assert float(resp.headers["X-Frame-Time"]) >= 0.0
                data = resp.read()
            assert data[:8] == b"\x89PNG\r\n\x1a\n"
            # every level of a 32 x 32 ladder is 32 x 32 (the floor)
            W, H = (int.from_bytes(data[16 + 4 * i:20 + 4 * i], "big")
                    for i in range(2))
            assert (W, H) == (32, 32)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()
