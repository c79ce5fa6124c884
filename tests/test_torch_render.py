"""The chunked renderer (hyperreel_tpu_torch/train/render.py) against
the JAX package's Renderer on the same weights and rays: tiny_static and
tiny_dynamic on a ray count that is not a multiple of the chunk (the last
chunk padded with the last ray), with and without render fields; and
get_mean_outputs."""

import numpy as np
import pytest

from hyperreel_tpu.train.metrics import get_mean_outputs as jax_means
from hyperreel_tpu.train.render import Renderer as JaxRenderer
from hyperreel_tpu_torch.train.metrics import get_mean_outputs
from hyperreel_tpu_torch.train.render import Renderer

from torch_parity import (entry_rays, flagship_cfg, models, static_cfg,
                          port_weights, static_rays)

N_RAYS, CHUNK, IT = 300, 128, 20000


def _cfg(name, fused):
    return flagship_cfg(tiny=True, fused=fused, bf16_tables=fused) \
        if name == "tiny_dynamic" \
        else static_cfg(fused=fused, bf16_tables=fused)


def _rays(name):
    return entry_rays(N_RAYS, seed=3) if name == "tiny_dynamic" \
        else static_rays(N_RAYS, seed=3)


def _render(name, fused, fields):
    jm, tm = models(_cfg(name, fused), bf16=False)
    jp, tp = port_weights(tm)
    rays = _rays(name)
    want = JaxRenderer(jm, ray_chunk=CHUNK).render_rays(jp, rays, IT,
                                                        fields)
    got = Renderer(tm, ray_chunk=CHUNK, device="cpu").render_rays(
        tp, rays, IT, fields)
    return tm, want, got


# The general chain under the f32 policy (f32 MLP and tables) within 1e-5,
# the fields too (tests/test_torch_slice.py's gate for the general path).
@pytest.mark.parametrize("fields", [(), ("points", "distances", "weights")])
@pytest.mark.parametrize("name", ["tiny_static", "tiny_dynamic"])
def test_general_render_matches_jax(name, fields):
    _, want, got = _render(name, False, fields)
    assert set(got) == set(want)
    for k, w in want.items():
        assert isinstance(got[k], np.ndarray)
        assert got[k].shape == w.shape, k
        assert got[k].shape[0] == N_RAYS, k
        assert np.abs(got[k] - w).max() <= 1e-5, k
    assert want["rgb"].std() > 1e-3          # not a constant image


# The static net's fused route with its tables prepared once per call, at
# the 2e-4 gate of tests/test_fused_cf.py (bf16 tables in both; the
# dynamic route's JAX kernel also rounds its time table to bf16 where the
# port's taps stay f32: tests/test_torch_slice.py holds that route).
@pytest.mark.parametrize("fields", [(), ("distances",)])
def test_fused_render_matches_jax(fields):
    tm, want, got = _render("tiny_static", True, fields)
    assert tm._cf_eval is not None
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        assert np.abs(got[k] - w).max() <= 2e-4, k


def test_render_image_and_a_changed_parameter():
    """render_image reshapes to [H, W, ...]; the tables are prepared per
    call, so a parameter changed in place between calls is rendered."""
    jm, tm = models(_cfg("tiny_static", True), bf16=False)
    _, tp = port_weights(tm)
    r = Renderer(tm, ray_chunk=CHUNK, device="cpu")
    rays = _rays("tiny_static")[:280]
    img = r.render_image(tp, rays, (20, 14), IT)["rgb"]
    assert img.shape == (14, 20, 3)
    np.testing.assert_array_equal(img.reshape(-1, 3),
                                  r.render_rays(tp, rays, IT)["rgb"])
    for v in tp["color"]["app"].values():
        v.add_(0.5)
    again = r.render_image(tp, rays, (20, 14), IT)["rgb"]
    assert np.abs(again - img).max() > 1e-2


def test_get_mean_outputs_matches_jax():
    outs = [{"psnr": 20.5, "ssim": np.float32(0.5)},
            {"psnr": 22.0, "ssim": np.float32(0.75)}]
    assert get_mean_outputs(outs) == jax_means(outs)
    assert get_mean_outputs([]) == jax_means([]) == {}
