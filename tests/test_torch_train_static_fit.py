"""The static net's training loop across its grid events against the JAX
package's Trainer (tests/torch_train_parity.py): tiny_static and
tiny_shiny (its sample stages drawing a count per step), 30 steps across
an alpha event at 10 whose shrink crops the planes and lines to the
occupied box and an upsample 16^3 -> 24^3 voxels at 20: the history at
every log point, the params, grid_size, aabb and the optimizer state
(convert.py's opt_state_from_jax of the JAX trainer's, each leaf's Adam
moments)."""

import numpy as np
import pytest

import jax

from hyperreel_tpu_torch.convert import opt_state_from_jax

from torch_train_parity import fit_both, max_param_err, preset_cfg, scene


# The history within 1e-5 relative at every log point; the params within
# 1e-4 and the Adam moments within 1e-4 of their largest entry (Adam's
# normalized update turns f32 rounding differences of near-zero gradients
# into differences of the updates, tests/test_torch_train_step.py;
# measured 2.5e-5 on the params); grid_size and aabb equal.
@pytest.mark.parametrize("name", ["tiny_static", "tiny_shiny"])
def test_fit_across_grid_events_matches_jax(name):
    cfg = preset_cfg(name, events=True)
    ds = scene(name)
    lo = np.asarray(cfg["color"]["net"]["aabb"][0], np.float32)
    jt, js, jh, tt, ts, th = fit_both(cfg, ds)
    assert [h["it"] for h in th] == [h["it"] for h in jh] == \
        list(range(5, 31, 5))
    for a, b in zip(jh, th):
        for k in ("loss", "image_loss", "psnr"):
            assert b[k] == pytest.approx(a[k], rel=1e-5), (a["it"], k)
    jnet, tnet = jt.model.color_net, tt.model.color_net
    assert tnet.grid_size == jnet.grid_size
    np.testing.assert_array_equal(tnet.aabb, jnet.aabb)
    assert tnet.aabb[0][0] > lo[0]         # the shrink cropped the grids
    assert max(max_param_err(js.params, ts.params).values()) <= 1e-4
    want = opt_state_from_jax(jax.tree.map(np.asarray, js.opt_state),
                              tt.model.param_groups(ts.params), "cpu")
    # (optax keeps a counter for the groups without leaves too)
    assert ts.opt_state["count"] == {"color": 10, "embedding_impl": 10}
    assert all(want["count"][k] == 10 for k in ts.opt_state["count"])
    for key, slot in want["slots"].items():
        for m, w in slot.items():
            got = ts.opt_state["slots"][key][m]
            assert got.shape == w.shape, (key, m)
            assert (got - w).abs().max() <= 1e-4 * w.abs().max(), (key, m)
