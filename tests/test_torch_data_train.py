"""Training from a scene on disk: the technicolor fixture
(tests/torch_data_fixtures.py) through the port's loader and the JAX
package's, then tiny_dynamic trained 2 steps on each package's rays by its
own Trainer, with the set-up of tests/torch_train_parity.py (one set of
weights, the JAX steps' draws injected into the port's): the losses
within 1e-5 relative, as tests/test_torch_train_step.py holds a fit."""

import jax
import numpy as np
import pytest

from hyperreel_tpu.data.technicolor import load_technicolor as jax_load
from hyperreel_tpu_torch.data.technicolor import load_technicolor

from torch_data_fixtures import technicolor
from torch_train_parity import (
    BATCH, jax_batches, preset_cfg, record_jax_draws, start)


def test_technicolor_scene_trains_as_in_jax(tmp_path):
    root = technicolor(str(tmp_path))
    kw = dict(img_wh=(32, 16), rows=2, cols=2, val_pairs=((1, 1),),
              keyframe_step=2)
    want, got = jax_load(root, **kw), load_technicolor(root, **kw)
    assert got.info() == want.info()
    assert got.info()["num_keyframes"] == 2 and got.num_rays > BATCH
    jt, js, tt, ts = start(preset_cfg("tiny_dynamic"), got)
    draws = record_jax_draws(jt)
    js, jh = jt.fit(js, jax_batches(want), 2, jax.random.PRNGKey(1),
                    log_every=1)
    ts, th = tt.fit(ts, got.batch_iterator(BATCH, seed=0), 2, log_every=1,
                    draws=lambda it: draws[it])
    assert [h["it"] for h in th] == [h["it"] for h in jh] == [1, 2]
    for a, b in zip(jh, th):
        for k in ("loss", "image_loss", "psnr"):
            assert np.isfinite(b[k])
            assert b[k] == pytest.approx(a[k], rel=1e-5), (a["it"], k)
