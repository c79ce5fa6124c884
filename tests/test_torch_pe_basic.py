"""The basic positional encoding (hyperreel_tpu_torch/models/pe.py
BasicPE: [x, sin of every channel at every frequency, then the cosines])
against the JAX package's basic_pe on the same inputs, made with numpy
from a seed: the same f32 products and sines, within 1e-6."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from hyperreel_tpu.models.pe import get_pe as jax_pe
from hyperreel_tpu_torch.models.pe import BasicPE, get_pe


@pytest.mark.parametrize("n_freqs,in_channels,freq_multiplier", [
    (0, 3, 2.0), (2, 3, 2.0), (4, 1, 2.0), (3, 6, 1.5)])
def test_basic_pe_matches_jax(n_freqs, in_channels, freq_multiplier):
    cfg = {"type": "basic", "n_freqs": n_freqs,
           "freq_multiplier": freq_multiplier}
    x = np.random.default_rng(n_freqs).uniform(
        -1.5, 1.5, (5, 7, in_channels)).astype(np.float32)
    j, t = jax_pe(in_channels, cfg), get_pe(in_channels, cfg)
    assert isinstance(t, BasicPE)
    assert t.out_channels == j.out_channels == in_channels * (2 * n_freqs
                                                              + 1)
    want = np.asarray(j.apply(jnp.asarray(x)))
    got = t.apply(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
