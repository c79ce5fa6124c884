"""LPIPS of the port (hyperreel_tpu_torch/train/lpips.py) against the JAX
package's on a weights file of random values that the test writes (no
weights can be fetched): the distance within 1e-5, the npz schema read
and written alike, and the weights path from the config or the
environment."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from hyperreel_tpu.train import lpips as JL
from hyperreel_tpu_torch.train import lpips as TL


def _random_weights(path, seed=0):
    """VGG16 convs (He-scaled, so that activations stay O(1)) and
    non-negative heads in the npz schema."""
    rng = np.random.default_rng(seed)
    out, cin, ci = {}, 3, 0
    for spec in TL._VGG_PLAN:
        if spec is None:
            continue
        out[f"conv_{ci}_w"] = rng.normal(
            0, np.sqrt(2.0 / (9 * cin)), (3, 3, cin, spec)).astype(np.float32)
        out[f"conv_{ci}_b"] = rng.normal(0, 0.01, spec).astype(np.float32)
        cin, ci = spec, ci + 1
    for k, c in enumerate((64, 128, 256, 512, 512)):
        out[f"lin_{k}_w"] = rng.uniform(0, 1, c).astype(np.float32)
    np.savez(path, **out)
    return out


def test_lpips_matches_jax(tmp_path):
    path = str(tmp_path / "lpips.npz")
    _random_weights(path)
    rng = np.random.default_rng(1)
    a = rng.uniform(0, 1, (20, 24, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    jp, tp = JL.load_weights(path), TL.load_weights(path, device="cpu")
    assert set(tp) == set(jp)
    want = float(JL.lpips(jp, jnp.asarray(a), jnp.asarray(b)))
    got = TL.lpips(tp, torch.from_numpy(a), torch.from_numpy(b))
    assert got.dim() == 0
    assert abs(float(got) - want) <= 1e-5, (float(got), want)
    assert want > 1e-3
    assert float(TL.lpips(tp, torch.from_numpy(a),
                          torch.from_numpy(a))) == 0.0


def test_weights_schema_and_path(tmp_path, monkeypatch):
    want = _random_weights(str(tmp_path / "w.npz"), seed=2)
    # torchvision's VGG16 features (conv, relu, pool indices) and the lpips
    # heads, as convert_torch_weights reads them
    vgg, lin, ci, feat = {}, {}, 0, 0
    for spec in TL._VGG_PLAN:
        if spec is None:
            feat += 1
            continue
        vgg[f"features.{feat}.weight"] = torch.from_numpy(
            want[f"conv_{ci}_w"].transpose(3, 2, 0, 1).copy())
        vgg[f"features.{feat}.bias"] = torch.from_numpy(want[f"conv_{ci}_b"])
        ci, feat = ci + 1, feat + 2
    for k in range(5):
        lin[f"lin{k}.model.1.weight"] = torch.from_numpy(
            want[f"lin_{k}_w"]).reshape(1, -1, 1, 1)
    paths = [str(tmp_path / f"{n}.npz") for n in ("jax", "port")]
    JL.convert_torch_weights(vgg, lin, paths[0])
    TL.convert_torch_weights(vgg, lin, paths[1])
    a, b = np.load(paths[0]), np.load(paths[1])
    assert sorted(a.files) == sorted(b.files) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(b[k], a[k])
        np.testing.assert_array_equal(b[k], want[k])

    bad = str(tmp_path / "bad.npz")
    np.savez(bad, conv_0_w=want["conv_0_w"])
    with pytest.raises(KeyError):
        TL.load_weights(bad, device="cpu")

    monkeypatch.delenv("HYPERREEL_LPIPS_WEIGHTS", raising=False)
    for cfg in (None, {}, {"lpips_weights": "x.npz"}):
        assert TL.default_weights_path(cfg) == JL.default_weights_path(cfg)
    monkeypatch.setenv("HYPERREEL_LPIPS_WEIGHTS", "env.npz")
    assert TL.default_weights_path({}) == JL.default_weights_path({}) == \
        "env.npz"
