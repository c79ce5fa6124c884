"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked `cuda`: without an NVIDIA card every test here skips (CUDA
kernels have no CPU mode; the plain versions are held against the JAX
package by tests/test_torch_pack_build.py, test_torch_shade.py and
test_torch_slice.py). Run on the card with

    python -m pytest tests/test_torch_cuda.py -q --noconftest

(--noconftest: tests/conftest.py sets up JAX, which this file does not
use and the machine with the card may not have.)
"""

import numpy as np
import pytest
import torch

from hyperreel_tpu.configs.presets import (
    convert_epochs_to_iters, technicolor_z_plane, tiny_dynamic)
from hyperreel_tpu_torch.models.ctx import StepCtx
from hyperreel_tpu_torch.models.model import build_model
from hyperreel_tpu_torch.ops.kernels.pack_build import (
    pack_build, pack_build_plain)
from hyperreel_tpu_torch.ops.kernels.shade import (
    ShadeSpec, premix_time, shade, shade_plain)

pytestmark = pytest.mark.cuda

INFO = {"num_keyframes": 4, "num_frames": 50, "num_views": 16}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _model(tiny, dev, bf16=False):
    cfg = convert_epochs_to_iters(
        tiny_dynamic() if tiny else technicolor_z_plane(), 4000)
    cfg["color"]["net"].update(fused_render=True, bf16_tables=True)
    model = build_model(cfg, dataset_info=INFO,
                        compute_dtype=torch.bfloat16 if bf16 else None)
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen, dev)
    for k, v in params["color"]["density"].items():
        params["color"]["density"][k] = 0.3 * torch.rand(
            v.shape, generator=gen).to(dev)
    return cfg, model, params


def _rays(n, dev, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.5, 0.5, (n, 3))
    o[:, 2] -= 1.5
    d = rng.uniform(-0.3, 0.3, (n, 3))
    d[:, 2] = 1.0
    cam = rng.integers(0, 16, (n, 1))
    t = rng.uniform(0, 1, (n, 1))
    rays = np.concatenate([o, d, cam, t], -1).astype(np.float32)
    return torch.from_numpy(rays).to(dev)


# K1 under the f32 MLP policy runs the same f32 math as its plain version
# (1e-5); under the bf16 policy both sum exact bf16 products in another
# order, and a rounding flip in a hidden layer moves the pack by up to
# ~1e-3 (chip_smoke.py PACK_TOL_BF16).
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("tiny", [True, False], ids=["S8", "S32"])
@pytest.mark.parametrize("n", [1000, 4096])       # ragged and whole blocks
def test_kernels_match_plain(dev, tiny, n, bf16):
    _, model, params = _model(tiny, dev, bf16)
    cf = model._cf_eval
    prep = cf.prepare(params)
    ctx = StepCtx(it=20000)
    rays = _rays(n, dev)
    x0 = cf.pred.net_input(rays, ctx).float().contiguous()
    rp = cf.ray_pack(rays)
    pack = pack_build(x0, prep["mlp"], rp, cf.spec, 20000)
    pack_p = pack_build_plain(x0, prep["mlp"], rp, cf.spec, 20000)
    assert (pack - pack_p).abs().max() <= (2e-3 if bf16 else 1e-5)
    H, W, TH, TW, C, nd = prep["dims"]
    for th in (TH, 0):
        ttab = prep["ttab"] if th else premix_time(prep["ttab"], rp[0, 7])
        spec = ShadeSpec(S=cf.S, W=W, H=H, TW=TW, TH=th, C=C, nd=nd,
                         deg=cf.net.sh_deg,
                         distance_scale=cf.net.distance_scale)
        out = shade(prep["quad"], pack, rp, ttab, prep["wb"], spec)
        ref = shade_plain(prep["quad"], pack, rp, ttab, prep["wb"], spec)
        torch.cuda.synchronize()
        # the per-ray sums run in another order (warp butterfly)
        assert (out[:, :4] - ref[:, :4]).abs().max() <= 1e-4
        assert (out[:, 4] - ref[:, 4]).abs().max() <= 1e-3
        # both kernels against both plain versions: the fused-path gate
        ref = shade_plain(prep["quad"], pack_p, rp, ttab, prep["wb"], spec)
        assert (out[:, :4] - ref[:, :4]).abs().max() <= 2e-4


def test_fused_model_matches_general_on_card(dev):
    import copy
    cfg, model, params = _model(True, dev)
    cfg_g = copy.deepcopy(cfg)
    cfg_g["color"]["net"]["fused_render_cf"] = False
    general = build_model(cfg_g, dataset_info=INFO)
    rays = _rays(4096, dev, seed=1)
    ctx = StepCtx(it=20000)
    before = (pack_build.launches, shade.launches)
    a = model.apply(params, rays, ctx)["rgb"]
    assert (pack_build.launches, shade.launches) == (before[0] + 1,
                                                     before[1] + 1)
    b = general.apply(params, rays, ctx)["rgb"]
    assert (a - b).abs().max() <= 2e-4
