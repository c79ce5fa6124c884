"""Geometry export of the port (hyperreel_tpu_torch/train/export.py,
ops/marching_cubes.py) against the JAX package's on the same inputs:
marching tetrahedra's verts and faces equal, the dense density grid of the
static and the keyframe-time nets, and the mesh PLY."""

import numpy as np
import pytest

from hyperreel_tpu.ops.marching_cubes import marching_tetrahedra as jax_mt
from hyperreel_tpu.train import export as JE
from hyperreel_tpu_torch.ops.marching_cubes import marching_tetrahedra
from hyperreel_tpu_torch.train import export as TE

from torch_parity import flagship_cfg, models, port_weights, static_cfg


def _volumes():
    ax = np.linspace(-1, 1, 17)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    sphere = 0.6 - np.sqrt(x * x + y * y + z * z)
    noise = np.random.default_rng(0).uniform(-1, 1, (9, 7, 8))
    return [(sphere, 0.0, np.array([[-1, -1, -1], [1, 1, 1]], np.float64)),
            (noise, 0.2, None), (np.zeros((4, 4, 4)), 0.5, None)]


@pytest.mark.parametrize("case", range(3))
def test_marching_tetrahedra_equals_jax(case):
    vol, level, bbox = _volumes()[case]
    wv, wf = jax_mt(vol, level, bbox=bbox)
    gv, gf = marching_tetrahedra(vol, level, bbox=bbox)
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(gf, wf)
    assert (len(gv) > 0) == (case < 2)


def _nets(name):
    cfg = flagship_cfg(tiny=True, fused=False, bf16_tables=False) \
        if name == "tiny_dynamic" else static_cfg(fused=False,
                                                 bf16_tables=False)
    jm, tm = models(cfg, bf16=False)
    jp, tp = port_weights(tm, density=0.5)
    return jm.color_net, jp["color"], tm.color_net, tp["color"]


@pytest.mark.parametrize("name", ["tiny_static", "tiny_dynamic"])
def test_density_grid_and_plys_equal_jax(name, tmp_path):
    jn, jp, tn, tp = _nets(name)
    size = (6, 7, 5)
    ws, wpts = JE.eval_density_grid(jn, jp, size)
    gs, gpts = TE.eval_density_grid(tn, tp, size)
    np.testing.assert_array_equal(gpts, wpts)
    assert gs.shape == size and gs.max() > 0
    assert np.abs(gs - ws).max() <= 1e-5 * max(1.0, np.abs(ws).max())

    # the isosurface at the median density, about half the grid inside
    thresh = float(np.median(ws))
    mesh = [str(tmp_path / f"{p}_mesh.ply") for p in ("jax", "port")]
    level = 1.0 - np.exp(-thresh * jn.distance_scale * 0.01)
    counts_j = JE.export_mesh_ply(mesh[0], jn, jp, size, alpha_thresh=level)
    counts_t = TE.export_mesh_ply(mesh[1], tn, tp, size, alpha_thresh=level)
    assert counts_t == counts_j and counts_t[1] > 0
    wv = np.loadtxt(mesh[0], skiprows=9, max_rows=counts_j[0])
    gv = np.loadtxt(mesh[1], skiprows=9, max_rows=counts_t[0])
    assert np.abs(gv - wv).max() <= 1e-5
    with open(mesh[0]) as a, open(mesh[1]) as b:
        assert a.read().splitlines()[9 + counts_j[0]:] == \
            b.read().splitlines()[9 + counts_t[0]:]      # the faces

