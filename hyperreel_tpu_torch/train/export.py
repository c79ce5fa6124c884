"""Geometry export (port of hyperreel_tpu/train/export.py; reference
utils/tensorf_utils.py, the marching-cubes PLY export :170-229).

`export_mesh_ply`: the density field evaluated on a dense grid ->
isosurface triangle mesh (numpy marching tetrahedra,
ops/marching_cubes.py) -> PLY with faces. The grid is evaluated row by row
(one x slice at a time) on the device of the params; the density is the
net's `sample_density` (the keyframe-time net's at t = 0) through
`feature2density`.
"""

import numpy as np
import torch

from hyperreel_tpu_torch.models.tensorf import TensorVMKeyframeTime
from hyperreel_tpu_torch.ops.marching_cubes import (
    marching_tetrahedra, write_ply_mesh)


def _device_of(params):
    while isinstance(params, dict):
        params = next(iter(params.values()))
    return params.device


def eval_density_grid(net, params_color, grid_size=(128, 128, 128)):
    """Dense density-field evaluation on the net's aabb: returns
    (sigma [gx, gy, gz] float32, pts [gx, gy, gz, 3] world coords)."""
    gx, gy, gz = grid_size
    aabb = np.asarray(net.aabb)
    xs = np.linspace(0, 1, gx)
    ys = np.linspace(0, 1, gy)
    zs = np.linspace(0, 1, gz)
    grid = np.stack(np.meshgrid(xs, ys, zs, indexing="ij"), -1)
    pts = aabb[0] * (1 - grid) + aabb[1] * grid
    dev = _device_of(params_color)
    timed = isinstance(net, TensorVMKeyframeTime)

    sig = torch.zeros((gx, gy * gz), dtype=torch.float32, device=dev)
    with torch.no_grad():
        for i in range(gx):
            row = torch.as_tensor(pts[i].reshape(-1, 3), dtype=torch.float32,
                                  device=dev)
            xyz = net.normalize_coord(row)
            if timed:
                xyz = torch.cat([xyz, torch.zeros_like(xyz[:, :1])], -1)
            sig[i] = net.feature2density(net.sample_density(params_color,
                                                            xyz))
    return sig.cpu().numpy().reshape(gx, gy, gz), pts.astype(np.float32)


def export_mesh_ply(path, net, params_color, grid_size=(128, 128, 128),
                    alpha_thresh=0.005, step_size=0.01):
    """Mesh export (utils/tensorf_utils.py:170-229 + the export path in
    nlf/nets/tensorf_base.py): dense sigma -> per-voxel alpha = 1 -
    exp(-sigma * distance_scale * step) -> isosurface at `alpha_thresh` ->
    triangle PLY. Returns (num_verts, num_faces)."""
    sigma, _ = eval_density_grid(net, params_color, grid_size)
    scale = float(getattr(net, "distance_scale", 1.0)) * step_size
    alpha = 1.0 - np.exp(-sigma * scale)
    verts, faces = marching_tetrahedra(
        alpha, level=alpha_thresh, bbox=np.asarray(net.aabb))
    write_ply_mesh(path, verts, faces)
    return len(verts), len(faces)

