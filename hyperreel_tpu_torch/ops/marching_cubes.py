"""Pure-numpy isosurface extraction for the density-field mesh export (a
copy of hyperreel_tpu/ops/marching_cubes.py, which the port keeps as its
own; reference utils/tensorf_utils.py:170-229 `convert_sdf_samples_to_ply`,
which uses skimage.measure.marching_cubes + plyfile).

Marching tetrahedra over the 6-tet decomposition of each grid cube (all
tets share the cube's main diagonal, so faces of adjacent cubes tessellate
identically -> watertight meshes). Vertices are placed by linear
interpolation along crossed edges and deduplicated globally, faces are
wound data-driven (normal checked against the inside->outside direction of
the generating tet). Output: (verts, faces) in world coordinates given a
bbox, with outward-oriented triangles.
"""

import numpy as np

# cube corner offsets (dx, dy, dz); corner c of cube (i, j, k) sits at
# (i, j, k) + _CORNERS[c]
_CORNERS = np.array(
    [(0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
     (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)], np.int64)

# 6 tetrahedra around the main diagonal corner0 -> corner6; every cube
# face is split along the same diagonal as its neighbor's shared face.
_TETS = np.array(
    [(0, 5, 1, 6), (0, 1, 2, 6), (0, 2, 3, 6),
     (0, 3, 7, 6), (0, 7, 4, 6), (0, 4, 5, 6)], np.int64)

# tet-case -> triangles as pairs of local tet-vertex indices (edges).
# bit v of the case is set when tet vertex v is inside (value > level).
# single-vertex cases emit 1 triangle, two-vertex cases a 2-triangle quad;
# winding is fixed afterwards from geometry.
_CASE_EDGES = {
    0b0001: [((0, 1), (0, 2), (0, 3))],
    0b0010: [((1, 0), (1, 2), (1, 3))],
    0b0100: [((2, 0), (2, 1), (2, 3))],
    0b1000: [((3, 0), (3, 1), (3, 2))],
    0b0011: [((0, 2), (0, 3), (1, 2)), ((1, 2), (0, 3), (1, 3))],
    0b0101: [((0, 1), (0, 3), (2, 1)), ((2, 1), (0, 3), (2, 3))],
    0b1001: [((0, 1), (0, 2), (3, 1)), ((3, 1), (0, 2), (3, 2))],
    0b0110: [((1, 0), (1, 3), (2, 0)), ((2, 0), (1, 3), (2, 3))],
    0b1010: [((1, 0), (1, 2), (3, 0)), ((3, 0), (1, 2), (3, 2))],
    0b1100: [((2, 0), (2, 1), (3, 0)), ((3, 0), (2, 1), (3, 1))],
}
# complement cases reuse the table with inside/outside swapped
for _m in list(_CASE_EDGES):
    _c = 0b1111 ^ _m
    if _c not in _CASE_EDGES:
        _CASE_EDGES[_c] = _CASE_EDGES[_m]


def marching_tetrahedra(volume, level, bbox=None):
    """Extract the `volume > level` isosurface.

    Args:
      volume: [nx, ny, nz] float array.
      level:  iso value.
      bbox:   optional [2, 3] world bounds; grid point (i, j, k) maps to
              bbox[0] + (i, j, k)/(n-1) * (bbox[1]-bbox[0]). Defaults to
              index coordinates (like skimage with spacing=1).

    Returns:
      verts [V, 3] float32, faces [F, 3] int32 (outward-wound: normals
      point from inside (>level) to outside).
    """
    vol = np.asarray(volume, np.float64)
    nx, ny, nz = vol.shape
    if nx < 2 or ny < 2 or nz < 2:
        return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32))

    inside = vol > level
    flat_in = inside.reshape(-1)

    # find mixed-sign cubes by slicing (no per-cube corner materialization:
    # all-same-sign cubes are the vast majority)
    n_in = np.zeros((nx - 1, ny - 1, nz - 1), np.int8)
    for dx, dy, dz in _CORNERS:
        n_in += inside[dx:nx - 1 + dx, dy:ny - 1 + dy, dz:nz - 1 + dz]
    base = np.argwhere((n_in > 0) & (n_in < 8))               # [NCm, 3]
    corner_pts = base[:, None, :] + _CORNERS[None]            # [NCm, 8, 3]
    corner_ids = (corner_pts[..., 0] * (ny * nz)
                  + corner_pts[..., 1] * nz + corner_pts[..., 2])
    if corner_ids.size == 0:
        return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32))

    # expand to tets: [NT, 4] global point ids
    tet_pids = corner_ids[:, _TETS].reshape(-1, 4)
    tet_in = flat_in[tet_pids]
    case = (tet_in * (1 << np.arange(4))[None]).sum(1)

    tri_edges = []      # [T, 3, 2] global point-id pairs
    tri_tets = []       # [T, 4] the generating tet's point ids
    for c, tris in _CASE_EDGES.items():
        sel = tet_pids[case == c]
        if sel.shape[0] == 0:
            continue
        for tri in tris:
            e = np.stack([sel[:, list(pair)] for pair in tri], 1)
            tri_edges.append(e)
            tri_tets.append(sel)
    if not tri_edges:
        return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32))
    tri_edges = np.concatenate(tri_edges, 0)                  # [T, 3, 2]
    tri_tets = np.concatenate(tri_tets, 0)                    # [T, 4]

    # dedup edge -> vertex, on one int64 key per edge (lo * points + hi
    # sorts as the pair (lo, hi) does, so the vertices come in the order
    # that np.unique over the pairs' rows gives, at a fraction of its time)
    e_key = np.sort(tri_edges.reshape(-1, 2), 1)
    n_pts = nx * ny * nz
    keys, inv = np.unique(e_key[:, 0] * n_pts + e_key[:, 1],
                          return_inverse=True)
    uniq = np.stack([keys // n_pts, keys % n_pts], 1)
    faces = inv.reshape(-1, 3).astype(np.int32)

    flat_val = vol.reshape(-1)

    def _coords(ids):
        return np.stack(np.unravel_index(ids, (nx, ny, nz)),
                        -1).astype(np.float64)

    p0, p1 = _coords(uniq[:, 0]), _coords(uniq[:, 1])
    f0, f1 = flat_val[uniq[:, 0]], flat_val[uniq[:, 1]]
    t = np.clip((level - f0) / np.where(np.abs(f1 - f0) < 1e-30,
                                        1e-30, f1 - f0), 0.0, 1.0)
    verts = p0 + t[:, None] * (p1 - p0)

    # data-driven winding: flip triangles whose normal points toward the
    # generating tet's inside centroid instead of away from it
    tet_coords = _coords(tri_tets)                            # [T, 4, 3]
    t_in = flat_in[tri_tets]                                  # [T, 4]
    w_in = t_in / np.maximum(t_in.sum(1, keepdims=True), 1)
    w_out = (~t_in) / np.maximum((~t_in).sum(1, keepdims=True), 1)
    io_dir = ((tet_coords * w_out[..., None]).sum(1)
              - (tet_coords * w_in[..., None]).sum(1))        # [T, 3]
    v = verts[faces]                                          # [T, 3, 3]
    n = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    flip = (n * io_dir).sum(1) < 0
    faces[flip] = faces[flip][:, ::-1]

    if bbox is not None:
        bbox = np.asarray(bbox, np.float64)
        scale = (bbox[1] - bbox[0]) / (np.array([nx, ny, nz]) - 1)
        verts = bbox[0] + verts * scale
    return verts.astype(np.float32), faces


def write_ply_mesh(path, verts, faces):
    """ASCII PLY with vertex + face elements (plyfile-compatible layout,
    reference utils/tensorf_utils.py:211-229)."""
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(verts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write(f"element face {len(faces)}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        # rows as Python numbers (tolist): the same text as formatting
        # numpy scalars, several times faster for a mesh of millions
        f.writelines(f"{x:.6f} {y:.6f} {z:.6f}\n"
                     for x, y, z in np.asarray(verts).tolist())
        f.writelines(f"3 {a} {b} {c}\n"
                     for a, b, c in np.asarray(faces).tolist())
