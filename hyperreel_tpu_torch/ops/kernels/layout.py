"""The per-sample pack: the one layout that the pack-build kernel writes and
the shade kernel reads (ops/kernels/pack_build.py -> ops/kernels/shade.py).

pack is f32 [PACK_ROWS, B * S], ray-major: sample s of ray r sits in
column r * S + s, so one warp (or an S-lane segment of it) covers one ray
and every row is read and written as contiguous 4-byte lanes. Rows:

  0 xn   1 yn   2 zn   (sample point, aabb-normalized to [-1, 1])
  3 dist             (sorted ray distance; 0 marks an invalid sample)
  4..6  color_scale rgb      7..9 color_shift rgb
  10    weight            (only in a pack with the weights row)

The nets' own fused routes (models/tensorf.py TensorVMNoSample
apply_fused) pack an 11th row, the predicted per-sample weight that
scales the density feature before the relu; the JAX package carries it in
row 14. A kernel is told which of the two packs it reads (the spec's
`weights`), and check_pack refuses the other.

Per-ray values stay in the ray pack f32 [B, 8] (o xyz, d xyz, dt, tn)
that both kernels read: the shade kernel takes the view direction and the
keyframe time coordinate tn from it.

The JAX package packs 16 rows (tn in row 3, the view direction in rows
11..13, two zero rows of padding) in an S-major lane order within tiles
of `tile` rays; `pack_from_smajor` converts.
"""

import torch

PACK_ROWS = 10
WEIGHTS_ROW = PACK_ROWS            # the weights row, after the others
# the JAX pack's rows that hold the port's rows, in order (its weights row
# is 14)
JAX_PACK_ROWS = (0, 1, 2, 4, 5, 6, 7, 8, 9, 10)
JAX_WEIGHTS_ROW = 14


def pack_rows(weights):
    """The row count of a pack without or with the weights row."""
    return PACK_ROWS + 1 if weights else PACK_ROWS


def check_pack(pack, S, weights=False):
    """Raise unless `pack` is a contiguous f32 [rows, B*S] pack, rows =
    pack_rows(weights); returns B."""
    rows = pack_rows(weights)
    if pack.dtype != torch.float32 or pack.dim() != 2 \
            or pack.shape[0] != rows or not pack.is_contiguous():
        raise ValueError(
            f"pack must be contiguous f32 [{rows}, B*S]"
            f"{' (with the weights row)' if weights else ''}, got "
            f"{pack.dtype} {tuple(pack.shape)}")
    if pack.shape[1] % S:
        raise ValueError(f"pack width {pack.shape[1]} is not a multiple "
                         f"of S={S}")
    return pack.shape[1] // S


def check_ray_pack(ray_pack, B):
    """Raise unless `ray_pack` is a contiguous f32 [B, 8] ray pack."""
    if ray_pack.dtype != torch.float32 or tuple(ray_pack.shape) != (B, 8) \
            or not ray_pack.is_contiguous():
        raise ValueError(f"ray_pack must be contiguous f32 ({B}, 8), got "
                         f"{ray_pack.dtype} {tuple(ray_pack.shape)}")


def pack_from_smajor(pack16, S, tile):
    """JAX pack [16, N] in S-major tile order (lane s*tile + r within each
    block of tile*S lanes) -> the port's [PACK_ROWS, N] ray-major pack."""
    rows, N = pack16.shape
    nb = N // (S * tile)
    out = pack16[list(JAX_PACK_ROWS)].reshape(PACK_ROWS, nb, S, tile)
    return out.permute(0, 1, 3, 2).reshape(PACK_ROWS, N).contiguous()
