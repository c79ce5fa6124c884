"""Real spherical-harmonics bases, degrees 0-4 (port of
hyperreel_tpu/ops/sh.py; reference utils/sh_utils.py:41-141)."""

import torch

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
      -1.0925484305920792, 0.5462742152960396)
C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
      0.3731763325901154, -0.4570457994644658, 1.445305721320277,
      -0.5900435899266435)
C4 = (2.5033429417967046, -1.7701307697799304, 0.9461746957575601,
      -0.6690465435572892, 0.10578554691520431, -0.6690465435572892,
      0.47308734787878004, -1.7701307697799304, 0.6258357354491761)


def eval_sh_bases(deg, dirs):
    """dirs [..., 3] unit directions -> [..., (deg+1)**2] basis values."""
    if not 0 <= deg <= 4:
        raise ValueError(f"SH degree {deg} outside [0, 4]")
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    out = [torch.full_like(x, C0)]
    if deg > 0:
        out += [-C1 * y, C1 * z, -C1 * x]
    if deg > 1:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        out += [C2[0] * xy, C2[1] * yz, C2[2] * (2.0 * zz - xx - yy),
                C2[3] * xz, C2[4] * (xx - yy)]
    if deg > 2:
        out += [C3[0] * y * (3.0 * xx - yy),
                C3[1] * xy * z,
                C3[2] * y * (4.0 * zz - xx - yy),
                C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
                C3[4] * x * (4.0 * zz - xx - yy),
                C3[5] * z * (xx - yy),
                C3[6] * x * (xx - 3.0 * yy)]
    if deg > 3:
        out += [C4[0] * xy * (xx - yy),
                C4[1] * yz * (3.0 * xx - yy),
                C4[2] * xy * (7.0 * zz - 1.0),
                C4[3] * yz * (7.0 * zz - 3.0),
                C4[4] * (zz * (35.0 * zz - 30.0) + 3.0),
                C4[5] * xz * (7.0 * zz - 3.0),
                C4[6] * (xx - yy) * (7.0 * zz - 1.0),
                C4[7] * xz * (xx - 3.0 * yy),
                C4[8] * (xx * (xx - 3.0 * yy) - yy * (3.0 * xx - yy))]
    return torch.stack(out, -1)


def sh_render(viewdirs, features, deg=2):
    """features [..., 3*(deg+1)**2] (channel-major: coefficient k of
    channel c at c*K + k) -> rgb [..., 3] = relu(sum + 0.5)
    (reference utils/tensorf_utils.py:334-339)."""
    n_basis = (deg + 1) ** 2
    basis = eval_sh_bases(deg, viewdirs)
    coeffs = features.reshape(features.shape[:-1] + (3, n_basis))
    return torch.clamp_min((basis[..., None, :] * coeffs).sum(-1) + 0.5, 0.0)
