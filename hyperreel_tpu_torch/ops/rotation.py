"""Rotation conversions on torch tensors (port of
hyperreel_tpu/ops/rotation.py; reference utils/rotation_conversions.py, a
pytorch3d copy). Quaternions are (w, x, y, z), w first."""

import torch


def axis_angle_to_matrix(axis_angle):
    """Rodrigues' formula: axis-angle [..., 3] -> rotation matrix [..., 3,
    3]; below an angle of 1e-6 the first-order I + K * angle."""
    angle = torch.linalg.norm(axis_angle, dim=-1, keepdim=True)
    small = angle < 1e-6
    axis = axis_angle / torch.where(small, torch.ones_like(angle), angle)
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    zero = torch.zeros_like(x)
    K = torch.stack([
        torch.stack([zero, -z, y], -1),
        torch.stack([z, zero, -x], -1),
        torch.stack([-y, x, zero], -1),
    ], -2)
    eye = torch.eye(3, dtype=K.dtype, device=K.device).expand(K.shape)
    a = angle[..., None]
    R = eye + torch.sin(a) * K + (1.0 - torch.cos(a)) * (K @ K)
    return torch.where(small[..., None], eye + K * a, R)


def quaternion_to_matrix(q):
    """Quaternion (w, x, y, z) [..., 4], not necessarily unit -> rotation
    matrix [..., 3, 3]."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    n = w * w + x * x + y * y + z * z
    s = 2.0 / torch.clamp_min(n, 1e-12)
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return torch.stack([
        torch.stack([1.0 - (yy + zz), xy - wz, xz + wy], -1),
        torch.stack([xy + wz, 1.0 - (xx + zz), yz - wx], -1),
        torch.stack([xz - wy, yz + wx, 1.0 - (xx + yy)], -1),
    ], -2)


def quaternion_apply(q, v):
    """Vectors v [..., 3] rotated by unit quaternions q [..., 4]
    (pytorch3d's quaternion_apply, which CalibrateEmbedding uses,
    nlf/embedding/ray.py:171)."""
    qw, qv = q[..., :1], q[..., 1:]
    uv = torch.linalg.cross(qv, v)
    uuv = torch.linalg.cross(qv, uv)
    return v + 2.0 * (qw * uv + uuv)


def matrix_to_quaternion(R):
    """Rotation matrix [..., 3, 3] -> unit quaternion (w, x, y, z), the
    branchless form: each component's magnitude from the diagonal, the
    signs of x, y, z from the off-diagonal differences."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp_min(x, 1e-12))

    qw = safe_sqrt(1.0 + tr) / 2.0
    qx = torch.copysign(safe_sqrt(1.0 + m00 - m11 - m22) / 2.0, m21 - m12)
    qy = torch.copysign(safe_sqrt(1.0 - m00 + m11 - m22) / 2.0, m02 - m20)
    qz = torch.copysign(safe_sqrt(1.0 - m00 - m11 + m22) / 2.0, m10 - m01)
    q = torch.stack([qw, qx, qy, qz], -1)
    return q / torch.clamp_min(torch.linalg.norm(q, dim=-1, keepdim=True),
                               1e-12)
