"""Camera pose utilities (port of hyperreel_tpu/ops/pose_math.py; reference
utils/pose_utils.py), numpy on the host: the loaders correct their poses
once, before any ray is made."""

import numpy as np


def normalize(v):
    return v / max(np.linalg.norm(v), 1e-12)


def average_poses(poses):
    """Mean camera-to-world from a stack [N, 3, 4]
    (reference utils/pose_utils.py: average_poses): z = mean viewing dir,
    y up-vector hint, x = y cross z."""
    center = poses[..., 3].mean(0)
    z = normalize(poses[..., 2].mean(0))
    y_ = poses[..., 1].mean(0)
    x = normalize(np.cross(y_, z))
    y = np.cross(z, x)
    return np.stack([x, y, z, center], 1)


def center_poses(poses):
    """Re-express all poses relative to their average
    (reference utils/pose_utils.py:48-59). Returns (centered [N,3,4],
    inverse average pose [4,4])."""
    pose_avg = average_poses(poses)
    pose_avg_homo = np.eye(4)
    pose_avg_homo[:3] = pose_avg
    last_row = np.tile(np.array([0, 0, 0, 1.0]), (len(poses), 1, 1))
    poses_homo = np.concatenate([poses, last_row], 1)
    inv_avg = np.linalg.inv(pose_avg_homo)
    poses_centered = inv_avg @ poses_homo
    return poses_centered[:, :3], inv_avg


def correct_poses_bounds(poses, bounds, flip=True, center=True):
    """LLFF pose correction (reference utils/pose_utils.py:230-255):
    "down right back" -> "right up back" column permutation, scale
    normalization by near.min()*0.75, recentering. Returns
    (poses, ref_pose, bounds)."""
    poses = np.array(poses, np.float64)
    bounds = np.array(bounds, np.float64)
    if flip:
        poses = np.concatenate(
            [poses[..., 1:2], -poses[..., :1], poses[..., 2:4]], -1)
    scale_factor = bounds.min() * 0.75
    bounds = bounds / scale_factor
    poses[..., :3, 3] = poses[..., :3, 3] / scale_factor
    if center:
        poses, ref_pose = center_poses(poses)
    else:
        ref_pose = poses[0]
    return poses, ref_pose, bounds


def viewmatrix(z, up, pos):
    """Camera basis from viewing dir + up hint
    (reference utils/pose_utils.py:39-44)."""
    vec2 = normalize(z)
    vec0 = normalize(np.cross(up, vec2))
    vec1 = normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, pos], 1)


def create_spiral_poses(poses, rads, focal, N=120, flip=False):
    """Spiral render path anchored on the average input pose
    (reference utils/pose_utils.py:162-183)."""
    c2w = average_poses(poses)
    up = normalize(poses[:, :3, 1].sum(0))
    rots = 2
    rads = np.array(list(rads) + [1.0])

    render_poses = []
    for theta in np.linspace(0.0, 2.0 * np.pi * rots, N + 1)[:-1]:
        c = np.dot(c2w[:3, :4], np.array(
            [np.cos(theta), -np.sin(theta), -np.sin(theta * 0.5), 1.0]
        ) * rads)
        if flip:
            z = normalize(
                np.dot(c2w[:3, :4], np.array([0, 0, focal, 1.0])) - c)
        else:
            z = normalize(
                c - np.dot(c2w[:3, :4], np.array([0, 0, -focal, 1.0])))
        render_poses.append(viewmatrix(z, up, c))
    return np.stack(render_poses, 0)


def create_spherical_poses(radius, n_poses=120):
    """Circle of poses looking at the origin from elevation -30deg
    (reference utils/pose_utils.py: create_spherical_poses)."""

    def spheric_pose(theta, phi, radius):
        trans_t = lambda t: np.array([
            [1, 0, 0, 0],
            [0, 1, 0, -0.9 * t],
            [0, 0, 1, t],
            [0, 0, 0, 1],
        ])
        rot_phi = lambda phi: np.array([
            [1, 0, 0, 0],
            [0, np.cos(phi), -np.sin(phi), 0],
            [0, np.sin(phi), np.cos(phi), 0],
            [0, 0, 0, 1],
        ])
        rot_theta = lambda th: np.array([
            [np.cos(th), 0, -np.sin(th), 0],
            [0, 1, 0, 0],
            [np.sin(th), 0, np.cos(th), 0],
            [0, 0, 0, 1],
        ])
        c2w = rot_theta(theta) @ rot_phi(phi) @ trans_t(radius)
        c2w = np.array([[-1, 0, 0, 0], [0, 0, 1, 0],
                        [0, 1, 0, 0], [0, 0, 0, 1]]) @ c2w
        return c2w[:3]

    return np.stack([
        spheric_pose(th, -np.pi / 6, radius)
        for th in np.linspace(0, 2 * np.pi, n_poses + 1)[:-1]
    ], 0)


def interpolate_poses(poses, n_out):
    """Piecewise-linear position + slerp-free orientation interpolation along
    a pose sequence (reference utils/pose_utils.py: interpolate_poses —
    linear blend + re-orthogonalization)."""
    poses = np.asarray(poses)
    n_in = len(poses)
    out = []
    for t in np.linspace(0, n_in - 1, n_out):
        i0 = int(np.floor(t))
        i1 = min(i0 + 1, n_in - 1)
        a = t - i0
        blend = (1 - a) * poses[i0] + a * poses[i1]
        z = normalize(blend[:, 2])
        y_ = blend[:, 1]
        x = normalize(np.cross(y_, z))
        y = np.cross(z, x)
        out.append(np.stack([x, y, z, blend[:, 3]], 1))
    return np.stack(out, 0)
