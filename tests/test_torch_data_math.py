"""The port's rotation, pose and ray math (hyperreel_tpu_torch/ops/
rotation.py, pose_math.py, ray_math.py) against the JAX package's on
seeded inputs. The pose and ray math is numpy in both packages, the same
operations in the same order: equal to the bit. The rotations are jnp
(XLA on the CPU) against torch: f32 within 1e-6 (a few ulps of a value
near 1; XLA and torch evaluate sin, cos and sqrt by other routines)."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from hyperreel_tpu.ops import pose_math as JPM
from hyperreel_tpu.ops import ray_math as JRM
from hyperreel_tpu.ops import rotation as JR
from hyperreel_tpu_torch.ops import pose_math as TPM
from hyperreel_tpu_torch.ops import ray_math as TRM
from hyperreel_tpu_torch.ops import rotation as TR

ROT_TOL = 1e-6


def _rotvecs(rng, n=64):
    v = rng.normal(0, 1.0, (n, 3)).astype(np.float32)
    v[:4] = 0.0                        # the zero angle
    v[4:8] *= 1e-7                     # below the small-angle threshold
    return v


def _quats(rng, n=64):
    return rng.normal(0, 1.0, (n, 4)).astype(np.float32)


@pytest.mark.parametrize("fn,make", [
    ("axis_angle_to_matrix", _rotvecs),
    ("quaternion_to_matrix", _quats),
])
def test_rotation_matrices_match_jax(fn, make):
    x = make(np.random.default_rng(0))
    want = np.asarray(getattr(JR, fn)(jnp.asarray(x)))
    got = getattr(TR, fn)(torch.from_numpy(x)).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=ROT_TOL)


def test_quaternion_apply_and_matrix_to_quaternion_match_jax():
    rng = np.random.default_rng(1)
    q = _quats(rng)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    v = rng.normal(0, 1.0, (64, 3)).astype(np.float32)
    want = np.asarray(JR.quaternion_apply(jnp.asarray(q), jnp.asarray(v)))
    got = TR.quaternion_apply(torch.from_numpy(q), torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=4 * ROT_TOL)
    R = np.array(JR.axis_angle_to_matrix(jnp.asarray(_rotvecs(rng))))
    want = np.asarray(JR.matrix_to_quaternion(jnp.asarray(R)))
    got = TR.matrix_to_quaternion(torch.from_numpy(R)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ROT_TOL)
    # the matrix of the quaternion is the matrix it came from
    back = TR.quaternion_to_matrix(torch.from_numpy(got)).numpy()
    np.testing.assert_allclose(back, R, rtol=0, atol=1e-5)


def _poses(rng, n=7):
    p = np.tile(np.eye(4)[:3], (n, 1, 1))
    p[:, :, :3] += rng.normal(0, 0.05, (n, 3, 3))
    p[:, :, 3] = rng.normal(0, 0.5, (n, 3))
    return p


def test_pose_math_equals_jax():
    rng = np.random.default_rng(2)
    poses, bounds = _poses(rng), rng.uniform(1.0, 8.0, (7, 2))
    for fn, args in (
            ("normalize", (rng.normal(size=3),)),
            ("average_poses", (poses,)),
            ("viewmatrix", (rng.normal(size=3), rng.normal(size=3),
                            rng.normal(size=3))),
            ("create_spiral_poses", (poses, [0.3, 0.2, 0.1], 2.5, 9)),
            ("create_spiral_poses", (poses, [0.3, 0.2, 0.1], 2.5, 9, True)),
            ("create_spherical_poses", (3.0, 11)),
            ("interpolate_poses", (poses, 13))):
        np.testing.assert_array_equal(getattr(TPM, fn)(*args),
                                      getattr(JPM, fn)(*args), err_msg=fn)
    for a, b in zip(TPM.center_poses(poses), JPM.center_poses(poses)):
        np.testing.assert_array_equal(a, b)
    for kw in ({}, {"flip": False}, {"center": False}):
        for a, b in zip(TPM.correct_poses_bounds(poses, bounds, **kw),
                        JPM.correct_poses_bounds(poses, bounds, **kw)):
            np.testing.assert_array_equal(a, b, err_msg=str(kw))


def test_ray_math_equals_jax():
    rng = np.random.default_rng(3)
    K = [[30.0, 0, 16.5], [0, 31.0, 12.0], [0, 0, 1]]
    for kw in ({}, {"centered_pixels": True}, {"flipped": True}):
        np.testing.assert_array_equal(
            TRM.get_ray_directions_K(24, 32, K, **kw),
            JRM.get_ray_directions_K(24, 32, K, **kw))
    dirs = TRM.get_ray_directions_K(24, 32, K, centered_pixels=True)
    c2w = _poses(rng, 1)[0]
    for normalize in (True, False):
        for a, b in zip(TRM.get_rays(dirs, c2w, normalize),
                        JRM.get_rays(dirs, c2w, normalize)):
            np.testing.assert_array_equal(a, b)
    rays = np.concatenate(TRM.get_rays(dirs, c2w), -1).astype(np.float32)
    rays[:, 2] -= 2.0                  # in front of the near plane
    np.testing.assert_array_equal(
        TRM.get_ndc_rays_fx_fy(24, 32, 30.0, 31.0, 0.8, rays),
        JRM.get_ndc_rays_fx_fy(24, 32, 30.0, 31.0, 0.8, rays))
    for (n0, n1, a, b, aspect), kw in (
            ((16, 12, 0.3, -0.2, 16 / 12), {}),
            ((9, 7, -1.0, 1.0, 1.5),
             dict(st_scale=0.25, uv_scale=2.0, near=-2.0, far=0.5))):
        # (U, V, s, t) and (U, v, S, t)
        np.testing.assert_array_equal(
            TRM.get_lightfield_rays(n0, n1, a, b, aspect, **kw),
            JRM.get_lightfield_rays(n0, n1, a, b, aspect, **kw))
        np.testing.assert_array_equal(
            TRM.get_epi_rays(n0, a, n1, b, aspect, **kw),
            JRM.get_epi_rays(n0, a, n1, b, aspect, **kw))
    jitter = rays + rng.normal(0, 0.01, rays.shape).astype(np.float32)
    np.testing.assert_array_equal(TRM.get_weight_map(rays, jitter, 3.0),
                                  JRM.get_weight_map(rays, jitter, 3.0))
