"""SE(2) geometry on batched (..., 3) pose arrays (x, y, theta).

The reference carries Eigen::Affine3d everywhere but is effectively 2D
(force2D at ndt_feature_graph.cpp:518-525; robust yaw extraction at
utils.h:30-40).  Here SE(2) is native; the SE(3) lift lives only at the
I/O edges (`to_matrix4`, `to_tum`).

All functions are pure, broadcast over leading dims, and jit/vmap-safe.
"""

from __future__ import annotations

import jax.numpy as jnp


def normalize_angle(a):
    """Wrap angle(s) to (-pi, pi]."""
    return jnp.arctan2(jnp.sin(a), jnp.cos(a))


def identity(shape=(), dtype=jnp.float32):
    return jnp.zeros(shape + (3,), dtype)


def rotmat(theta):
    """(...,) -> (..., 2, 2) rotation matrices."""
    c, s = jnp.cos(theta), jnp.sin(theta)
    return jnp.stack(
        [jnp.stack([c, -s], -1), jnp.stack([s, c], -1)], -2
    )


def compose(a, b):
    """a ∘ b: apply b in the frame of a (reference addPose2d,
    motion_model.cpp:5-12)."""
    ca, sa = jnp.cos(a[..., 2]), jnp.sin(a[..., 2])
    x = a[..., 0] + b[..., 0] * ca - b[..., 1] * sa
    y = a[..., 1] + b[..., 0] * sa + b[..., 1] * ca
    t = normalize_angle(a[..., 2] + b[..., 2])
    return jnp.stack([x, y, t], -1)


def compose_np(a, b):
    """Host-side numpy compose (identical math to `compose`).  Used by
    host orchestration loops: every eager device op is a dispatch and
    a sync, so per-scan host bookkeeping never touches the device."""
    import numpy as np

    ca, sa = np.cos(a[..., 2]), np.sin(a[..., 2])
    x = a[..., 0] + b[..., 0] * ca - b[..., 1] * sa
    y = a[..., 1] + b[..., 0] * sa + b[..., 1] * ca
    t = a[..., 2] + b[..., 2]
    t = np.arctan2(np.sin(t), np.cos(t))
    return np.stack([x, y, t], -1).astype(np.float32)


def inverse(a):
    ca, sa = jnp.cos(a[..., 2]), jnp.sin(a[..., 2])
    x = -(a[..., 0] * ca + a[..., 1] * sa)
    y = -(-a[..., 0] * sa + a[..., 1] * ca)
    return jnp.stack([x, y, -a[..., 2]], -1)


def sub(origin, pose):
    """Relative pose of `pose` expressed in `origin`'s frame, i.e.
    inverse(origin) ∘ pose (reference subPose2d, motion_model.cpp:14-23)."""
    co, so = jnp.cos(origin[..., 2]), jnp.sin(origin[..., 2])
    dx = pose[..., 0] - origin[..., 0]
    dy = pose[..., 1] - origin[..., 1]
    x = dx * co + dy * so
    y = -dx * so + dy * co
    t = normalize_angle(pose[..., 2] - origin[..., 2])
    return jnp.stack([x, y, t], -1)


# The rotations below are written out elementwise rather than as
# einsums: on the GPU an f32 einsum at default precision runs in TF32
# (10 mantissa bits), which moved scan points by centimetres and broke
# the registration derivatives (chip_smoke.py registration phase).


def transform_points(pose, pts):
    """Apply pose (..., 3) to points (..., P, 2)."""
    c = jnp.cos(pose[..., 2])[..., None]
    s = jnp.sin(pose[..., 2])[..., None]
    x, y = pts[..., 0], pts[..., 1]
    return jnp.stack(
        [c * x - s * y + pose[..., None, 0],
         s * x + c * y + pose[..., None, 1]],
        -1,
    )


def rotate_covs(theta, covs):
    """R Sigma R^T for (..., P, 2, 2) covariances, theta (...)."""
    c = jnp.cos(theta)[..., None]
    s = jnp.sin(theta)[..., None]
    a, b = covs[..., 0, 0], covs[..., 0, 1]
    e, d = covs[..., 1, 0], covs[..., 1, 1]
    m00, m01 = c * a - s * e, c * b - s * d          # M = R Sigma
    m10, m11 = s * a + c * e, s * b + c * d
    return jnp.stack(
        [jnp.stack([m00 * c - m01 * s, m00 * s + m01 * c], -1),
         jnp.stack([m10 * c - m11 * s, m10 * s + m11 * c], -1)],
        -2,
    )


def adjoint(pose):
    """Adjoint of SE(2): maps local twists to global twists, (..., 3, 3)."""
    c, s = jnp.cos(pose[..., 2]), jnp.sin(pose[..., 2])
    x, y = pose[..., 0], pose[..., 1]
    z = jnp.zeros_like(c)
    o = jnp.ones_like(c)
    row0 = jnp.stack([c, -s, y], -1)
    row1 = jnp.stack([s, c, -x], -1)
    row2 = jnp.stack([z, z, o], -1)
    return jnp.stack([row0, row1, row2], -2)


def to_matrix3(pose):
    """(..., 3) -> (..., 3, 3) homogeneous 2D transform."""
    c, s = jnp.cos(pose[..., 2]), jnp.sin(pose[..., 2])
    z = jnp.zeros_like(c)
    o = jnp.ones_like(c)
    row0 = jnp.stack([c, -s, pose[..., 0]], -1)
    row1 = jnp.stack([s, c, pose[..., 1]], -1)
    row2 = jnp.stack([z, z, o], -1)
    return jnp.stack([row0, row1, row2], -2)


def from_matrix3(m):
    theta = jnp.arctan2(m[..., 1, 0], m[..., 0, 0])
    return jnp.stack([m[..., 0, 2], m[..., 1, 2], theta], -1)


def to_matrix4(pose):
    """SE(3) lift: (..., 3) -> (..., 4, 4)."""
    m3 = to_matrix3(pose)
    batch = pose.shape[:-1]
    m = jnp.zeros(batch + (4, 4), pose.dtype)
    m = m.at[..., :2, :2].set(m3[..., :2, :2])
    m = m.at[..., :2, 3].set(m3[..., :2, 2])
    m = m.at[..., 2, 2].set(1.0)
    m = m.at[..., 3, 3].set(1.0)
    return m


def from_matrix4(m):
    """Robust SE(2) extraction from a 4x4 transform: yaw from the rotated
    x-axis (reference getRobustYawFromAffine3d, utils.h:30-40 — dot
    product, not Euler angles)."""
    theta = jnp.arctan2(m[..., 1, 0], m[..., 0, 0])
    return jnp.stack([m[..., 0, 3], m[..., 1, 3], theta], -1)


def to_tum(t, pose):
    """TUM-format row `t x y z qx qy qz qw` (utils.h:243-259 semantics;
    quaternion from yaw only, motion_model.cpp getQuaterion)."""
    half = pose[..., 2] * 0.5
    qz, qw = jnp.sin(half), jnp.cos(half)
    z = jnp.zeros_like(qw)
    return jnp.stack(
        [t, pose[..., 0], pose[..., 1], z, z, z, qz, qw], -1
    )


def dist(a, b):
    return jnp.linalg.norm(a[..., :2] - b[..., :2], axis=-1)


def angular_dist(a, b):
    return normalize_angle(a[..., 2] - b[..., 2])
