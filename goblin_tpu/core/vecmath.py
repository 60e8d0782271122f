"""Batched vector / quaternion / transform math.

Conventions follow the reference renderer so that scene files render
identically (reference: src/GoblinVector.h, src/GoblinQuaternion.cpp,
src/GoblinMatrix.cpp, src/GoblinTransform.cpp):

- vectors are arrays with a trailing axis of size 2/3/4; all ops broadcast
- quaternions are (..., 4) in (w, x, y, z) order
- rotation matrices are row-major, applied as ``M @ v``
- the camera/projection stack is left-handed, D3D-style NDC (z in [0, 1]):
  ``matrixPerspectiveLHD3D`` / ``matrixOrthoLHD3D`` (reference
  src/GoblinMatrix.cpp:631-642, :674-682)
- ``coordinate_system`` matches reference ``coordinateAxises``
  (src/GoblinUtils.cpp:58-70)

Everything here is plain jnp, differentiable, and jit/vmap friendly.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

INV_PI = 1.0 / np.pi
TWO_PI = 2.0 * np.pi
INV_TWO_PI = 1.0 / (2.0 * np.pi)


def dot(a, b):
    """Batched dot product over the trailing axis, keeping dims collapsed."""
    return jnp.sum(a * b, axis=-1)


def dotn(a, b):
    """Batched dot product, keepdims=True (handy for broadcasting)."""
    return jnp.sum(a * b, axis=-1, keepdims=True)


def absdot(a, b):
    return jnp.abs(dot(a, b))


def cross(a, b):
    return jnp.cross(a, b)


def length(a):
    return jnp.sqrt(jnp.sum(a * a, axis=-1))


def squared_length(a):
    return jnp.sum(a * a, axis=-1)


def normalize(a, eps=0.0):
    """Normalize over the trailing axis. eps guards 0-length (returns 0s)."""
    sq = jnp.sum(a * a, axis=-1, keepdims=True)
    if eps > 0.0:
        return a * jnp.where(sq > eps, 1.0 / jnp.sqrt(jnp.maximum(sq, eps)), 0.0)
    return a / jnp.sqrt(sq)


def safe_normalize(a):
    return normalize(a, eps=1e-30)


def lerp(t, a, b):
    return a + t * (b - a)


def reflect(w, n):
    """Mirror w about n (both pointing away from surface)."""
    return 2.0 * dotn(w, n) * n - w


def face_forward(n, v):
    """Flip n so it lies in the same hemisphere as v."""
    return jnp.where(dotn(n, v) < 0.0, -n, n)


def coordinate_system(a1):
    """Build an orthonormal frame (a1, a2, a3) from unit vector a1.

    Matches reference ``coordinateAxises`` (src/GoblinUtils.cpp:58-70):
    branch on |x| > |y|, a3 = cross(a1, a2).
    """
    x, y, z = a1[..., 0], a1[..., 1], a1[..., 2]
    cond = jnp.abs(x) > jnp.abs(y)
    inv_a = 1.0 / jnp.sqrt(jnp.maximum(x * x + z * z, 1e-30))
    a2_a = jnp.stack([-z * inv_a, jnp.zeros_like(x), x * inv_a], axis=-1)
    inv_b = 1.0 / jnp.sqrt(jnp.maximum(y * y + z * z, 1e-30))
    a2_b = jnp.stack([jnp.zeros_like(x), -z * inv_b, y * inv_b], axis=-1)
    a2 = jnp.where(cond[..., None], a2_a, a2_b)
    a3 = cross(a1, a2)
    return a2, a3


def spherical_direction(sin_theta, cos_theta, phi):
    return jnp.stack(
        [sin_theta * jnp.cos(phi), sin_theta * jnp.sin(phi), cos_theta], axis=-1
    )


def spherical_theta(v):
    return jnp.arccos(jnp.clip(v[..., 2], -1.0, 1.0))


def spherical_phi(v):
    """phi in [0, 2pi) (reference src/GoblinUtils.h sphericalPhi)."""
    p = jnp.arctan2(v[..., 1], v[..., 0])
    return jnp.where(p < 0.0, p + TWO_PI, p)


# ---------------------------------------------------------------------------
# Quaternions: (..., 4) wxyz
# ---------------------------------------------------------------------------


def quat_identity():
    return jnp.array([1.0, 0.0, 0.0, 0.0], dtype=jnp.float32)


def quat_from_axis_angle(axis, angle):
    """Unit quaternion rotating by `angle` (radians) about unit `axis`."""
    axis = jnp.asarray(axis, dtype=jnp.float32)
    angle = jnp.asarray(angle, dtype=jnp.float32)
    half = 0.5 * angle
    w = jnp.cos(half)
    xyz = jnp.sin(half)[..., None] * axis
    return jnp.concatenate([w[..., None], xyz], axis=-1)


def quat_mul(q1, q2):
    """Hamilton product q1 * q2 (apply q2's rotation first)."""
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return jnp.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        axis=-1,
    )


def quat_rotate(q, v):
    """Rotate vector(s) v by quaternion(s) q."""
    qv = q[..., 1:]
    w = q[..., 0:1]
    t = 2.0 * jnp.cross(qv, v)
    return v + w * t + jnp.cross(qv, t)


def quat_to_matrix(q):
    """(..., 4) wxyz -> (..., 3, 3) rotation matrix (row-major, M @ v).

    Matches reference Quaternion::toMatrix (src/GoblinQuaternion.cpp:55-75).
    """
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    x2, y2, z2 = 2 * x, 2 * y, 2 * z
    xx2, yy2, zz2 = x2 * x, y2 * y, z2 * z
    xy2, xz2, yz2 = x2 * y, x2 * z, y2 * z
    xw2, yw2, zw2 = x2 * w, y2 * w, z2 * w
    one = jnp.ones_like(w)
    rows = [
        jnp.stack([one - yy2 - zz2, xy2 - zw2, xz2 + yw2], axis=-1),
        jnp.stack([xy2 + zw2, one - xx2 - zz2, yz2 - xw2], axis=-1),
        jnp.stack([xz2 - yw2, yz2 + xw2, one - xx2 - yy2], axis=-1),
    ]
    return jnp.stack(rows, axis=-2)


_EULER_ORDERS = ("xyz", "xzy", "yxz", "yzx", "zxy", "zyx")


def euler_to_quat(xyz_degrees, order="xyz"):
    """Euler angles (degrees, per-axis) -> quaternion.

    Order "abc" means rotation a is applied first: q = qc * qb * qa
    (reference eulerToQuaternion, src/GoblinQuaternion.cpp:124-145).
    Host-side helper (python branch on order string).
    """
    xyz = jnp.asarray(xyz_degrees, dtype=jnp.float32) * (np.pi / 180.0)
    qx = quat_from_axis_angle(jnp.array([1.0, 0.0, 0.0]), xyz[..., 0])
    qy = quat_from_axis_angle(jnp.array([0.0, 1.0, 0.0]), xyz[..., 1])
    qz = quat_from_axis_angle(jnp.array([0.0, 0.0, 1.0]), xyz[..., 2])
    named = {"x": qx, "y": qy, "z": qz}
    if order not in _EULER_ORDERS:
        order = "xyz"
    a, b, c = order[0], order[1], order[2]
    return quat_mul(named[c], quat_mul(named[b], named[a]))


# ---------------------------------------------------------------------------
# Transforms (position, quaternion, scale) -> 4x4, applied M @ [v, 1]
#
# Small-matrix application is written as stacked dot products, NOT
# einsum/matmul: XLA would hand a (R,3)x(3,3) contraction to a matrix
# library call, which on a GPU may run in TF32 (wrong precision) and
# costs a launch for a 3-wide op. Elementwise mul+add stays f32 and
# fuses with its neighbours.
# ---------------------------------------------------------------------------


def mat3_apply(m, v):
    """(..., 3, 3) @ (..., 3) -> (..., 3) via elementwise dots."""
    return jnp.stack(
        [
            jnp.sum(m[..., 0, :] * v, axis=-1),
            jnp.sum(m[..., 1, :] * v, axis=-1),
            jnp.sum(m[..., 2, :] * v, axis=-1),
        ],
        axis=-1,
    )


def mat3_apply_t(m, v):
    """Apply transpose: (..., 3, 3)^T @ (..., 3) -> (..., 3)."""
    return (
        m[..., 0, :] * v[..., 0:1]
        + m[..., 1, :] * v[..., 1:2]
        + m[..., 2, :] * v[..., 2:3]
    )


def compose_matrix(position, quat, scale):
    """pos + quat + scale -> 4x4 (reference Transform::getMatrix semantics:
    M = T * R * S, scale applied first)."""
    R = quat_to_matrix(jnp.asarray(quat, dtype=jnp.float32))
    S = jnp.asarray(scale, dtype=jnp.float32)
    RS = R * S[..., None, :]
    p = jnp.asarray(position, dtype=jnp.float32)
    top = jnp.concatenate([RS, p[..., :, None]], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 0.0, 1.0], dtype=jnp.float32), top.shape[:-2] + (1, 4)
    )
    return jnp.concatenate([top, bottom], axis=-2)


def transform_point(m, p):
    """Apply 4x4 m to points (..., 3)."""
    return mat3_apply(m[..., :3, :3], p) + m[..., :3, 3]


def transform_vector(m, v):
    return mat3_apply(m[..., :3, :3], v)


def transform_normal(m_inv, n):
    """Normals transform by the inverse-transpose: n' = (M^-1)^T n."""
    return mat3_apply_t(m_inv[..., :3, :3], n)


def matrix_inverse(m):
    return jnp.linalg.inv(m)


# ---------------------------------------------------------------------------
# Projection matrices (LH, D3D z in [0,1]) — parity with reference screen
# mapping (src/GoblinMatrix.cpp:631-642, :674-682)
# ---------------------------------------------------------------------------


def perspective_lh_d3d(fov_y, aspect, zn, zf):
    """Host-side constructor: returns numpy (safe to build inside jit)."""
    y_scale = 1.0 / np.tan(fov_y / 2.0)
    x_scale = y_scale / aspect
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = x_scale
    m[1, 1] = y_scale
    m[2, 2] = zf / (zf - zn)
    m[2, 3] = -zn * zf / (zf - zn)
    m[3, 2] = 1.0
    return m


def ortho_lh_d3d(w, h, zn, zf):
    """Host-side constructor: returns numpy (safe to build inside jit)."""
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = 2.0 / w
    m[1, 1] = 2.0 / h
    m[2, 2] = 1.0 / (zf - zn)
    m[2, 3] = zn / (zn - zf)
    m[3, 3] = 1.0
    return m


# ---------------------------------------------------------------------------
# Small numeric helpers
# ---------------------------------------------------------------------------


def quadratic(A, B, C):
    """Numerically-stable quadratic roots (reference src/GoblinUtils.cpp:93-113).

    Returns (has_roots, t1, t2) with t1 <= t2; where has_roots is False the
    t values are garbage and must be masked by the caller.
    """
    disc = B * B - 4.0 * A * C
    has = disc >= 0.0
    root = jnp.sqrt(jnp.maximum(disc, 0.0))
    q = jnp.where(B < 0.0, -0.5 * (B - root), -0.5 * (B + root))
    t1 = q / A
    t2 = C / jnp.where(q == 0.0, 1e-30, q)
    lo = jnp.minimum(t1, t2)
    hi = jnp.maximum(t1, t2)
    return has, lo, hi


def solve_2x2(a00, a01, a10, a11, b0, b1):
    """Solve [[a00,a01],[a10,a11]] x = [b0,b1]. Returns (ok, x0, x1)."""
    det = a00 * a11 - a01 * a10
    ok = jnp.abs(det) >= 1e-10
    inv = 1.0 / jnp.where(ok, det, 1.0)
    x0 = (a11 * b0 - a01 * b1) * inv
    x1 = (a00 * b1 - a10 * b0) * inv
    return ok, x0, x1
