"""SO(3) / SE(3) utilities, quaternion rotation averaging, frame conversions.

Pure-JAX, jit/vmap-safe re-implementations of the geometry helpers the
reference scatters across scripts:

  * Rodrigues both ways        (cv2.Rodrigues call sites everywhere)
  * R<->quaternion + weighted hemisphere-aligned averaging
                               (mpa_final_view_with_export.py:219-243)
  * Euler ZYX builder          (final_view_with_cad.py:128-136)
  * OpenCV<->Open3D frame flip (vis_tool_solvepnp.py:22,83-92)
  * 180-deg Z flip correction  (april_tag_bg_removal_pl.py:145-160,
                                mpa_final_view_with_export.py:325-335)
  * 4x4 transform builders with provenance semantics
                               (mpa_icp_export.py:88-107)

Everything is dtype-polymorphic and batched with vmap where useful.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-12


# ---------------------------------------------------------------------------
# Rodrigues
# ---------------------------------------------------------------------------

def skew(v: jnp.ndarray) -> jnp.ndarray:
    """Skew-symmetric cross-product matrix of a 3-vector."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = jnp.zeros_like(x)
    return jnp.stack([
        jnp.stack([zero, -z, y], axis=-1),
        jnp.stack([z, zero, -x], axis=-1),
        jnp.stack([-y, x, zero], axis=-1),
    ], axis=-2)


def rodrigues(rvec: jnp.ndarray) -> jnp.ndarray:
    """Axis-angle vector -> rotation matrix. Safe at theta -> 0.

    R = I + sin(t)/t K + (1-cos(t))/t^2 K^2 with K = skew(rvec).
    """
    rvec = jnp.asarray(rvec)
    theta2 = jnp.sum(rvec * rvec, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS)
    # Taylor-safe coefficients
    small = theta2 < 1e-10
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2)
    K = skew(rvec)
    I = jnp.eye(3, dtype=rvec.dtype)
    # skew(r)^2 == r r^T - |r|^2 I exactly; outer product avoids a matmul
    outer = rvec[..., :, None] * rvec[..., None, :]
    K2 = outer - theta2[..., None, None] * I
    return I + a[..., None, None] * K + b[..., None, None] * K2


def rodrigues_inv(R: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix -> axis-angle vector. Handles theta near 0 and pi."""
    R = jnp.asarray(R)
    tr = jnp.clip((jnp.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    theta = jnp.arccos(tr)
    # generic: axis from skew part
    w = jnp.stack([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    sin_t = jnp.sin(theta)
    generic = w * (theta / (2.0 * sin_t + _EPS))
    # small angle: w/2 (first order)
    small = w * 0.5
    # theta ~ pi: axis from diagonal of (R + I)/2
    B = (R + jnp.eye(3, dtype=R.dtype)) / 2.0
    axis2 = jnp.clip(jnp.diagonal(B), 0.0, None)
    axis = jnp.sqrt(axis2 + _EPS)
    # fix signs using off-diagonals, anchored on the largest axis component
    i = jnp.argmax(axis2)
    sgn_col = jnp.sign(B[i, :] + _EPS)
    axis_pi = axis * sgn_col * jnp.sign(axis[i] + _EPS)
    axis_pi = axis_pi / (jnp.linalg.norm(axis_pi) + _EPS)
    near_pi = theta > (jnp.pi - 1e-3)
    near_0 = theta < 1e-5
    return jnp.where(near_0, small,
                     jnp.where(near_pi, axis_pi * theta, generic))


# ---------------------------------------------------------------------------
# Quaternions  (w, x, y, z) — matching the reference convention
# ---------------------------------------------------------------------------

def R_to_quat(R: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix -> unit quaternion (w,x,y,z), w >= 0 branch-stable.

    Shepperd's method (branch-free via where), equivalent to the reference's
    Rodrigues-based R_to_quat (mpa_final_view_with_export.py:219-224) up to
    global sign.
    """
    R = jnp.asarray(R)
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    # four candidate formulations; pick numerically-safest
    q0 = jnp.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], axis=-1)
    q1 = jnp.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20],
                   axis=-1)
    q2 = jnp.stack([m02 - m20, m01 + m10, 1.0 + m11 - m00 - m22, m12 + m21],
                   axis=-1)
    q3 = jnp.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 + m22 - m00 - m11],
                   axis=-1)
    vals = jnp.stack([1.0 + tr, 1.0 + m00 - m11 - m22,
                      1.0 + m11 - m00 - m22, 1.0 + m22 - m00 - m11], axis=-1)
    idx = jnp.argmax(vals, axis=-1)
    q = jnp.select(
        [idx == 0, idx == 1, idx == 2],
        [q0, q1, q2],
        q3,
    )
    q = q / (jnp.linalg.norm(q, axis=-1, keepdims=True) + _EPS)
    # canonicalize sign: w >= 0
    return q * jnp.where(q[..., :1] < 0, -1.0, 1.0)


def quat_to_R(q: jnp.ndarray) -> jnp.ndarray:
    """Unit quaternion (w,x,y,z) -> rotation matrix
    (mpa_final_view_with_export.py:226-233)."""
    q = q / (jnp.linalg.norm(q, axis=-1, keepdims=True) + _EPS)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return jnp.stack([
        jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                   2 * (x * z + y * w)], axis=-1),
        jnp.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                   2 * (y * z - x * w)], axis=-1),
        jnp.stack([2 * (x * z - y * w), 2 * (y * z + x * w),
                   1 - 2 * (x * x + y * y)], axis=-1),
    ], axis=-2)


def quat_multiply(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return jnp.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], axis=-1)


def average_rotations_quat(Rs: jnp.ndarray, weights: jnp.ndarray,
                           mask: jnp.ndarray | None = None) -> jnp.ndarray:
    """Weighted quaternion averaging with hemisphere alignment.

    Re-implements average_rotations_quat
    (mpa_final_view_with_export.py:235-243): clip weights to >=1e-6,
    normalize, align all quaternions to the first (valid) one's hemisphere,
    weighted sum, renormalize.

    Rs: (N,3,3); weights: (N,); mask: optional (N,) bool of valid entries.
    """
    Rs = jnp.asarray(Rs)
    n = Rs.shape[0]
    w = jnp.clip(jnp.asarray(weights, dtype=Rs.dtype), 1e-6, None)
    if mask is not None:
        w = jnp.where(mask, w, 0.0)
    w = w / (jnp.sum(w) + _EPS)
    Q = jax.vmap(R_to_quat)(Rs)  # (N,4)
    # Masked slots may carry degenerate rotations (e.g. NaN from a singular
    # PnP solve on an empty detection slot); 0-weight alone doesn't stop
    # 0*NaN=NaN from poisoning the weighted sum — zero the quats themselves.
    finite = jnp.all(jnp.isfinite(Q), axis=-1)
    keep = finite if mask is None else (finite & mask)
    Q = jnp.where(keep[:, None], Q, 0.0)
    w = jnp.where(keep, w, 0.0)
    first = jnp.argmax(keep.astype(jnp.int32))
    q_ref = Q[first]
    sign = jnp.where(jnp.sum(Q * q_ref, axis=-1, keepdims=True) < 0, -1.0, 1.0)
    Q = Q * sign
    q_avg = jnp.sum(w[:, None] * Q, axis=0)
    q_avg = q_avg / (jnp.linalg.norm(q_avg) + _EPS)
    return quat_to_R(q_avg)


# ---------------------------------------------------------------------------
# Euler
# ---------------------------------------------------------------------------

def euler_zyx_to_R(z_deg, y_deg, x_deg) -> jnp.ndarray:
    """R = Rz @ Ry @ Rx from degrees (final_view_with_cad.py:128-136)."""
    z, y, x = (jnp.deg2rad(jnp.asarray(a, dtype=jnp.float32))
               for a in (z_deg, y_deg, x_deg))
    cz, sz = jnp.cos(z), jnp.sin(z)
    cy, sy = jnp.cos(y), jnp.sin(y)
    cx, sx = jnp.cos(x), jnp.sin(x)
    one = jnp.ones_like(cz)
    zero = jnp.zeros_like(cz)
    Rz = jnp.stack([jnp.stack([cz, -sz, zero], -1),
                    jnp.stack([sz, cz, zero], -1),
                    jnp.stack([zero, zero, one], -1)], -2)
    Ry = jnp.stack([jnp.stack([cy, zero, sy], -1),
                    jnp.stack([zero, one, zero], -1),
                    jnp.stack([-sy, zero, cy], -1)], -2)
    Rx = jnp.stack([jnp.stack([one, zero, zero], -1),
                    jnp.stack([zero, cx, -sx], -1),
                    jnp.stack([zero, sx, cx], -1)], -2)
    return Rz @ Ry @ Rx


def R_to_euler_zyx(R: jnp.ndarray):
    """Rotation matrix -> (z,y,x) degrees, ZYX convention
    (april_tag_2D_viz.py:22-40)."""
    sy = -R[..., 2, 0]
    sy = jnp.clip(sy, -1.0, 1.0)
    y = jnp.arcsin(sy)
    z = jnp.arctan2(R[..., 1, 0], R[..., 0, 0])
    x = jnp.arctan2(R[..., 2, 1], R[..., 2, 2])
    return jnp.rad2deg(z), jnp.rad2deg(y), jnp.rad2deg(x)


# ---------------------------------------------------------------------------
# SE(3) 4x4 builders (provenance contract from mpa_icp_export.py:88-107)
# ---------------------------------------------------------------------------

def make_T(R: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    R = jnp.asarray(R)
    t = jnp.asarray(t)
    T = jnp.eye(4, dtype=R.dtype)
    T = T.at[:3, :3].set(R)
    T = T.at[:3, 3].set(t)
    return T


def T_translate(t) -> jnp.ndarray:
    t = jnp.asarray(t, dtype=jnp.float32) if not hasattr(t, "dtype") else jnp.asarray(t)
    return make_T(jnp.eye(3, dtype=t.dtype), t)


def T_rotate_about_point(R, p) -> jnp.ndarray:
    """Rotate by R about fixed point p: x -> R (x - p) + p."""
    R = jnp.asarray(R)
    p = jnp.asarray(p, dtype=R.dtype)
    return make_T(R, p - R @ p)


def T_scale_about_point(s, p) -> jnp.ndarray:
    """Uniform scale s about fixed point p: x -> s (x - p) + p."""
    p = jnp.asarray(p)
    s = jnp.asarray(s, dtype=p.dtype)
    T = jnp.eye(4, dtype=p.dtype) * s
    T = T.at[3, 3].set(1.0)
    T = T.at[:3, 3].set(p - s * p)
    return T


def apply_T(T: jnp.ndarray, pts: jnp.ndarray) -> jnp.ndarray:
    """Apply 4x4 transform to (...,3) points."""
    return pts @ T[:3, :3].T + T[:3, 3]


def invert_T(T: jnp.ndarray) -> jnp.ndarray:
    R = T[:3, :3]
    t = T[:3, 3]
    Rt = R.T
    return make_T(Rt, -Rt @ t)


# ---------------------------------------------------------------------------
# Frame conventions
# ---------------------------------------------------------------------------

# OpenCV camera frame (x right, y down, z forward) <-> Open3D viewer frame
# (x right, y up, z backward): S = diag(1,-1,-1)  (vis_tool_solvepnp.py:22)
_S_CV_O3D = jnp.diag(jnp.array([1.0, -1.0, -1.0]))


def cv_to_o3d_R(R: jnp.ndarray) -> jnp.ndarray:
    S = _S_CV_O3D.astype(R.dtype)
    return S @ R @ S


def cv_to_o3d_t(t: jnp.ndarray) -> jnp.ndarray:
    return jnp.asarray(t) * jnp.array([1.0, -1.0, -1.0], dtype=jnp.asarray(t).dtype)


def flip_z_180(R: jnp.ndarray) -> jnp.ndarray:
    """Apply the 180-deg Z rotation correction R @ diag(-1,-1,1)
    (tag-9 fix, mpa_final_view_with_export.py:328-333)."""
    F = jnp.diag(jnp.array([-1.0, -1.0, 1.0], dtype=R.dtype))
    return R @ F


def tag_local_to_camera(p_local: jnp.ndarray, R: jnp.ndarray,
                        t: jnp.ndarray) -> jnp.ndarray:
    """Transform a point from tag-local to camera frame
    (april_tag_bg_removal_pl.py:177-187)."""
    return jnp.asarray(p_local) @ R.T + t


def rotation_angle_deg(Ra: jnp.ndarray, Rb: jnp.ndarray) -> jnp.ndarray:
    """Geodesic angle between two rotations in degrees."""
    Rrel = Ra.T @ Rb
    c = jnp.clip((jnp.trace(Rrel) - 1.0) / 2.0, -1.0, 1.0)
    return jnp.rad2deg(jnp.arccos(c))


def is_valid_transform(T, tol: float = 1e-6):
    """det(R) ~ 1 and R R^T ~ I  (export_6dof.py validation)."""
    R = jnp.asarray(T)[:3, :3]
    det_ok = jnp.abs(jnp.linalg.det(R) - 1.0) < 1e-3
    ortho = jnp.linalg.norm(R @ R.T - jnp.eye(3, dtype=R.dtype))
    return jnp.logical_and(det_ok, ortho < 1e-3), ortho


def homography_from_unit_square(quad: jnp.ndarray) -> jnp.ndarray:
    """Exact homography mapping the canonical square TL=(-1,-1),
    TR=(1,-1), BR=(1,1), BL=(-1,1) onto the 4 points `quad` (4,2), in
    that order; normalized to H33 = 1.

    Closed form (projective bilinear interpolation over the unit square,
    composed with the [-1,1]^2 -> [0,1]^2 affine), NOT a linear solve:
    jnp.linalg.solve's 8x8 LU emits pivot-selection gathers on every
    elimination step — a serialized chain — while this is ~25 fused
    elementwise ops. Exact to fp rounding (validated against the
    solve on random quads)."""
    x0, y0 = quad[0, 0], quad[0, 1]
    x1, y1 = quad[1, 0], quad[1, 1]
    x2, y2 = quad[2, 0], quad[2, 1]
    x3, y3 = quad[3, 0], quad[3, 1]
    sx = x0 - x1 + x2 - x3
    sy = y0 - y1 + y2 - y3
    dx1 = x1 - x2
    dx2 = x3 - x2
    dy1 = y1 - y2
    dy2 = y3 - y2
    den = dx1 * dy2 - dx2 * dy1
    den = jnp.where(jnp.abs(den) < 1e-12, 1e-12, den)
    g = (sx * dy2 - dx2 * sy) / den
    h = (dx1 * sy - sx * dy1) / den
    a = x1 - x0 + g * x1
    b = x3 - x0 + h * x3
    d = y1 - y0 + g * y1
    e = y3 - y0 + h * y3
    # compose with (x,y) -> ((x+1)/2, (y+1)/2)
    H = jnp.stack([
        jnp.stack([0.5 * a, 0.5 * b, 0.5 * (a + b) + x0]),
        jnp.stack([0.5 * d, 0.5 * e, 0.5 * (d + e) + y0]),
        jnp.stack([0.5 * g, 0.5 * h, 0.5 * (g + h) + 1.0]),
    ])
    w = H[2, 2]
    w = jnp.where(jnp.abs(w) < 1e-12, 1e-12, w)
    return H / w
