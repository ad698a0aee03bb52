"""JAX-native PnP solvers: IPPE-square, SQPnP-style, Gauss-Newton refine.

Replaces the cv2.solvePnP call sites:
  * SOLVEPNP_IPPE_SQUARE   (final_view.py:206-209, solve_pnp_best_order
                            final_view_with_cad.py:177-231)
  * SOLVEPNP_SQPNP         (mpe_final_view_tag_bundle_with_cad.py:278-284)
  * SOLVEPNP_ITERATIVE     (realtime_pose_estimation_april_tag.py:73-76)

Everything is pure JAX (jit/vmap-safe, fixed shapes). The 8-corner-order
search (the reference's signature C3 algorithm) runs as one vmapped batch
with an argmin instead of a Python retry loop.

IPPE derivation (implemented from scratch, following the geometry of
Collins & Bartoli's "Infinitesimal Plane-based Pose Estimation"):
With object plane z=0, normalized-coords homography H, the projection of
the plane origin is v = (H13,H23)/H33 and the map's Jacobian at the origin
is J = (1/t_z) P R[:,:2] with P = [[1,0,-v1],[0,1,-v2]]. Writing
R = R_v Q with R_v e3 = [v;1]/s, P annihilates R_v e3, so
B^{-1} J = (1/t_z) Q[:2,:2] with B = P R_v[:,:2]. For any rotation the
upper 2x2 block has singular values (1, |q33|), giving t_z = 1/sigma1 and
two completions of Q (the planar pose ambiguity) via a signed 2x2 SVD.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from repas_tpu.core.transforms import (homography_from_unit_square,
                                       rodrigues, rodrigues_inv)
from repas_tpu.kernels.project import (project_points, undistort_points)

_EPS = 1e-12


def square_object_points(tag_size_m, dtype=jnp.float32) -> jnp.ndarray:
    """Canonical TL,TR,BR,BL square corners in the tag plane (z=0).

    Matches the object points in solve_pnp_best_order
    (final_view_with_cad.py:191-194): TL=(-h,-h), TR=(h,-h), BR=(h,h),
    BL=(-h,h).
    """
    h = jnp.asarray(tag_size_m, dtype) / 2.0
    return jnp.stack([
        jnp.stack([-h, -h, jnp.zeros_like(h)]),
        jnp.stack([h, -h, jnp.zeros_like(h)]),
        jnp.stack([h, h, jnp.zeros_like(h)]),
        jnp.stack([-h, h, jnp.zeros_like(h)]),
    ])


# The 8 cyclic + reflected corner orderings of C3
# (final_view_with_cad.py:195-204), as permutations of [TL,TR,BR,BL]
SQUARE_ORDERS = np.array([
    [0, 1, 2, 3],
    [1, 2, 3, 0],
    [2, 3, 0, 1],
    [3, 0, 1, 2],
    [1, 0, 3, 2],
    [0, 3, 2, 1],
    [3, 2, 1, 0],
    [2, 1, 0, 3],
], dtype=np.int32)


# ---------------------------------------------------------------------------
# homography (unit square -> normalized image coords)
# ---------------------------------------------------------------------------



def _homography_4pt(obj_xy: jnp.ndarray, img_xy: jnp.ndarray) -> jnp.ndarray:
    """Exact homography from 4 correspondences, H33 = 1 (8x8 solve)."""
    x, y = obj_xy[:, 0], obj_xy[:, 1]
    u, w = img_xy[:, 0], img_xy[:, 1]
    zero = jnp.zeros_like(x)
    one = jnp.ones_like(x)
    rows_u = jnp.stack([x, y, one, zero, zero, zero, -u * x, -u * y], axis=1)
    rows_v = jnp.stack([zero, zero, zero, x, y, one, -w * x, -w * y], axis=1)
    A = jnp.concatenate([rows_u, rows_v], axis=0)       # (8,8)
    b = jnp.concatenate([u, w], axis=0)                 # (8,)
    h = jnp.linalg.solve(A, b)
    return jnp.concatenate([h, jnp.ones((1,), h.dtype)]).reshape(3, 3)


def _svd2x2_signed(A: jnp.ndarray):
    """Proper 2x2 SVD A = U diag(s1, s2) V^T with U,V rotations;
    s1 >= |s2|, sign(s2) = sign(det A)."""
    # closed form via rotation angles
    E = (A[0, 0] + A[1, 1]) / 2.0
    F = (A[0, 0] - A[1, 1]) / 2.0
    G = (A[1, 0] + A[0, 1]) / 2.0
    H = (A[1, 0] - A[0, 1]) / 2.0
    Q = jnp.sqrt(E * E + H * H)
    Rm = jnp.sqrt(F * F + G * G)
    s1 = Q + Rm
    s2 = Q - Rm          # signed: negative iff det(A) < 0
    a1 = jnp.arctan2(G, F)    # = phi + theta
    a2 = jnp.arctan2(H, E)    # = phi - theta
    theta = (a1 - a2) / 2.0   # V angle
    phi = (a1 + a2) / 2.0     # U angle
    cU, sU = jnp.cos(phi), jnp.sin(phi)
    cV, sV = jnp.cos(theta), jnp.sin(theta)
    U = jnp.stack([jnp.stack([cU, -sU]), jnp.stack([sU, cU])])
    V = jnp.stack([jnp.stack([cV, -sV]), jnp.stack([sV, cV])])
    return U, jnp.stack([s1, s2]), V


def _rotation_e3_to(t_hat: jnp.ndarray) -> jnp.ndarray:
    """Rotation taking e3 to unit vector t_hat (safe near e3)."""
    c = t_hat[2]
    axis = jnp.stack([-t_hat[1], t_hat[0], jnp.zeros_like(c)])
    s = jnp.linalg.norm(axis)
    k = axis / jnp.maximum(s, _EPS)
    K = jnp.stack([
        jnp.stack([jnp.zeros_like(c), -k[2], k[1]]),
        jnp.stack([k[2], jnp.zeros_like(c), -k[0]]),
        jnp.stack([-k[1], k[0], jnp.zeros_like(c)]),
    ])
    I = jnp.eye(3, dtype=t_hat.dtype)
    # K is skew of the UNIT axis; s = sin(angle), c = cos(angle)
    R = I + s * K + (1.0 - c) * (K @ K)
    return jnp.where(s < 1e-8, I, R)


def _ippe_from_homography(Hn: jnp.ndarray):
    """Both IPPE pose solutions from a normalized-coords homography of the
    UNIT half-size square. Returns (R (2,3,3), t (2,3))."""
    v = jnp.stack([Hn[0, 2], Hn[1, 2]]) / Hn[2, 2]
    J = (Hn[:2, :2] - v[:, None] * Hn[2, :2][None, :]) / Hn[2, 2]
    s = jnp.sqrt(1.0 + v @ v)
    t_hat = jnp.concatenate([v, jnp.ones((1,), v.dtype)]) / s
    Rv = _rotation_e3_to(t_hat)
    B = Rv[:2, :2] - v[:, None] * Rv[2, :2][None, :]
    # closed-form 2x2 solve (jnp.linalg.solve pays LU pivot gathers)
    detB = B[0, 0] * B[1, 1] - B[0, 1] * B[1, 0]
    detB = jnp.where(jnp.abs(detB) < _EPS, _EPS, detB)
    Binv = jnp.stack([jnp.stack([B[1, 1], -B[0, 1]]),
                      jnp.stack([-B[1, 0], B[0, 0]])]) / detB
    A = Binv @ J
    U, sig, V = _svd2x2_signed(A)
    tz = 1.0 / jnp.maximum(sig[0], _EPS)
    cb = jnp.clip(sig[1] * tz, -1.0, 1.0)     # q33 = cos(beta)
    sb = jnp.sqrt(jnp.maximum(1.0 - cb * cb, 0.0))

    def build(sgn):
        zero = jnp.zeros_like(cb)
        one = jnp.ones_like(cb)
        Rx = jnp.stack([
            jnp.stack([one, zero, zero]),
            jnp.stack([zero, cb, -sgn * sb]),
            jnp.stack([zero, sgn * sb, cb]),
        ])
        Uf = jnp.eye(3, dtype=A.dtype).at[:2, :2].set(U)
        Vf = jnp.eye(3, dtype=A.dtype).at[:2, :2].set(V)
        Q = Uf @ Rx @ Vf.T
        R = Rv @ Q
        t = tz * jnp.concatenate([v, jnp.ones((1,), v.dtype)])
        return R, t

    R1, t1 = build(jnp.asarray(1.0, A.dtype))
    R2, t2 = build(jnp.asarray(-1.0, A.dtype))
    return jnp.stack([R1, R2]), jnp.stack([t1, t2])


@functools.partial(jax.jit, static_argnames=("refine_iters",))
def solve_pnp_ippe_square(img_corners: jnp.ndarray, K, dist, tag_size_m,
                          refine_iters: int = 8):
    """IPPE_SQUARE: 4 pixel corners (TL,TR,BR,BL object order) -> pose.

    Returns (R (3,3), t (3,), reproj_err_px). Both analytic solutions are
    GN-refined and the lower-reprojection-error one wins (matching OpenCV's
    solution ordering).

    jitted whole: one cached program instead of an eager dispatch per
    op.
    """
    K = jnp.asarray(K, img_corners.dtype)
    obj = square_object_points(tag_size_m, img_corners.dtype)
    if dist is None:
        # static no-distortion fast path: the fixed-point undistort is the
        # identity at zero coefficients but still costs 10 sequential
        # polynomial evaluations per solve — a pure dependency chain on
        # tiny tensors. Bit-exact skip.
        norm_xy = jnp.stack(
            [(img_corners[..., 0] - K[0, 2]) / K[0, 0],
             (img_corners[..., 1] - K[1, 2]) / K[1, 1]], axis=-1)
    else:
        norm_xy = undistort_points(img_corners, K, jnp.asarray(dist, K.dtype))
    Hn = homography_from_unit_square(norm_xy)
    Rs, ts = _ippe_from_homography(Hn)
    ts = ts * (jnp.asarray(tag_size_m, K.dtype) / 2.0)

    # polish BOTH analytic branches and pick by refined reprojection
    # error: under corner noise the pre-refine errors of the two planar-
    # ambiguity solutions overlap, so early selection flips branches
    def polish(R, t):
        rvec, t2, err = refine_pnp_gn(obj, img_corners, rodrigues_inv(R),
                                      t, K, dist, iters=refine_iters)
        return rvec, t2, err

    rvs, ts2, errs = jax.vmap(polish)(Rs, ts)
    scores = errs + jnp.where(ts2[:, 2] <= 0, 1e6, 0.0)
    best = jnp.argmin(scores)
    return rodrigues(rvs[best]), ts2[best], errs[best]


@jax.jit
def detector_pose(img_corners: jnp.ndarray, K, tag_size_m):
    """The AprilTag library's built-in homography pose
    (estimate_tag_pose=True: pose_R/pose_t from the decode homography,
    no distortion model, no iterative polish) — the reference consumes
    it in final_view_with_cad.py:66-103 and 3-way-compares it against
    solvePnP and the raw depth point in final_view.py:305-365.

    Closed-form homography decomposition only (both planar-ambiguity
    branches, cheirality + algebraic-error pick — the C library's
    orthogonal-iteration refinement is deliberately NOT applied so this
    stays the 'cheap detector pose' tier). Returns (R, t, err_px).
    """
    K = jnp.asarray(K, img_corners.dtype)
    obj = square_object_points(tag_size_m, img_corners.dtype)
    norm_xy = undistort_points(img_corners, K, jnp.zeros(8, K.dtype))
    Hn = homography_from_unit_square(norm_xy)
    Rs, ts = _ippe_from_homography(Hn)
    ts = ts * (jnp.asarray(tag_size_m, K.dtype) / 2.0)

    def err_of(R, t):
        proj = project_points(obj, rodrigues_inv(R), t, K, None)
        return jnp.mean(jnp.linalg.norm(proj - img_corners, axis=-1))

    errs = jax.vmap(err_of)(Rs, ts)
    scores = errs + jnp.where(ts[:, 2] <= 0, 1e6, 0.0)
    best = jnp.argmin(scores)
    return Rs[best], ts[best], errs[best]


# ---------------------------------------------------------------------------
# Gauss-Newton refinement (the ITERATIVE solver's core)
# ---------------------------------------------------------------------------

def _chol_solve6(A: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Solve the SPD 6x6 system A x = b by fully unrolled Cholesky.

    jnp.linalg.solve lowers to LU with partial pivoting — a sequential
    loop whose pivot selection emits gather/select ops on every step,
    which dominates the LM iteration cost for tiny systems. The
    damped normal matrix here is SPD by construction, so pivot-free
    Cholesky is numerically sound; unrolled, it is ~70 scalar ops XLA
    fuses into a handful of elementwise kernels (and batches across
    vmap lanes). A zero matrix (degenerate corners) yields a huge but
    finite step that the LM accept test rejects."""
    L = [[None] * 6 for _ in range(6)]
    for i in range(6):
        for k in range(i + 1):
            s = A[i, k]
            for m in range(k):
                s = s - L[i][m] * L[k][m]
            if i == k:
                L[i][k] = jnp.sqrt(jnp.maximum(s, 1e-20))
            else:
                L[i][k] = s / L[k][k]
    y = []
    for i in range(6):
        s = b[i]
        for m in range(i):
            s = s - L[i][m] * y[m]
        y.append(s / L[i][i])
    x = [None] * 6
    for i in reversed(range(6)):
        s = y[i]
        for m in range(i + 1, 6):
            s = s - L[m][i] * x[m]
        x[i] = s / L[i][i]
    return jnp.stack(x)


def _residuals(params, obj, img, K, dist, w):
    rvec, t = params[:3], params[3:]
    proj = project_points(obj, rvec, t, K, dist)
    return ((proj - img) * w[:, None]).reshape(-1)


@functools.partial(jax.jit, static_argnames=("iters",))
def refine_pnp_gn(obj_pts, img_pts, rvec0, tvec0, K, dist=None,
                  iters: int = 10, damping: float = 1e-6, weights=None):
    """Levenberg-damped Gauss-Newton on reprojection error over (rvec,t).

    `weights` (N,) scales per-point residuals (0 masks a point out).
    Returns (rvec, tvec, mean_reproj_err_px over weighted points).

    dist=None statically skips the Brown-Conrady polynomial inside every
    projection of the LM loop (bit-exact: the polynomial is the identity
    at zero coefficients) — it sits on the loop's sequential dependency
    chain, which is what bounds PnP cost.
    """
    K = jnp.asarray(K, img_pts.dtype)
    if dist is not None:
        dist = jnp.asarray(dist, K.dtype)
    w = (jnp.ones(obj_pts.shape[0], K.dtype) if weights is None
         else jnp.asarray(weights, K.dtype))
    p0 = jnp.concatenate([jnp.asarray(rvec0, K.dtype).reshape(3),
                          jnp.asarray(tvec0, K.dtype).reshape(3)])

    res_fn = lambda p: _residuals(p, obj_pts, img_pts, K, dist, w)

    # adaptive Levenberg-Marquardt: a fixed tiny damping with
    # accept-only-if-better stalls permanently after the first GN
    # overshoot (every later full-GN step repeats the same rejection);
    # shrinking lambda on success and growing it on rejection converges
    # to the local optimum like cv2's LM does (the r4 adversarial sweep
    # sat ~1% above cv2's reprojection objective under 2 px noise).
    #
    # Structure: the loop state carries (residual, cost) of the CURRENT
    # point, and the Jacobian comes from jax.linearize (primal shared
    # with the residual), so each iteration evaluates the projection
    # chain twice (linearize + trial point), not three times — this
    # solver is bound by the sequential depth of exactly this
    # chain, not by FLOPs (all operands are 4-point tensors).
    eye6 = jnp.eye(6, dtype=p0.dtype)
    basis = jnp.eye(6, dtype=p0.dtype)

    def body(_, state):
        p, lam, r, cost = state
        r_lin, lin = jax.linearize(res_fn, p)
        Jm = jax.vmap(lin)(basis).T             # (8,6)
        JTJ = Jm.T @ Jm
        JTr = Jm.T @ r
        mu = lam * jnp.trace(JTJ) / 6.0
        step = _chol_solve6(JTJ + mu * eye6, JTr)
        p_new = p - step
        r_new = res_fn(p_new)
        cost_new = jnp.sum(r_new ** 2)
        better = cost_new < cost
        p = jnp.where(better, p_new, p)
        r = jnp.where(better, r_new, r)
        cost = jnp.where(better, cost_new, cost)
        lam = jnp.where(better, jnp.maximum(lam / 3.0, 1e-9),
                        jnp.minimum(jnp.maximum(lam * 8.0, 1e-4), 1e6))
        return p, lam, r, cost

    r0 = res_fn(p0)
    p, _, _, _ = jax.lax.fori_loop(
        0, iters, body,
        (p0, jnp.asarray(damping, p0.dtype), r0, jnp.sum(r0 ** 2)))
    proj = project_points(obj_pts, p[:3], p[3:], K, dist)
    per_pt = jnp.linalg.norm(proj - img_pts, axis=-1)
    err = jnp.sum(per_pt * (w > 0)) / jnp.maximum(jnp.sum(w > 0), 1)
    return p[:3], p[3:], err


# ---------------------------------------------------------------------------
# SQPnP-style general solver
# ---------------------------------------------------------------------------

def _nearest_rotation(M: jnp.ndarray) -> jnp.ndarray:
    """Project a 3x3 matrix to SO(3) via SVD (det-corrected, robust to
    rank-deficient inputs)."""
    U, _, Vt = jnp.linalg.svd(M)
    d = jnp.sign(jnp.linalg.det(U @ Vt))
    D = jnp.diag(jnp.stack([jnp.ones_like(d), jnp.ones_like(d), d]))
    return U @ D @ Vt


def _rotation_from_homography(Hm: jnp.ndarray) -> jnp.ndarray:
    """SO(3) rotation seed from a plane-to-normalized-image homography
    H ~ s*[r1 r2 t] with arbitrary SVD sign.

    The sign is fixed so the plane origin sits at positive depth
    (h33/s = t_z when the origin is in view; +1 at the degenerate 0).
    The flip must be applied to h1/h2 BEFORE the cross product:
    cross(h1,h2) is invariant to negating both, so scaling the whole
    stacked matrix by -1 would flip the third column too and make it
    improper (det<0), projecting ~180 deg away from the true rotation
    (ADVICE r2, medium)."""
    h1, h2, h3 = Hm[:, 0], Hm[:, 1], Hm[:, 2]
    s = 0.5 * (jnp.linalg.norm(h1) + jnp.linalg.norm(h2))
    sgn_h = jnp.where(h3[2] < 0, -1.0, 1.0)
    return _nearest_rotation(
        jnp.stack([sgn_h * h1, sgn_h * h2,
                   jnp.cross(h1, h2) / jnp.maximum(s, 1e-20)], axis=1))


@functools.partial(jax.jit, static_argnames=("refine_iters",))
def solve_pnp_sqpnp(obj_pts: jnp.ndarray, img_pts: jnp.ndarray, K, dist=None,
                    refine_iters: int = 15, weights=None):
    """General PnP via the quadratic-program formulation + GN polish.

    Minimizes sum_i ||(I - u_i u_i^T)(R p_i + t)||^2 (u_i = bearing rays):
    eliminating t gives x^T Omega x over x = vec(R); the three smallest
    eigenvectors of Omega, projected to SO(3) with both signs, seed a GN
    refinement on true reprojection error. Replaces SOLVEPNP_SQPNP
    (mpe_final_view_tag_bundle_with_cad.py:278-284).

    Returns (R, t, mean_reproj_err_px).
    """
    K = jnp.asarray(K, img_pts.dtype)
    dist = (jnp.zeros(8, K.dtype) if dist is None
            else jnp.asarray(dist, K.dtype))
    n = obj_pts.shape[0]
    wts = (jnp.ones(n, K.dtype) if weights is None
           else jnp.asarray(weights, K.dtype))
    xy = undistort_points(img_pts, K, dist)
    u = jnp.concatenate([xy, jnp.ones((n, 1), xy.dtype)], axis=1)
    u = u / jnp.linalg.norm(u, axis=1, keepdims=True)
    W = jnp.eye(3, dtype=xy.dtype)[None] - u[:, :, None] * u[:, None, :]
    W = W * wts[:, None, None]

    # A_i x = R p_i with x = vec(R) (row-major): A_i = kron(I3, p_i^T)
    I3 = jnp.eye(3, dtype=xy.dtype)
    A = jnp.einsum("ab,nc->nabc", I3, obj_pts).reshape(n, 3, 9)

    SW = jnp.sum(W, axis=0)                     # (3,3)
    SWA = jnp.einsum("nij,njk->ik", W, A)       # (3,9)
    # t*(x) = -SW^{-1} SWA x
    T = -jnp.linalg.solve(SW + _EPS * I3, SWA)  # (3,9)
    M = A + T[None]                             # (n,3,9): A_i + dt/dx
    Omega = jnp.einsum("nia,nij,njb->ab", M, W, M)  # (9,9)

    evals, evecs = jnp.linalg.eigh(Omega)
    # candidates: 3 smallest eigenvectors, both signs
    cands = []
    for i in range(3):
        for sgn in (1.0, -1.0):
            cands.append(sgn * evecs[:, i])
    cand_R = [_nearest_rotation(c.reshape(3, 3)) for c in cands]

    # 7th candidate: weighted homography DLT on (x,y) -> normalized
    # coords. For (near-)coplanar layouts (the multi-tag bundle: all
    # tags in the layout's z=0 plane) Omega's small eigen-subspace is
    # degenerate, so the eigenvector seeds rotate arbitrarily with f32
    # rounding and GN can stall off-basin; the homography seed is
    # essentially exact there. For non-planar points the H fit is
    # meaningless and its refined candidate simply loses the argmin.
    sw = jnp.sqrt(jnp.maximum(wts, 0.0))
    x_, y_ = obj_pts[:, 0], obj_pts[:, 1]
    one = jnp.ones_like(x_)
    zero = jnp.zeros_like(x_)
    uu, vv = xy[:, 0], xy[:, 1]
    r_u = jnp.stack([x_, y_, one, zero, zero, zero,
                     -uu * x_, -uu * y_, -uu], axis=1)
    r_v = jnp.stack([zero, zero, zero, x_, y_, one,
                     -vv * x_, -vv * y_, -vv], axis=1)
    Ah = jnp.concatenate([r_u * sw[:, None], r_v * sw[:, None]], axis=0)
    _, _, Vt = jnp.linalg.svd(Ah, full_matrices=False)
    Hm = Vt[-1].reshape(3, 3)
    cand_R.append(_rotation_from_homography(Hm))
    # (t per candidate comes from the closed form t*(x) = T vec(R) in
    # score_and_refine — optimal for ANY rotation, including R_h)
    cand_R = jnp.stack(cand_R)

    def score_and_refine(R):
        x = R.reshape(9)
        t = T @ x
        rvec, t2, err = refine_pnp_gn(obj_pts, img_pts, rodrigues_inv(R), t,
                                      K, dist, iters=refine_iters,
                                      weights=wts)
        # cheirality: all weighted points in front
        cam_z = (obj_pts @ rodrigues(rvec).T + t2)[:, 2]
        penalty = jnp.where(jnp.all((cam_z > 0) | (wts <= 0)), 0.0, 1e6)
        return rvec, t2, err, err + penalty

    rvecs, ts, errs, scores = jax.vmap(score_and_refine)(cand_R)
    best = jnp.argmin(scores)
    return rodrigues(rvecs[best]), ts[best], errs[best]


# ---------------------------------------------------------------------------
# C3: best-corner-order search
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("refine_iters",))
def solve_pnp_best_order(img_corners: jnp.ndarray, K, dist, tag_size_m,
                         z_penalty: float = 1000.0, refine_iters: int = 8):
    """Try all 8 cyclic/reflected object-corner orderings with IPPE-square;
    score = mean reprojection error + z_penalty * (z <= 0); keep the best.

    Vectorized re-implementation of solve_pnp_best_order
    (final_view_with_cad.py:177-231). Returns (R, t, err_px, order_idx).
    """
    img_corners = jnp.asarray(img_corners)
    obj = square_object_points(tag_size_m, img_corners.dtype)

    def solve_for_order(order):
        # reorder object points: obj[order] pairs with img_corners as-is.
        # equivalently un-permute the image corners against canonical obj.
        inv = jnp.zeros(4, jnp.int32).at[order].set(jnp.arange(4, dtype=jnp.int32))
        R, t, err = solve_pnp_ippe_square(img_corners[inv], K, dist,
                                          tag_size_m, refine_iters=refine_iters)
        return R, t, err

    Rs, ts, errs = jax.vmap(solve_for_order)(jnp.asarray(SQUARE_ORDERS))
    scores = errs + jnp.where(ts[:, 2] <= 0, z_penalty, 0.0)
    best = jnp.argmin(scores)
    return Rs[best], ts[best], errs[best], best
