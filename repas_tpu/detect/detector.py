"""Batched tag36h11 AprilTag detector — data-parallel formulation.

Replaces the pupil-apriltags C detector (N1; ctor params at
april_tag_detector_solvepnp.py:154-162). The C library's irregular stages
(union-find segmentation, variable-count quad candidates, per-quad decode)
are reformulated as fixed-capacity, masked-slot data-parallel passes:

  1. grayscale (+ optional blur/decimate)              [stencils]
  2. tile adaptive threshold, low-contrast exclusion   [reduce-window]
  3. connected components on dark pixels               [min-propagation +
                                                        pointer jumping]
  4. top-K components by area                          [scatter-add, top_k]
  5. per-component corner candidates: extremal support
     points over 16 directions                         [scatter-max]
  6. quad extraction (farthest-point + max-area)       [vmapped]
  7. subpixel edge refinement (sample edge normals,
     weighted line fit, line intersection)             [gather + lstsq]
  8. homography -> 8x8 grid sampling -> decode_sharpening ->
     threshold from border/margin references -> 36-bit code vs codebook
     under 4 rotations, hamming <= max_hamming         [bitwise batch]
  9. compaction of top-D detections by decision margin

Every stage has static shapes, so the whole detector jits, vmaps over a
frame batch, and shards over a device mesh (SURVEY.md §5.8).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from repas_tpu.core.config import DetectorConfig
from repas_tpu.core.transforms import homography_from_unit_square
from repas_tpu.detect import tag_families
from repas_tpu.kernels.ccl import connected_components, top_k_components
from repas_tpu.kernels.image import (adaptive_threshold, bilinear_sample,
                                     bilinear_sample_patch, decimate,
                                     gaussian_blur, rgb_to_gray)
from repas_tpu.kernels.patch_extract import extract_patches_pyramid

# side of the per-component ROI patch used for subpixel refinement AND
# decode (gather-free matmul sampling): covers quads up to
# ~PATCH-2*margin px across at full resolution; larger quads use a
# 2x/4x/8x decimated patch of the same size (see detect_tags). A smaller
# patch than 256 keeps the (samples, PATCH) hat-weight matrices and the
# patch copies small; the lost single-level coverage is recovered by one
# extra pyramid level.
_PATCH = 192

_NDIRS = 16


@jax.tree_util.register_dataclass
@dataclass
class Detections:
    """Fixed-capacity detection set (slot i meaningful where valid[i])."""

    ids: jnp.ndarray               # (D,) int32, -1 when invalid
    corners: jnp.ndarray           # (D,4,2) f32, canonical TL,TR,BR,BL
    centers: jnp.ndarray           # (D,2) f32
    decision_margin: jnp.ndarray   # (D,) f32
    hamming: jnp.ndarray           # (D,) int32
    areas: jnp.ndarray             # (D,) f32 (component pixel areas)
    valid: jnp.ndarray             # (D,) bool


def _support_points(labels: jnp.ndarray, roots: jnp.ndarray,
                    bbox: jnp.ndarray):
    """Extremal support points of each component along _NDIRS directions.

    labels: (H,W) int32 component labels; roots: (C,) root label per slot;
    bbox: (C,4) f32 approximate [xmin,ymin,xmax,ymax] per slot (from
    top_k_components' ring path — each edge within a few px of true).
    Returns (C, _NDIRS, 2) float32 pixel coords.

    Implemented as masked reductions over per-component ROI label patches
    (one 128x128 dynamic-slice per slot): membership compares touch
    C*128^2 pixels instead of C*H*W — ~45x less traffic at 720p/C=48 than
    the global membership matrix, and EXACT for any component that fits a
    full-res patch (a prior stride-2 global subsample missed thin-diagonal
    corner pixels by up to ~7 px — outside the subpixel refiner's window —
    and lost a real capture's tag). Components larger than a patch use a
    stride-2^l label subsample of the same ROI; their support error
    (~level px) stays proportional to quad size, matching the refine
    window which also scales with the chosen pyramid level.
    """
    h, w = labels.shape
    C = roots.shape[0]
    ph, pw = min(_PATCH, h), min(_PATCH, w)
    m_pad = 8                       # absorbs the bbox estimate's error
    cover_x, cover_y = pw - 2 * m_pad, ph - 2 * m_pad
    n_levels = 1
    while (cover_x * 2 ** (n_levels - 1) < w
           or cover_y * 2 ** (n_levels - 1) < h) and n_levels < 4:
        n_levels += 1

    # label pyramid by pure subsampling (level-l pixel (i,j) IS full-res
    # pixel (i*2^l, j*2^l) — no averaging, so support coords stay exact
    # member-pixel locations), row-concatenated into one sliceable buffer;
    # sentinel padding (= background) never matches a root.
    sentinel = jnp.int32(h * w)
    row_off, rows = [], []
    for lv in range(n_levels):
        a = labels[:: 2 ** lv, :: 2 ** lv]
        hl_, wl_ = a.shape
        row_off.append(sum(r.shape[0] for r in rows))
        rows.append(jnp.pad(a, ((0, max(ph - hl_, 0)), (0, w - wl_)),
                            constant_values=sentinel))
    pyr = jnp.concatenate(rows, axis=0)
    row_off = jnp.asarray(row_off, jnp.int32)

    starts_l, fits_l = [], []
    for lv in range(n_levels):
        s = 2 ** lv
        hl_ = max(rows[lv].shape[0], ph)
        wl_ = -(-w // s)
        starts_l.append(jnp.stack([
            jnp.clip(jnp.floor(bbox[:, 0] / s).astype(jnp.int32) - m_pad,
                     0, max(wl_ - pw, 0)),
            jnp.clip(jnp.floor(bbox[:, 1] / s).astype(jnp.int32) - m_pad,
                     0, max(hl_ - ph, 0))], axis=1))
        fits_l.append(((bbox[:, 2] - bbox[:, 0]) / s <= cover_x)
                      & ((bbox[:, 3] - bbox[:, 1]) / s <= cover_y))
    fits_all = jnp.stack(fits_l, axis=1)                  # (C,L)
    lvl = jnp.where(jnp.any(fits_all, axis=1),
                    jnp.argmax(fits_all, axis=1),
                    n_levels - 1).astype(jnp.int32)
    starts = jnp.take_along_axis(
        jnp.stack(starts_l, axis=1), lvl[:, None, None], axis=1)[:, 0]
    scale = jnp.exp2(lvl.astype(jnp.float32))             # (C,)

    patches = jax.vmap(lambda lv_, st: jax.lax.dynamic_slice(
        pyr, (row_off[lv_] + st[1], st[0]), (ph, pw)))(lvl, starts)

    # Boundary-candidate reduction (the stage was the detector's hottest,
    # VERDICT r4 next #1): for a direction (c,s), each row's maximizer of
    # c*x + s*y is that row's min-x (c<0) or max-x (c>=0) member pixel —
    # so the row-extreme set {(minx[y],y), (maxx[y],y)} provably contains
    # a global maximizer for EVERY direction, and the per-direction
    # masked maxes run over 2*ph candidates instead of ph*pw pixels
    # (64x less elementwise traffic; two full-patch reductions happen
    # once).
    # Tie handling is unchanged: any winner's row-extreme (matching the
    # direction's x-sign) is itself a winner with >= x and equal y, so
    # the max-x / max-y-over-winners outputs are identical — the swap is
    # bit-exact vs the full-pixel formulation (pinned by
    # test_detector.py::test_support_points_boundary_equivalence).
    member = patches == roots[:, None, None]              # (C,ph,pw)
    colf = jax.lax.broadcasted_iota(jnp.float32, (ph, pw), 1)
    neg = jnp.float32(-1e9)
    maxx = jnp.max(jnp.where(member, colf, neg), axis=2)  # (C,ph)
    minx = jnp.min(jnp.where(member, colf, -neg), axis=2)
    has = maxx > neg                                      # row has a member
    rowf = jax.lax.broadcasted_iota(jnp.float32, (1, ph), 1)
    cand_col = jnp.concatenate([minx, maxx], axis=1)      # (C,2ph)
    cand_row = jnp.concatenate([rowf, rowf], axis=1)      # (1,2ph)
    cand_ok = jnp.concatenate([has, has], axis=1)
    st_f = starts.astype(jnp.float32)
    xs = (st_f[:, 0:1] + cand_col) * scale[:, None]       # (C, 2ph)
    ys = (st_f[:, 1:2] + cand_row) * scale[:, None]
    xs = jnp.where(cand_ok, xs, 0.0)
    ys = jnp.where(cand_ok, ys, 0.0)
    thetas = np.pi * 2.0 * np.arange(_NDIRS) / _NDIRS

    # the root pixel (label = min row-major pixel index) is always a
    # member; folding it in keeps every direction's support finite even
    # if a subsampled patch at a deep level catches no component pixel
    x_root = (roots % w).astype(jnp.float32)
    y_root = (roots // w).astype(jnp.float32)

    outs = []
    for t in thetas:
        c, s = np.float32(np.cos(t)), np.float32(np.sin(t))
        proj = xs * c + ys * s                            # (C, 2ph)
        pm = jnp.where(cand_ok, proj, neg)
        proj_root = x_root * c + y_root * s               # (C,)
        mx = jnp.maximum(jnp.max(pm, axis=1), proj_root)  # (C,)
        win = pm >= (mx[:, None] - 1e-3)
        root_win = proj_root >= (mx - 1e-3)
        ux = jnp.max(jnp.where(win, xs, neg), axis=1)
        uy = jnp.max(jnp.where(win, ys, neg), axis=1)
        ux = jnp.maximum(ux, jnp.where(root_win, x_root, neg))
        uy = jnp.maximum(uy, jnp.where(root_win, y_root, neg))
        outs.append(jnp.stack([ux, uy], axis=-1))
    return jnp.stack(outs, axis=1)                        # (C, NDIRS, 2)


def _quad_from_support(sup: jnp.ndarray) -> jnp.ndarray:
    """Extract 4 corner candidates from (_NDIRS,2) support points.

    Farthest-point + max-area selection, then CCW-in-image-order sort.
    Returns (4,2).
    """
    cg = jnp.mean(sup, axis=0)
    d0 = jnp.sum((sup - cg) ** 2, axis=1)
    p0 = sup[jnp.argmax(d0)]
    d1 = jnp.sum((sup - p0) ** 2, axis=1)
    p1 = sup[jnp.argmax(d1)]

    def tri_area(a, b, c):
        return 0.5 * ((b[..., 0] - a[..., 0]) * (c[..., 1] - a[..., 1])
                      - (b[..., 1] - a[..., 1]) * (c[..., 0] - a[..., 0]))

    a2 = tri_area(p0[None], p1[None], sup)
    p2 = sup[jnp.argmax(jnp.abs(a2))]
    s2 = tri_area(p0, p1, p2)
    # fourth corner: extreme on the opposite side of the p0-p1 line
    a3 = jnp.where(jnp.sign(a2) != jnp.sign(s2), jnp.abs(a2), 0.0)
    p3 = sup[jnp.argmax(a3)]

    quad = jnp.stack([p0, p1, p2, p3])
    # order by angle about the quad centroid
    c = jnp.mean(quad, axis=0)
    ang = jnp.arctan2(quad[:, 1] - c[1], quad[:, 0] - c[0])
    order = jnp.argsort(ang)
    return quad[order]


def _refine_edges(gray: jnp.ndarray, quad: jnp.ndarray,
                  n_samples: int = 12, search: float = 2.0,
                  offset_step: float = 0.5,
                  sampler=bilinear_sample) -> jnp.ndarray:
    """Subpixel edge refinement (the refine_edges=1 equivalent).

    For each quad edge, sample points along it, scan the intensity profile
    along the edge normal, localize the gradient peak by a 3-point
    parabola fit around the argmax (unbiased, unlike a centroid which
    drags toward secondary gradients), fit a line, re-intersect adjacent
    lines. Measured on a supersampled 720p render: 0.24 mm / 0.16 deg
    pose error vs 2.6 mm / 2.7 deg with the centroid estimator.

    `sampler(gray, pts)` defaults to the gather-based bilinear_sample;
    the detector passes bilinear_sample_patch with per-component ROI
    patches (two dense contractions instead of four gathers per
    sample).
    """
    rolled = jnp.roll(quad, -1, axis=0)
    ts = jnp.linspace(0.12, 0.88, n_samples)
    n_offsets = 2 * int(round(search / offset_step)) + 1
    offs = jnp.linspace(-search, search, n_offsets)
    step = 2.0 * search / (n_offsets - 1)

    def refine_edge(p, q):
        d = q - p
        length = jnp.linalg.norm(d) + 1e-9
        t_hat = d / length
        n_hat = jnp.stack([-t_hat[1], t_hat[0]])
        base = p[None, :] + ts[:, None] * d[None, :]          # (S,2)
        samp = base[:, None, :] + offs[None, :, None] * n_hat  # (S,O,2)
        vals = sampler(gray, samp)                            # (S,O)
        grad = jnp.abs(vals[:, 2:] - vals[:, :-2])            # (S,O-2)
        j = jnp.clip(jnp.argmax(grad, axis=1), 1, grad.shape[1] - 2)
        # neighborhood reads via one-hot masked sums instead of
        # take_along_axis gathers: sum(grad * (iota==j)) has exactly one
        # nonzero term, so it is bit-exact grad[j].
        iot = jax.lax.broadcasted_iota(jnp.int32, grad.shape, 1)
        jc = j[:, None]
        g0 = jnp.sum(jnp.where(iot == jc - 1, grad, 0.0), axis=1)
        g1 = jnp.sum(jnp.where(iot == jc, grad, 0.0), axis=1)
        g2 = jnp.sum(jnp.where(iot == jc + 1, grad, 0.0), axis=1)
        denom = g0 - 2.0 * g1 + g2
        frac = jnp.where(jnp.abs(denom) > 1e-6,
                         0.5 * (g0 - g2) / denom, 0.0)
        # offs[1:-1][j] = offs[j+1], arithmetically (linspace is
        # start + k*step with the same step — identical values)
        o_peak = -search + (j + 1).astype(vals.dtype) * step
        o_star = o_peak + jnp.clip(frac, -1.0, 1.0) * step
        pts = base + o_star[:, None] * n_hat[None, :]
        # peak-strength-weighted line fit: direction = principal axis
        wsum = g1 + 1e-6
        mu = jnp.sum(pts * wsum[:, None], axis=0) / jnp.sum(wsum)
        dp = (pts - mu) * jnp.sqrt(wsum)[:, None]
        cov = dp.T @ dp
        # principal eigenvector of 2x2 cov (closed form). Both candidate
        # forms degenerate when their off-diagonal vanishes — pick the
        # larger one, falling back to the edge tangent when both collapse
        # (axis-aligned float noise can leave a tiny perpendicular vector
        # that would otherwise masquerade as a valid direction).
        tr = cov[0, 0] + cov[1, 1]
        det = cov[0, 0] * cov[1, 1] - cov[0, 1] * cov[1, 0]
        lam = tr / 2 + jnp.sqrt(jnp.maximum(tr * tr / 4 - det, 0.0))
        v1 = jnp.stack([cov[0, 1], lam - cov[0, 0]])
        v2 = jnp.stack([lam - cov[1, 1], cov[1, 0]])
        v = jnp.where(jnp.linalg.norm(v1) >= jnp.linalg.norm(v2), v1, v2)
        scale = jnp.sqrt(jnp.maximum(lam, 1e-12))
        v = jnp.where(jnp.linalg.norm(v) < 1e-6 * scale,
                      t_hat, v / (jnp.linalg.norm(v) + 1e-12))
        return mu, v

    mus, vs = jax.vmap(refine_edge)(quad, rolled)   # lines i: corner i -> i+1

    def intersect(mu1, v1, mu2, v2):
        # mu1 + a v1 == mu2 + b v2
        A = jnp.stack([v1, -v2], axis=1)
        rhs = mu2 - mu1
        det = A[0, 0] * A[1, 1] - A[0, 1] * A[1, 0]
        a = (rhs[0] * A[1, 1] - rhs[1] * A[0, 1]) / jnp.where(
            jnp.abs(det) < 1e-9, 1e-9, det)
        return mu1 + a * v1

    # corner i = intersection of edge (i-1 -> i) and edge (i -> i+1)
    prev = jnp.roll(jnp.arange(4), 1)
    corners = jax.vmap(lambda i: intersect(mus[prev[i]], vs[prev[i]],
                                           mus[i], vs[i]))(jnp.arange(4))
    # guard: keep original corner if refinement exploded
    ok = jnp.linalg.norm(corners - quad, axis=1) < 2.0 * search
    return jnp.where(ok[:, None], corners, quad)


def _homography_quad(quad: jnp.ndarray) -> jnp.ndarray:
    """Homography mapping tag coords (TL=(-1,-1),TR=(1,-1),BR=(1,1),
    BL=(-1,1)) to pixel coords of the quad's 4 corners (in that order).

    Closed form (core.transforms.homography_from_unit_square) — the
    previous 8x8 jnp.linalg.solve paid LU pivot-selection gathers on
    every elimination step, a serialized chain repeated per decoded
    quad. Imported at module top: importing a module INSIDE a traced
    function turns its module-level array constants into trace-scoped
    tracers that leak into later traces (UnexpectedTracerError)."""
    return homography_from_unit_square(quad)


def _apply_h(H: jnp.ndarray, xy: jnp.ndarray) -> jnp.ndarray:
    p = jnp.concatenate([xy, jnp.ones(xy.shape[:-1] + (1,), xy.dtype)], -1)
    q = p @ H.T
    return q[..., :2] / q[..., 2:3]


def _sharpen_grid(vals: jnp.ndarray, amount: float) -> jnp.ndarray:
    """decode_sharpening: v + a * laplacian(v) on the 8x8 sample grid."""
    p = jnp.pad(vals, 1, mode="edge")
    lap = (4.0 * vals - p[:-2, 1:-1] - p[2:, 1:-1]
           - p[1:-1, :-2] - p[1:-1, 2:])
    return vals + amount * lap


def _decode_quad(gray: jnp.ndarray, quad: jnp.ndarray, table: jnp.ndarray,
                 perms: jnp.ndarray, sharpening: float, max_hamming: int,
                 sampler=None):
    """Decode one quad. Returns (id, rotation k, hamming, margin, corners).

    `sampler(pts)` maps full-resolution pixel coords (...,2) to intensity
    samples; default is a gather-based bilinear_sample on `gray`. The
    detector passes a patch-backed matmul sampler instead."""
    if sampler is None:
        sampler = lambda p: bilinear_sample(gray, p)  # noqa: E731
    H = _homography_quad(quad)
    cells = tag_families.GRID + 2        # 8 with border
    # cell centers in tag coords [-1,1]
    cs = (jnp.arange(cells, dtype=jnp.float32) + 0.5) / cells * 2.0 - 1.0
    gx, gy = jnp.meshgrid(cs, cs, indexing="xy")
    pts = jnp.stack([gx, gy], axis=-1)           # (8,8,2), [row, col]
    raw = sampler(_apply_h(H, pts))
    vals = _sharpen_grid(raw, sharpening)

    # white reference samples: quiet-zone ring just outside the border
    m = 1.0 + 1.0 / cells
    ring = jnp.concatenate([
        jnp.stack([cs, jnp.full_like(cs, -m)], -1),
        jnp.stack([cs, jnp.full_like(cs, m)], -1),
        jnp.stack([jnp.full_like(cs, -m), cs], -1),
        jnp.stack([jnp.full_like(cs, m), cs], -1),
    ])
    ring_v = sampler(_apply_h(H, ring))
    border_mask = jnp.zeros((cells, cells), bool).at[0, :].set(True)
    border_mask = border_mask.at[-1, :].set(True).at[:, 0].set(True)
    border_mask = border_mask.at[:, -1].set(True)

    # AprilTag3 decision-margin semantics (apriltag.c quad_decode, the
    # contract behind the `margin >= 10` gates at
    # three_pose_vertical_translation_validation.py:38 and
    # april_tag_detector_solvepnp.py decision_margin consumers): fit
    # LINEAR gray models W(x,y), B(x,y) over tag coords — white from the
    # quiet-zone ring, black from the UNsharpened border cells — then
    # threshold each data cell at (W+B)/2 at its own position, and score
    # margin = min(mean white-side |v - thresh|, mean black-side). A
    # shared linear fit keeps the value calibrated in 0-255 gray units
    # under illumination gradients (a global mean threshold deflates the
    # margin on unevenly lit tags and is what the old formulation used).
    def _solve_spd3(M, rhs):
        # closed-form 3x3 solve via the adjugate: M is SPD (normal
        # matrix + ridge), so det > 0 and no pivoting is needed —
        # jnp.linalg.solve's LU emits serialized pivot gathers per quad
        c00 = M[1, 1] * M[2, 2] - M[1, 2] * M[2, 1]
        c01 = M[0, 2] * M[2, 1] - M[0, 1] * M[2, 2]
        c02 = M[0, 1] * M[1, 2] - M[0, 2] * M[1, 1]
        c10 = M[1, 2] * M[2, 0] - M[1, 0] * M[2, 2]
        c11 = M[0, 0] * M[2, 2] - M[0, 2] * M[2, 0]
        c12 = M[0, 2] * M[1, 0] - M[0, 0] * M[1, 2]
        c20 = M[1, 0] * M[2, 1] - M[1, 1] * M[2, 0]
        c21 = M[0, 1] * M[2, 0] - M[0, 0] * M[2, 1]
        c22 = M[0, 0] * M[1, 1] - M[0, 1] * M[1, 0]
        det = M[0, 0] * c00 + M[0, 1] * c10 + M[0, 2] * c20
        adj = jnp.stack([jnp.stack([c00, c01, c02]),
                         jnp.stack([c10, c11, c12]),
                         jnp.stack([c20, c21, c22])])
        return adj @ rhs / det

    def _linfit(xy, v):
        A = jnp.stack([xy[:, 0], xy[:, 1], jnp.ones_like(v)], axis=1)
        AtA = A.T @ A + 1e-4 * jnp.eye(3, dtype=v.dtype)
        return _solve_spd3(AtA, A.T @ v)

    cw = _linfit(ring, ring_v)
    border_xy = jnp.stack([gx.reshape(-1), gy.reshape(-1)], axis=1)
    bm_flat = border_mask.reshape(-1).astype(jnp.float32)
    # weighted fit over border cells only (masked rows zeroed)
    Ab = jnp.stack([border_xy[:, 0], border_xy[:, 1],
                    jnp.ones(cells * cells, jnp.float32)], axis=1)
    Aw = Ab * bm_flat[:, None]
    AtA = Aw.T @ Aw + 1e-4 * jnp.eye(3, dtype=jnp.float32)
    cb = _solve_spd3(AtA, Aw.T @ (raw.reshape(-1) * bm_flat))

    data_xy = jnp.stack([gx[1:-1, 1:-1].reshape(-1),
                         gy[1:-1, 1:-1].reshape(-1)], axis=1)   # (36,2)
    Wv = data_xy @ cw[:2] + cw[2]
    Bv = data_xy @ cb[:2] + cb[2]
    thresh36 = 0.5 * (Wv + Bv)                   # (36,)

    data = vals[1:-1, 1:-1].reshape(-1)          # (36,), row-major
    bits = data > thresh36                       # (36,)
    diff = data - thresh36
    n_w = jnp.maximum(jnp.sum(bits), 1)
    n_b = jnp.maximum(jnp.sum(~bits), 1)
    white_score = jnp.sum(jnp.where(bits, diff, 0.0)) / n_w
    black_score = jnp.sum(jnp.where(~bits, -diff, 0.0)) / n_b
    margin = jnp.minimum(white_score, black_score)

    white_ref = jnp.mean(ring_v)
    black_ref = jnp.sum(raw.reshape(-1) * bm_flat) / jnp.sum(bm_flat)
    # contrast sanity: border must be darker than quiet zone
    contrast_ok = (white_ref - black_ref) > 10.0
    thresh_border = 0.5 * (white_ref + black_ref)
    border_frac = (jnp.sum(jnp.where(border_mask, raw < thresh_border,
                                     False)) / jnp.sum(border_mask))

    # try 4 rotations against the codebook
    rbits = bits[perms]                          # (4,36)
    dist = jnp.sum(rbits[:, None, :] != table[None, :, :], axis=-1)  # (4,N)
    flat = jnp.argmin(dist.reshape(-1))
    k = flat // table.shape[0]
    tag_id = flat % table.shape[0]
    ham = dist.reshape(-1)[flat]

    ok = (ham <= max_hamming) & contrast_ok & (border_frac > 0.7)

    # canonical corner order: observed grid = rot90(canonical, k) means the
    # canonical TL cell appears at observed corner index k going around the
    # quad; roll corners so slot 0 is the canonical TL.
    corners = jnp.roll(quad, -k, axis=0)
    # tag-likeness of the quad INDEPENDENT of decode success — the robust
    # ladder escalates undecoded-but-tag-shaped candidates (a decimated
    # tag keeps its dark border and contrast while losing data bits; a
    # background blob that slipped the ring filter rarely has all three)
    tagness = (jnp.clip(border_frac - 0.5, 0.0, None)
               * jnp.clip(white_ref - black_ref, 0.0, 100.0)
               * jnp.clip(36.0 - ham.astype(jnp.float32), 0.0, None))
    return (jnp.where(ok, tag_id, -1).astype(jnp.int32),
            k.astype(jnp.int32), ham.astype(jnp.int32),
            jnp.where(ok, margin, 0.0), corners, tagness)


@functools.partial(jax.jit, static_argnames=("config", "with_candidates"))
def detect_tags(img: jnp.ndarray, config: DetectorConfig = DetectorConfig(),
                with_candidates: bool = False):
    """Detect tag36h11 tags in one image (uint8 RGB (H,W,3) or gray (H,W)).

    Returns a fixed-capacity `Detections` (config.max_detections slots).
    With `with_candidates`, additionally returns every candidate quad's
    full-res bbox (C,4) [xmin,ymin,xmax,ymax] and a tag-likeness score
    (C,) (decode-evidence based; 0 for dead slots) — the robust ladder's ROI
    escalation re-detects around UNDECODED candidates at full resolution
    instead of re-running the detector on the whole frame (the reference
    escalates parameters on the same frame, detect_best_tag at
    vis_tool_april_tag_pose_validaiton.py:65-86; candidate-bounded ROIs
    are the fixed-capacity equivalent at a fraction of the pixels).
    """
    gray = rgb_to_gray(img) if img.ndim == 3 else img.astype(jnp.float32)
    if config.quad_sigma > 0:
        gray = gaussian_blur(gray, config.quad_sigma)
    h, w = gray.shape

    # segmentation/quad search run decimated (quad_decimate semantics of
    # the C detector); corners are refined at full resolution afterwards
    dec = max(1, int(config.quad_decimate))
    gray_lo = decimate(gray, dec) if dec > 1 else gray
    hl, wl = gray_lo.shape

    binary, ambiguous = adaptive_threshold(gray_lo, tile=config.tile,
                                           min_contrast=config.min_contrast)
    dark = (~binary) & (~ambiguous)
    labels = connected_components(dark, iters=config.ccl_iters)
    roots, areas, valid_c, bbox = top_k_components(
        labels, config.max_components,
        min_area=config.min_area_px / (dec * dec),
        max_area=config.max_area_frac * hl * wl, ring_filter=True,
        min_side=8.0 / dec, return_bbox=True)
    areas = areas * (dec * dec)

    sup = _support_points(labels, roots, bbox)        # (C,16,2)
    quads = jax.vmap(_quad_from_support)(sup)         # (C,4,2)
    if dec > 1:
        # low-res pixel i covers full-res [i*dec, i*dec+dec-1]
        quads = quads * dec + (dec - 1) / 2.0
    # two-stage subpixel refinement: a coarse pass absorbs the decimation
    # offset, a tight second pass from the refined quad avoids secondary
    # gradients inside the search window (0.24 mm / 0.16 deg pose error on
    # a supersampled render vs 2.9 mm / 1.1 deg single-pass).
    # Sampling runs on per-component ROI patches (contiguous dynamic
    # slices) with the gather-free matmul sampler. Quads too large for a
    # full-res patch (> ~100 px across — close-range tags) pick the first
    # pyramid level whose decimated patch covers them: level-l
    # localization error ~0.1*2^l px, far below the coarse corners they
    # previously kept (2.6 mm vs 0.24 mm pose cliff). The pyramid is stored
    # row-concatenated at native per-level size (one 2-D buffer, ~1.9x
    # the image) rather than as an (L,H,W) stack (L x the image written
    # per frame).
    ph, pw = min(_PATCH, h), min(_PATCH, w)
    margin = 12.0
    cover = min(ph, pw) - 2 * margin
    n_levels = 1
    while cover * 2 ** (n_levels - 1) < max(h, w) and n_levels < 4 \
            and (min(h, w) >> n_levels) >= 8:
        n_levels += 1
    lvl_imgs = [gray]
    for lv in range(1, n_levels):
        lvl_imgs.append(decimate(lvl_imgs[-1], 2))
    row_off, rows = [], []
    for a in lvl_imgs:
        hl_, wl_ = a.shape
        row_off.append(sum(r.shape[0] for r in rows))
        # pad each level block to at least the patch size (edge mode:
        # a level smaller than the patch reads replicated pixels, not
        # zeros); window starts are clipped inside their level, so a
        # window never crosses into a neighboring level's rows.
        # bf16 storage: the matmul sampler casts patches to bf16 anyway
        # (bilinear_sample_patch), so rounding at pyramid build produces
        # bit-identical samples while halving the patch-copy traffic.
        rows.append(jnp.pad(a.astype(jnp.bfloat16),
                            ((0, max(hl_, ph) - hl_), (0, w - wl_)),
                            mode="edge"))
    pyr = jnp.concatenate(rows, axis=0)                # (~2H, W) bf16
    row_off = jnp.asarray(row_off, jnp.int32)

    qlo = jnp.min(quads, axis=1)                       # (C,2) x,y
    qhi = jnp.max(quads, axis=1)
    starts_l, fits_l = [], []
    for lv in range(n_levels):
        s = 2 ** lv
        # full-res x maps to level-l coord (x - (s-1)/2) / s (low-res
        # pixel i covers full-res [i*s, i*s+s-1])
        lo_l = (qlo - (s - 1) / 2.0) / s
        hi_l = (qhi - (s - 1) / 2.0) / s
        hl_, wl_ = lvl_imgs[lv].shape
        starts_l.append(jnp.stack([
            jnp.clip(jnp.floor(lo_l[:, 0] - margin).astype(jnp.int32),
                     0, max(wl_ - pw, 0)),
            jnp.clip(jnp.floor(lo_l[:, 1] - margin).astype(jnp.int32),
                     0, max(hl_ - ph, 0))], axis=1))
        fits_l.append(((hi_l[:, 0] - lo_l[:, 0]) <= pw - 2 * margin)
                      & ((hi_l[:, 1] - lo_l[:, 1]) <= ph - 2 * margin))
    fits_all = jnp.stack(fits_l, axis=1)               # (C,L)
    fits = jnp.any(fits_all, axis=1)
    # first fitting level; quads bigger than the deepest level's cover
    # (degenerate close-ups) fall back to the deepest patch — their
    # decode samples clamp at the patch edge but the data cells are
    # interior, so decode usually still succeeds; refine is skipped.
    lvl = jnp.where(fits, jnp.argmax(fits_all, axis=1),
                    n_levels - 1).astype(jnp.int32)
    starts = jnp.take_along_axis(
        jnp.stack(starts_l, axis=1), lvl[:, None, None], axis=1)[:, 0]
    scale = jnp.exp2(lvl.astype(jnp.float32))[:, None, None]  # (C,1,1)

    patches = extract_patches_pyramid(
        pyr, row_off[lvl] + starts[:, 1], starts[:, 0], ph, pw)
    off = starts.astype(jnp.float32)[:, None, :]               # (C,1,2)
    q_rel = (quads - (scale - 1) / 2.0) / scale - off
    # pass 1 scans the +-(2+dec) px window at 1 px steps (the parabola
    # peak fit is accurate to ~0.1 px at this step — pass 2 tightens it);
    # 0.5 px steps doubled the sample matmuls for no end-to-end gain
    q_ref = jax.vmap(lambda p, q: _refine_edges(
        p, q, search=2.0 + dec, offset_step=1.0,
        sampler=bilinear_sample_patch))(patches, q_rel)
    # pass 1 leaves sub-half-pixel residual, so pass 2 only needs a
    # +-1 px window at quarter-pixel steps (9 offsets, not 17)
    q_ref = jax.vmap(lambda p, q: _refine_edges(
        p, q, search=1.0, offset_step=0.25,
        sampler=bilinear_sample_patch))(patches, q_ref)
    q_rel = jnp.where(fits[:, None, None], q_ref, q_rel)
    quads = (q_rel + off) * scale + (scale - 1) / 2.0

    table = jnp.asarray(tag_families.tag_family_bits())
    perms = jnp.asarray(tag_families.rotation_perms())

    def _decode_one(patch, q, off1, sc):
        def samp(pts_full):
            return bilinear_sample_patch(
                patch, (pts_full - (sc - 1.0) / 2.0) / sc - off1)
        return _decode_quad(gray, q, table, perms,
                            config.decode_sharpening,
                            config.max_hamming, sampler=samp)

    ids, ks, hams, margins, corners, tagness = jax.vmap(_decode_one)(
        patches, quads, off, scale[:, :, 0])

    # quad sanity: distinct corners
    e = jnp.linalg.norm(corners - jnp.roll(corners, 1, axis=1), axis=-1)
    sane = jnp.min(e, axis=1) > 2.0
    ok = valid_c & (ids >= 0) & sane & (margins >= config.min_decision_margin)

    # compact: top-D by decision margin
    D = config.max_detections
    score = jnp.where(ok, margins, -1.0)
    top_scores, top_idx = jax.lax.top_k(score, D)
    sel_valid = top_scores > 0

    det = Detections(
        ids=jnp.where(sel_valid, ids[top_idx], -1),
        corners=corners[top_idx],
        centers=jnp.mean(corners[top_idx], axis=1),
        decision_margin=jnp.where(sel_valid, margins[top_idx], 0.0),
        hamming=hams[top_idx],
        areas=areas[top_idx],
        valid=sel_valid,
    )
    if with_candidates:
        cand_bbox = jnp.concatenate([jnp.min(quads, axis=1),
                                     jnp.max(quads, axis=1)], axis=1)
        # escalation-worthiness: tag-shaped (decode evidence, not raw
        # area — area top-ranks background blobs over the actual tag) and
        # small enough that full-res re-detection inside a ~256 px ROI
        # can help (bigger quads already decode fine decimated)
        side = jnp.max(cand_bbox[:, 2:] - cand_bbox[:, :2], axis=1)
        cand_score = jnp.where(valid_c & sane & (side <= 192.0),
                               tagness, 0.0)
        return det, cand_bbox, cand_score
    return det


def detect_tags_batch(imgs: jnp.ndarray,
                      config: DetectorConfig = DetectorConfig()) -> Detections:
    """vmapped detector over a frame batch (N,H,W[,3])."""
    return jax.vmap(lambda im: detect_tags(im, config))(imgs)
