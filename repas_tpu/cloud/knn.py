"""Grid-hash nearest neighbors on device (replaces Open3D KDTreeFlann /
scipy cKDTree, N3/N6).

Fixed-capacity, masked formulation: points are binned into a dense 3-D
voxel grid over their AABB (one point slot per cell per pass, multiple
passes fill up to `slots` points per cell via iterated scatter), and
queries gather the 3x3x3 neighborhood's candidates. All shapes static.

For ICP-scale problems (50k source vs 100-500k target at 5 mm voxels)
this is a handful of scatter/gather passes — orders of magnitude cheaper
than per-query tree traversal and a natural fit for vector hardware.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

# the 3x3x3 neighborhood offsets, enumerated once (dx-major) so candidate
# column order is deterministic
_OFFSETS = np.array([[dx, dy, dz]
                     for dx in (-1, 0, 1)
                     for dy in (-1, 0, 1)
                     for dz in (-1, 0, 1)], dtype=np.int32)


class GridHash(NamedTuple):
    cell_of: jnp.ndarray     # (slots, n_cells) int32 point index or -1
    origin: jnp.ndarray      # (3,)
    cell: jnp.ndarray        # () cell size


def _cell_ids(pts, origin, cell, dims):
    ijk = jnp.floor((pts - origin) / cell).astype(jnp.int32)
    ijk = jnp.clip(ijk, 0, jnp.asarray(dims, jnp.int32) - 1)
    nx, ny, nz = dims
    return (ijk[:, 0] * ny + ijk[:, 1]) * nz + ijk[:, 2]


@functools.partial(jax.jit, static_argnames=("dims", "slots"))
def grid_hash_build(pts: jnp.ndarray, mask: jnp.ndarray, origin, cell,
                    dims: tuple, slots: int = 4) -> GridHash:
    """Bin masked points into the grid. Up to `slots` points kept per cell
    (others dropped — acceptable for downsampled clouds where cell size ~
    point spacing)."""
    n_cells = dims[0] * dims[1] * dims[2]
    cid = _cell_ids(pts, origin, cell, dims)
    cid = jnp.where(mask, cid, n_cells)          # park invalid in overflow
    idx = jnp.arange(pts.shape[0], dtype=jnp.int32)

    taken = []
    used = jnp.zeros_like(cid, dtype=bool)
    for s in range(slots):
        buf = jnp.full(n_cells + 1, -1, jnp.int32)
        # scatter-max picks one untaken point per cell deterministically
        cand = jnp.where(used, -1, idx)
        buf = buf.at[cid].max(cand)
        taken.append(buf[:n_cells])
        chosen = buf[cid] == idx
        used = used | chosen
    return GridHash(cell_of=jnp.stack(taken), origin=jnp.asarray(origin),
                    cell=jnp.asarray(cell))


def _candidate_indices(gh: GridHash, qpts: jnp.ndarray, dims: tuple
                       ) -> jnp.ndarray:
    """(Q, 27*slots) candidate target indices (-1 = empty slot).

    One vectorized gather over the 3x3x3 neighborhood x all slots. The
    previous formulation unrolled 27*slots separate gathers in Python;
    inside an ICP `while_loop` body that graph made XLA's CPU compile
    pathologically slow (>25 min for the two-level query) — this form
    compiles in seconds and produces the same candidate SET.

    Query cells clamp like _cell_ids does for targets: out-of-extent
    queries search the boundary cells (where out-of-extent targets were
    parked) instead of silently seeing zero candidates."""
    nx, ny, nz = dims
    dims_a = jnp.asarray(dims, jnp.int32)
    ijk = jnp.floor((qpts - gh.origin) / gh.cell).astype(jnp.int32)
    ijk = jnp.clip(ijk, 0, dims_a - 1)
    q = ijk[:, None, :] + jnp.asarray(_OFFSETS)[None, :, :]   # (Q,27,3)
    inb = jnp.all((q >= 0) & (q < dims_a), axis=-1)           # (Q,27)
    qc = (q[..., 0] * ny + q[..., 1]) * nz + q[..., 2]
    qc = jnp.where(inb, qc, 0)
    pi = gh.cell_of[:, qc]                                    # (S,Q,27)
    pi = jnp.where(inb[None] & (pi >= 0), pi, -1)
    nq = qpts.shape[0]
    return jnp.moveaxis(pi, 0, 2).reshape(nq, -1)             # (Q, 27*S)


@functools.partial(jax.jit, static_argnames=("dims", "chunk"))
def grid_hash_query(gh: GridHash, target_pts: jnp.ndarray,
                    query_pts: jnp.ndarray, query_mask: jnp.ndarray,
                    dims: tuple, chunk: int = 16384):
    """1-NN search: for each query, scan the 27 neighboring cells' slots.

    Returns (nn_idx (Q,) int32 [-1 if none], nn_dist (Q,) f32). Queries
    beyond `chunk` rows are processed in chunks so the (chunk, 27*slots, 3)
    candidate gather stays memory-bounded at any Q.
    """
    nq = query_pts.shape[0]

    def chunk_fn(args):
        qpts, qmask = args
        cand = _candidate_indices(gh, qpts, dims)             # (C, 27S)
        diff = target_pts[jnp.maximum(cand, 0)] - qpts[:, None, :]
        d2 = jnp.sum(diff * diff, axis=-1)
        d2 = jnp.where(cand >= 0, d2, jnp.inf)
        j = jnp.argmin(d2, axis=1)
        dmin = jnp.take_along_axis(d2, j[:, None], 1)[:, 0]
        imin = jnp.take_along_axis(cand, j[:, None], 1)[:, 0]
        ok = qmask & (imin >= 0)
        return (jnp.where(ok, imin, -1),
                jnp.where(ok, jnp.sqrt(dmin), jnp.inf))

    if nq <= chunk:
        return chunk_fn((query_pts, query_mask))
    n_chunks = (nq + chunk - 1) // chunk
    pad = n_chunks * chunk - nq
    qp = jnp.concatenate([query_pts, jnp.zeros((pad, 3), query_pts.dtype)])
    qm = jnp.concatenate([query_mask, jnp.zeros(pad, bool)])
    idx, dist = jax.lax.map(chunk_fn, (qp.reshape(n_chunks, chunk, 3),
                                       qm.reshape(n_chunks, chunk)))
    return idx.reshape(-1)[:nq], dist.reshape(-1)[:nq]


class GridHash2(NamedTuple):
    """Two-level grid: coarse guarantees the search radius, fine removes the
    slot-exhaustion bias when cell >> point spacing (a 5 cm cell over a 5 mm
    surface cloud holds ~100 points; keeping only `slots` of them biases NN
    distances up). Queries scan both and keep the min — distances are exact,
    so the union can only improve on either level alone."""

    coarse: GridHash
    fine: GridHash


def grid2_build(pts: jnp.ndarray, mask: jnp.ndarray, radius,
                coarse_dims: tuple = (64, 64, 64),
                fine_dims: tuple = (96, 96, 96),
                coarse_slots: int = 16, fine_slots: int = 8) -> GridHash2:
    """Build both levels over the masked AABB. `radius` = correspondence
    radius; coarse cell = radius (±1-cell reach covers it), fine cell =
    radius/4 (≈ point spacing for the reference's 5 mm voxel / 5 cm ICP)."""
    coarse_cell = jnp.asarray(radius, jnp.float32)
    fine_cell = coarse_cell / 4.0
    big = jnp.where(mask[:, None], pts, jnp.inf)
    lo = jnp.min(big, axis=0)
    return GridHash2(
        coarse=grid_hash_build(pts, mask, lo - coarse_cell, coarse_cell,
                               coarse_dims, coarse_slots),
        fine=grid_hash_build(pts, mask, lo - fine_cell, fine_cell,
                             fine_dims, fine_slots))


def grid2_query(gh2: GridHash2, target_pts: jnp.ndarray,
                query_pts: jnp.ndarray, query_mask: jnp.ndarray,
                coarse_dims: tuple = (64, 64, 64),
                fine_dims: tuple = (96, 96, 96)):
    """1-NN over both levels; min-distance winner."""
    ic, dc = grid_hash_query(gh2.coarse, target_pts, query_pts, query_mask,
                             coarse_dims)
    iff, df = grid_hash_query(gh2.fine, target_pts, query_pts, query_mask,
                              fine_dims)
    take_fine = df < dc
    return (jnp.where(take_fine, iff, ic), jnp.where(take_fine, df, dc))


def nearest_neighbors(target_pts: jnp.ndarray, target_mask: jnp.ndarray,
                      query_pts: jnp.ndarray, query_mask: jnp.ndarray,
                      cell: float, dims: tuple = (64, 64, 64),
                      slots: int = 4):
    """Convenience wrapper: build grid over target AABB + query 1-NN.

    `dims` and `slots` are static; `cell` should be ~ the correspondence
    radius (queries only see +-1 cell).
    """
    big = jnp.where(target_mask[:, None], target_pts, jnp.inf)
    lo = jnp.min(big, axis=0) - cell
    gh = grid_hash_build(target_pts, target_mask, lo, cell, dims, slots)
    return grid_hash_query(gh, target_pts, query_pts, query_mask, dims)


@functools.partial(jax.jit, static_argnames=("dims", "k", "chunk"))
def grid_hash_query_knn(gh: GridHash, target_pts: jnp.ndarray,
                        query_pts: jnp.ndarray, query_mask: jnp.ndarray,
                        dims: tuple, k: int, chunk: int = 8192):
    """k-NN search over the 27-cell neighborhood (27*slots candidates per
    query, one top_k). Queries are processed in chunks of `chunk` rows so
    the (chunk, 27*slots, 3) gather stays memory-bounded at any Q.
    Returns (idx (Q,k) int32 [-1 pad], dist (Q,k) f32 [inf pad]), nearest
    first. Self-matches are NOT excluded."""
    nq = query_pts.shape[0]
    slots = gh.cell_of.shape[0]
    kk = min(k, 27 * slots)

    def chunk_fn(args):
        qpts, qmask = args
        cand = _candidate_indices(gh, qpts, dims)         # (C, 27*slots)
        diff = target_pts[jnp.maximum(cand, 0)] - qpts[:, None, :]
        d2 = jnp.sum(diff * diff, axis=-1)
        d2 = jnp.where(cand >= 0, d2, jnp.inf)
        neg, col = jax.lax.top_k(-d2, kk)
        idx = jnp.take_along_axis(cand, col, axis=1)
        dist = jnp.sqrt(jnp.maximum(-neg, 0.0))
        dist = jnp.where((idx >= 0) & qmask[:, None], dist, jnp.inf)
        idx = jnp.where((idx >= 0) & qmask[:, None], idx, -1)
        return idx, dist

    n_chunks = (nq + chunk - 1) // chunk
    pad_q = n_chunks * chunk - nq
    qp = jnp.concatenate([query_pts,
                          jnp.zeros((pad_q, 3), query_pts.dtype)])
    qm = jnp.concatenate([query_mask, jnp.zeros(pad_q, bool)])
    idx, dist = jax.lax.map(
        chunk_fn, (qp.reshape(n_chunks, chunk, 3),
                   qm.reshape(n_chunks, chunk)))
    idx = idx.reshape(-1, kk)[:nq]
    dist = dist.reshape(-1, kk)[:nq]
    if kk < k:                                            # pad to k
        padn = k - kk
        idx = jnp.concatenate(
            [idx, jnp.full((nq, padn), -1, idx.dtype)], axis=1)
        dist = jnp.concatenate(
            [dist, jnp.full((nq, padn), jnp.inf, dist.dtype)], axis=1)
    return idx, dist


def knn_neighbors(pts: jnp.ndarray, mask: jnp.ndarray, radius: float,
                  k: int, dims: tuple = (48, 48, 48), slots: int = 48):
    """Self k-NN of a cloud over a grid sized so one cell ~ the search
    radius (the SPFH/normal-estimation workhorse at full cloud scale —
    no global subsample, VERDICT r1 item 10)."""
    big = jnp.where(mask[:, None], pts, jnp.inf)
    small = jnp.where(mask[:, None], pts, -jnp.inf)
    lo = jnp.min(big, axis=0) - radius
    hi = jnp.max(small, axis=0) + radius
    # cell >= extent/dims so the grid always covers the cloud — otherwise
    # points beyond dims*cell clamp into boundary cells (overflowing their
    # slots) and queries there would see truncated neighborhoods
    extent = jnp.max(hi - lo)
    cell = jnp.maximum(jnp.asarray(radius, jnp.float32),
                       extent / (min(dims) - 1))
    gh = grid_hash_build(pts, mask, lo, cell, dims, slots)
    return grid_hash_query_knn(gh, pts, pts, mask, dims, k)
