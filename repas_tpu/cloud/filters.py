"""Point-cloud filters: radius mask, voxel downsample, statistical outlier
removal (replacing distance_masking_on_ply.py:1-34,
pcd.voxel_down_sample / remove_statistical_outlier at
create_masked_ply.py:163-174).

All operate on fixed-shape (N,3) arrays + validity masks; "removal" means
clearing mask bits, never reshaping (jit/shard-friendly).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def radius_mask(pts: jnp.ndarray, mask: jnp.ndarray,
                max_dist: float = 1.0, origin=None) -> jnp.ndarray:
    """Keep points with ||p - origin|| < max_dist
    (distance_masking_on_ply.py semantics; origin defaults to camera)."""
    o = jnp.zeros(3, pts.dtype) if origin is None else jnp.asarray(origin)
    d2 = jnp.sum((pts - o) ** 2, axis=1)
    return mask & (d2 < max_dist * max_dist)


@functools.partial(jax.jit, static_argnames=("buckets",))
def voxel_downsample(pts: jnp.ndarray, mask: jnp.ndarray, voxel: float,
                     colors: jnp.ndarray | None = None,
                     normals: jnp.ndarray | None = None,
                     buckets: int | None = None):
    """Voxel-grid downsample by averaging per cell (Open3D
    voxel_down_sample semantics).

    Uses a hashed voxel map instead of a dense grid, so the extent is
    unbounded (a dense grid of fixed dims silently collapses points past
    its edge into boundary cells). Hash-bucket collisions between distinct
    voxels are resolved by keeping only the representative voxel's points
    (rare: buckets ~ 4N).

    Returns (pts, colors, normals, valid) all sized like the input, with
    `valid` marking the one representative slot per occupied voxel which
    carries that voxel's mean.
    """
    n = pts.shape[0]
    if buckets is None:
        buckets = max(1 << (2 * n - 1).bit_length(), 1024)  # ~4N pow2
    lo = jnp.min(jnp.where(mask[:, None], pts, jnp.inf), axis=0)
    ijk = jnp.floor((pts - lo) / voxel).astype(jnp.int32)
    h = ((ijk[:, 0] * 73856093) ^ (ijk[:, 1] * 19349663)
         ^ (ijk[:, 2] * 83492791)) & (buckets - 1)
    h = jnp.where(mask, h, buckets)

    idx = jnp.arange(n, dtype=jnp.int32)
    first = jnp.full(buckets + 1, n, jnp.int32).at[h].min(idx)
    rep = jnp.clip(first[h], 0, n - 1)
    # a point belongs to its bucket only if its voxel == the rep's voxel
    # (hash collisions between different voxels get dropped)
    member = mask & jnp.all(ijk == ijk[rep], axis=1)
    hm = jnp.where(member, h, buckets)

    cnt = jnp.zeros(buckets + 1, jnp.float32).at[hm].add(1.0)
    denom = jnp.maximum(cnt[hm], 1.0)[:, None]
    sums = jnp.zeros((buckets + 1, 3), jnp.float32).at[hm].add(
        jnp.where(member[:, None], pts, 0.0))
    is_rep = member & (first[hm] == idx)
    out_pts = jnp.where(is_rep[:, None], sums[hm] / denom, 0.0)

    out_cols = None
    if colors is not None:
        csum = jnp.zeros((buckets + 1, 3), jnp.float32).at[hm].add(
            jnp.where(member[:, None], colors, 0.0))
        out_cols = jnp.where(is_rep[:, None], csum[hm] / denom, 0.0)
    out_nrm = None
    if normals is not None:
        nsum = jnp.zeros((buckets + 1, 3), jnp.float32).at[hm].add(
            jnp.where(member[:, None], normals, 0.0))
        m = nsum[hm]
        m = m / jnp.maximum(jnp.linalg.norm(m, axis=1, keepdims=True), 1e-9)
        out_nrm = jnp.where(is_rep[:, None], m, 0.0)

    return out_pts, out_cols, out_nrm, is_rep


@functools.partial(jax.jit, static_argnames=("capacity",))
def compact_masked(pts: jnp.ndarray, mask: jnp.ndarray, capacity: int):
    """Pack the masked-valid rows of a fixed-shape cloud into the first
    `capacity` slots (static shape, device-side — no host sync).

    Voxel downsampling keeps the input's N with a sparse validity mask;
    running FPFH/matching over all N rows wastes N/V of the work (and a
    1M x 1M feature-distance matmul at V~2k real rows is ~600x too much
    compute). argsort(~mask) is stable, so valid rows keep their relative
    order. Returns (pts (capacity,3), ok (capacity,), n_valid ()) —
    n_valid > capacity means rows were dropped; callers should size
    capacity generously (it only costs capacity x k downstream work).
    """
    order = jnp.argsort(~mask)               # valid rows first, stable
    idx = order[:capacity]
    return pts[idx], mask[idx], jnp.sum(mask.astype(jnp.int32))


def statistical_outlier_mask(pts: jnp.ndarray, mask: jnp.ndarray,
                             nb_neighbors: int = 20, std_ratio: float = 2.0,
                             sample: int = 2048, key=None) -> jnp.ndarray:
    """Statistical outlier removal (Open3D remove_statistical_outlier,
    create_masked_ply.py:170-174).

    Open3D computes each point's mean distance to its k nearest neighbors
    and drops points whose mean distance exceeds mean + std_ratio * std.
    Exact kNN over every pair is O(N^2); here each point's kNN is computed
    against a fixed random subsample of the cloud (distance distributions
    are statistically identical for outlier purposes), keeping the op
    O(N * sample) — a single (N,sample) distance matrix product.
    """
    if key is None:
        key = jax.random.PRNGKey(0)
    n = pts.shape[0]
    sample = min(sample, n)
    probs = mask.astype(jnp.float32)
    probs = probs / jnp.maximum(jnp.sum(probs), 1.0)
    idx = jax.random.choice(key, n, shape=(sample,), p=probs,
                            replace=False)
    ref = pts[idx]                                    # (S,3)
    ref_ok = mask[idx]

    d2 = (jnp.sum(pts * pts, axis=1, keepdims=True)
          - 2.0 * pts @ ref.T
          + jnp.sum(ref * ref, axis=1)[None, :])      # (N,S)
    d2 = jnp.where(ref_ok[None, :], jnp.maximum(d2, 0.0), jnp.inf)
    k = min(nb_neighbors + 1, sample)                 # +1: self may appear
    neg_top, _ = jax.lax.top_k(-d2, k)
    dists = jnp.sqrt(jnp.maximum(-neg_top, 0.0))      # (N,k) ascending
    mean_d = jnp.mean(dists[:, 1:], axis=1)           # drop self/nearest
    valid_means = jnp.where(mask, mean_d, 0.0)
    mu = jnp.sum(valid_means) / jnp.maximum(jnp.sum(mask), 1)
    var = (jnp.sum(jnp.where(mask, (mean_d - mu) ** 2, 0.0))
           / jnp.maximum(jnp.sum(mask), 1))
    thresh = mu + std_ratio * jnp.sqrt(var)
    return mask & (mean_d <= thresh)
