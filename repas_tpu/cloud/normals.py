"""Normal estimation via local PCA (Open3D estimate_normals +
orient_normals_towards_camera_location equivalents,
create_masked_ply.py:166-169, mpa_icp_export.py:176-183).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=("k", "dims", "slots", "chunk"))
def estimate_normals_grid(pts: jnp.ndarray, mask: jnp.ndarray, k: int = 16,
                          radius: float = 0.02,
                          dims: tuple = (48, 48, 48), slots: int = 48,
                          chunk: int = 65536, camera=None):
    """Reference-workload-scale normals (icp_cad_model.py samples 1M
    points): grid-hash k-NN (chunked, memory-bounded at any N) + per-chunk
    PCA, instead of estimate_normals' (N, sample) dense distance matrix
    (16 GB at N=1M). Exact same Darboux conventions/orientation.

    Returns (normals (N,3), ok (N,) bool)."""
    from repas_tpu.cloud.knn import knn_neighbors

    cam = jnp.zeros(3, pts.dtype) if camera is None else jnp.asarray(camera)
    n = pts.shape[0]
    idx, dist = knn_neighbors(pts, mask, radius, k + 1,
                              dims=dims, slots=slots)
    idx = idx[:, 1:]                       # drop self
    dist = dist[:, 1:]

    chunk = min(chunk, n)
    n_chunks = (n + chunk - 1) // chunk
    pad = n_chunks * chunk - n

    def padded(a, fill):
        fills = jnp.full((pad,) + a.shape[1:], fill, a.dtype)
        return jnp.concatenate([a, fills]).reshape((n_chunks, chunk)
                                                   + a.shape[1:])

    def chunk_fn(args):
        p, nn, d = args
        within = (d <= radius) & (nn >= 0)
        nbr = pts[jnp.maximum(nn, 0)]                     # (C,k,3)
        w = within.astype(pts.dtype)[..., None]
        cnt = jnp.maximum(jnp.sum(w, axis=1), 1.0)
        mu = jnp.sum(nbr * w, axis=1) / cnt
        dd = (nbr - mu[:, None, :]) * w
        cov = jnp.einsum("nki,nkj->nij", dd, dd)
        tr = jnp.trace(cov, axis1=1, axis2=2)[:, None, None]
        A = cov + 1e-12 * (tr + 1e-30) * jnp.eye(3)[None]
        _, vecs = jnp.linalg.eigh(A)
        nrm = vecs[:, :, 0]
        flip = jnp.sum(nrm * (cam[None, :] - p), axis=1) < 0
        nrm = jnp.where(flip[:, None], -nrm, nrm)
        ok = jnp.sum(within, axis=1) >= 3
        return nrm, ok

    nrm, ok = jax.lax.map(chunk_fn, (padded(pts, 0.0), padded(idx, -1),
                                     padded(dist, jnp.inf)))
    nrm = nrm.reshape(-1, 3)[:n]
    ok = ok.reshape(-1)[:n] & mask
    return jnp.where(ok[:, None], nrm, 0.0), ok


@functools.partial(jax.jit, static_argnames=("k", "sample"))
def estimate_normals(pts: jnp.ndarray, mask: jnp.ndarray, k: int = 30,
                     radius: float = 0.02, sample: int = 4096,
                     camera=None, key=None):
    """Per-point normals from PCA of the k nearest neighbors (within
    `radius` — Open3D hybrid search semantics), oriented toward `camera`
    (default origin, matching orient_normals_towards_camera_location).

    Neighbor search runs against a random subsample (size `sample`) of the
    cloud — one (N,S) distance-matrix product instead of a KD-tree.
    Returns (normals (N,3), ok (N,) bool).
    """
    if key is None:
        key = jax.random.PRNGKey(1)
    cam = jnp.zeros(3, pts.dtype) if camera is None else jnp.asarray(camera)
    n = pts.shape[0]
    sample = min(sample, n)  # without replacement: duplicates would
    probs = mask.astype(jnp.float32)  # degenerate the PCA neighborhoods
    probs = probs / jnp.maximum(jnp.sum(probs), 1.0)
    idx = jax.random.choice(key, n, shape=(sample,), p=probs,
                            replace=False)
    ref = pts[idx]
    ref_ok = mask[idx]

    d2 = (jnp.sum(pts * pts, axis=1, keepdims=True)
          - 2.0 * pts @ ref.T + jnp.sum(ref * ref, axis=1)[None, :])
    d2 = jnp.where(ref_ok[None, :], jnp.maximum(d2, 0.0), jnp.inf)
    neg_d2, nn = jax.lax.top_k(-d2, k)                # (N,k)
    within = (-neg_d2) <= radius * radius
    nbr = ref[nn]                                     # (N,k,3)
    w = within.astype(pts.dtype)[..., None]
    cnt = jnp.maximum(jnp.sum(w, axis=1), 1.0)
    mu = jnp.sum(nbr * w, axis=1) / cnt
    d = (nbr - mu[:, None, :]) * w
    cov = jnp.einsum("nki,nkj->nij", d, d)            # (N,3,3)

    # smallest-eigenvector of 3x3 symmetric via two inverse-power steps
    # (shift by a small ridge for invertibility)
    tr = jnp.trace(cov, axis1=1, axis2=2)[:, None, None]
    A = cov + 1e-12 * (tr + 1e-30) * jnp.eye(3)[None]

    def smallest_evec(Ai):
        wvals, vecs = jnp.linalg.eigh(Ai)
        return vecs[:, 0]

    nrm = jax.vmap(smallest_evec)(A)
    # orient toward camera
    to_cam = cam[None, :] - pts
    flip = jnp.sum(nrm * to_cam, axis=1) < 0
    nrm = jnp.where(flip[:, None], -nrm, nrm)
    ok = mask & (jnp.sum(within, axis=1) >= 3)
    nrm = jnp.where(ok[:, None], nrm, 0.0)
    return nrm, ok
