"""Device-mesh scale-out: frame data-parallelism + fusion collectives.

The reference has no distributed execution at all (SURVEY.md §2.3 — the
only concurrency is detector worker threads). The scaling axis for this
workload is a 1-D `frames` mesh: captures/streams are embarrassingly
parallel through detect+PnP+pointcloud, with collectives only at the
fusion/reduction boundaries. The GPUs of one host reach each other all
to all over NVLink, so the mesh follows the frames alone:

  * `sharded_frame_pipeline` — shard a frame batch over the mesh and run
    any per-frame function with zero cross-chip traffic (pjit handles the
    rest).
  * `fuse_views_allgather`  — all-gather per-view point clouds for
    multi-view fusion.
  * `batch_stats_psum`      — global error/metric reductions via psum.

All helpers work on any mesh size including 1 (single device) and on
the CPU-backend virtual mesh used in tests.
"""
from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def frames_mesh(n_devices: int | None = None, axis: str = "frames") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def shard_batch(x: jnp.ndarray, mesh: Mesh, axis: str = "frames"):
    """Place a batched array with its leading dim sharded over the mesh."""
    return jax.device_put(x, NamedSharding(mesh, P(axis)))


def sharded_frame_pipeline(fn: Callable, mesh: Mesh, axis: str = "frames"):
    """jit `fn` (operating on a full batch) with batch-dim-sharded inputs
    and outputs. fn must be shape-polymorphic over the leading dim only in
    the sense that per-example work is independent (vmap-style)."""
    sharding = NamedSharding(mesh, P(axis))

    @functools.partial(jax.jit)
    def run(*args):
        args = tuple(jax.lax.with_sharding_constraint(a, sharding)
                     if hasattr(a, "ndim") and a.ndim >= 1 else a
                     for a in args)
        return fn(*args)

    return run


def fuse_views_allgather(mesh: Mesh, axis: str = "frames"):
    """Returns f(points (B,N,3), valid (B,N)) -> ((B_total*N,3), mask)
    gathering every device's views into a fused cloud on all devices."""

    @functools.partial(
        shard_map, mesh=mesh, check_vma=False,
        in_specs=(P(axis), P(axis)), out_specs=(P(None), P(None)))
    def fuse(pts, valid):
        all_pts = jax.lax.all_gather(pts, axis, tiled=True)
        all_valid = jax.lax.all_gather(valid, axis, tiled=True)
        return (all_pts.reshape(-1, 3), all_valid.reshape(-1))

    return fuse


def batch_stats_psum(mesh: Mesh, axis: str = "frames"):
    """Returns f(values (B,), mask (B,)) -> (mean, count) reduced over the
    whole sharded batch with psum."""

    @functools.partial(
        shard_map, mesh=mesh, check_vma=False,
        in_specs=(P(axis), P(axis)), out_specs=(P(), P()))
    def stats(v, m):
        s = jax.lax.psum(jnp.sum(jnp.where(m, v, 0.0)), axis)
        c = jax.lax.psum(jnp.sum(m.astype(jnp.float32)), axis)
        return s / jnp.maximum(c, 1.0), c

    return stats
