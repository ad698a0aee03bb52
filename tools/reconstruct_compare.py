#!/usr/bin/env python3
"""Quality/timing comparison of the reconstruction paths at reference
scale (VERDICT r4 next #5): FFT-Poisson (dim 128/256) vs ball-pivoting
on a ~1M-point oriented cloud, the scale ply_to_stl.py:65-91 feeds its
Poisson(depth 9) / BPA calls.

Emits one JSON line per configuration:
  {"method": ..., "n_pts": ..., "wall_s": ..., "tris": ...,
   "rmse_mm": ..., "p95_mm": ...}
where rmse/p95 are vertex-to-true-surface distances on an analytic
test surface (sphere r=0.1 m), so quality is measured against ground
truth rather than against another reconstruction.

Runs on JAX's default device (the GPU); JAX_PLATFORMS=cpu runs it on the
CPU backend with a smaller default n.
"""
from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def sphere_cloud(n, r=0.1, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    from repas_tpu.io.ply import PointCloud
    return PointCloud(points=(v * r).astype(np.float32),
                      normals=v.astype(np.float32))


def vertex_err_mm(mesh, r=0.1):
    d = np.abs(np.linalg.norm(np.asarray(mesh.vertices), axis=1) - r)
    return (float(np.sqrt(np.mean(d ** 2)) * 1e3),
            float(np.quantile(d, 0.95) * 1e3))


def main():
    import jax
    from repas_tpu.cloud.reconstruct import (ball_pivot, mean_nn_spacing,
                                             reconstruct_surface)
    from repas_tpu.utils.compile_cache import configure_compile_cache

    configure_compile_cache()

    on_cpu = jax.default_backend() == "cpu"
    n = int(os.environ.get("RC_N", "200000" if on_cpu else "1000000"))
    pc = sphere_cloud(n)
    print(json.dumps({"backend": jax.default_backend(), "n_pts": n}),
          flush=True)

    for dim in (128, 256):
        t0 = time.perf_counter()
        mesh = reconstruct_surface(pc, dim=dim)     # includes host
        dt = time.perf_counter() - t0               # surface-nets tier
        rmse, p95 = vertex_err_mm(mesh)
        print(json.dumps({"method": f"fft_poisson_{dim}", "n_pts": n,
                          "wall_s": round(dt, 2),
                          "tris": len(mesh.triangles),
                          "rmse_mm": round(rmse, 3),
                          "p95_mm": round(p95, 3)}), flush=True)

    t0 = time.perf_counter()
    sp = mean_nn_spacing(np.asarray(pc.points))
    mesh = ball_pivot(pc, radii=[0.8 * sp, 1.2 * sp, 1.6 * sp])
    dt = time.perf_counter() - t0
    rmse, p95 = vertex_err_mm(mesh)
    print(json.dumps({"method": "ball_pivot", "n_pts": n,
                      "wall_s": round(dt, 2), "tris": len(mesh.triangles),
                      "rmse_mm": round(rmse, 3),
                      "p95_mm": round(p95, 3)}), flush=True)


if __name__ == "__main__":
    main()
