#!/usr/bin/env python3
"""Headline benchmark: batched 720p detect + PnP + point-cloud loop on one
GPU (BASELINE.json configs[0]/[2] shape).

Prints the headline JSON line FIRST (flushed, so an overrun in the extras
can never destroy the measurement), then — once the extras have run
inside the internal wall-clock budget — a final, superset JSON line:

  {"metric": ..., "value": N, "unit": "frames/sec/chip", "device": {...}}

Extra fields:

  vs_design_target  fps / 30 fps (the reference's real-time stream design
                    target, better_three_capture.py:45)
  robust_real_fps   throughput of the full robust detection ladder + PnP
                    on the 8 real RealSense captures, when they are
                    mounted (null otherwise: not measured)
  registration_1m_pts_s / _status
                    wall seconds of the 1M-point registration recipe

An extra that raises is recorded in the final line and the process then
exits non-zero. Requires a GPU: there is no CPU fallback.
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

BATCH = 16
H, W = 720, 1280
# total wall-clock budget; extras are skipped once it nears exhaustion
BUDGET_S = float(os.environ.get("REPAS_BENCH_BUDGET_S", "900"))
T0 = time.time()


def _remaining():
    return BUDGET_S - (time.time() - T0)


def _frames(batch):
    from __graft_entry__ import _example_frame

    rgb, depth, K = _example_frame(H, W)
    rng = np.random.default_rng(0)
    rgbs = np.stack([rgb] * batch)
    # add noise so frames aren't byte-identical
    rgbs = np.clip(rgbs.astype(np.int16)
                   + rng.integers(-8, 8, rgbs.shape), 0, 255).astype(np.uint8)
    depths = np.stack([depth] * batch)
    return rgbs, depths, K


def _time_pipeline(batch, iters):
    import jax
    import jax.numpy as jnp

    from repas_tpu.core.config import PipelineConfig
    from repas_tpu.pipeline import process_frames

    rgbs, depths, K = _frames(batch)
    cfg = PipelineConfig()
    run = jax.jit(lambda r, d: process_frames(r, d, K, cfg))
    r = jnp.asarray(rgbs)
    d = jnp.asarray(depths)

    jax.block_until_ready(run(r, d))
    # steady state: async dispatch, one draining sync at the end (total
    # wall clock over total frames = pipeline throughput)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = run(r, d)
    jax.block_until_ready(out)
    return batch * iters / (time.perf_counter() - t0)


def _real_capture_batch():
    """The 8 checked-in 1280x720 RealSense captures (aligned + not_aligned
    testing_scripts outputs) — the honest robust-ladder workload."""
    import glob

    from repas_tpu.io.image import read_image

    paths = sorted(
        glob.glob("/root/reference/realsense_d415i/testing_scripts/"
                  "*_outputs/pose */rgb_*.png"))
    imgs = [read_image(p) for p in paths]
    imgs = [i for i in imgs if i is not None and i.shape[:2] == (720, 1280)]
    return np.stack(imgs) if imgs else None


def _time_robust_ladder():
    import jax
    import jax.numpy as jnp

    from repas_tpu.core.config import DetectorConfig, PnPConfig
    from repas_tpu.detect.robust import detect_tags_robust_staged
    from repas_tpu.pose.pnp import solve_pnp_best_order

    frames_np = _real_capture_batch()
    if frames_np is None:
        return None, None
    # pre-upload once, same methodology as the headline pipeline
    frames = jax.block_until_ready(jnp.asarray(frames_np))
    cfg = DetectorConfig()
    K = np.array([[912.35, 0, 628.78], [0, 911.78, 348.98], [0, 0, 1.0]],
                 np.float32)
    tag_size = PnPConfig().tag_size_m

    @jax.jit
    def pose_batch(corners, margins, ids_in, valid_in):
        # pose on the best slot per frame (margin-max), as the reference's
        # vis_tool_april_tag_pose_validaiton.py:49-147 does per capture
        def pose_one(c, m, i_, v_):
            i = jnp.argmax(jnp.where(v_, m, -1.0))
            R, t, err, order = solve_pnp_best_order(
                c[i], K, None, tag_size)
            return t, err, i_[i], v_[i]
        return jax.vmap(pose_one)(corners, margins, ids_in, valid_in)

    def run(batch):
        det = detect_tags_robust_staged(batch, cfg)
        return pose_batch(jnp.asarray(det.corners),
                          jnp.asarray(det.decision_margin),
                          jnp.asarray(det.ids), jnp.asarray(det.valid))

    t, err, ids, valid = run(frames)
    n_found = int(np.asarray(valid).sum())

    iters = 6
    t0 = time.perf_counter()
    for _ in range(iters):
        out = run(frames)
    jax.block_until_ready(out)
    dt = time.perf_counter() - t0
    return frames_np.shape[0] * iters / dt, n_found


def _time_registration_1m():
    """Reference-scale registration (align_postop_to_preop,
    icp_cad_model.py:62-96: 1M samples -> voxel downsample at 2% AABB
    diag -> FPFH+RANSAC on the downsampled clouds -> point-to-plane ICP
    on the FULL 1M clouds at 1.5*voxel). Returns wall seconds.

    FPFH runs on the voxel-downsampled clouds, as in the reference: on
    the raw 1M cloud at ~1 mm spacing every k-NN neighborhood is a
    locally-planar few-mm patch and all descriptors look alike."""
    import jax.numpy as jnp

    from repas_tpu.cloud.registration import register_clouds
    from repas_tpu.core.transforms import rodrigues

    n = 1_000_000
    rng = np.random.default_rng(7)
    pts = np.column_stack([
        rng.uniform(-0.5, 0.5, n), rng.uniform(-0.5, 0.5, n),
        np.zeros(n)]).astype(np.float32)
    pts[:, 2] = (0.08 * np.sin(7 * pts[:, 0]) * np.cos(5 * pts[:, 1])
                 + 0.05 * pts[:, 0] ** 2)
    tgt = jnp.asarray(pts)
    rv = np.array([0.04, -0.06, 0.30], np.float32)
    t_true = np.array([0.06, -0.04, 0.05], np.float32)
    R = np.asarray(rodrigues(jnp.asarray(rv)))
    src = jnp.asarray(((pts - t_true) @ R).astype(np.float32))
    mask = jnp.ones(n, bool)

    def run():
        res, fit_g, voxel = register_clouds(src, mask, tgt, mask, seed=7)
        return res, fit_g

    res, fit_g = run()                   # compile + correctness
    err_t = float(np.linalg.norm(np.asarray(res.T)[:3, 3] - t_true))
    if float(res.fitness) < 0.3 or err_t > 0.02:
        # NOT a silent None: a low fit at reference scale is a functional
        # defect signal, not "skip the bench"
        return None, (f"low_fitness={float(res.fitness):.3f}"
                      f"_terr={err_t:.4f}_ransac={fit_g:.3f}")
    t0 = time.perf_counter()
    run()
    return time.perf_counter() - t0, "ok"


def _record(fps, robust_fps, n_found, reg_1m_s=None, reg_1m_status=None):
    import jax

    dev = jax.devices()[0]
    return {
        "metric": "detect_pnp_pointcloud_720p",
        "value": round(fps, 2),
        "unit": "frames/sec/chip",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "vs_design_target": round(fps / 30.0, 2),
        "mpts_per_s": round(fps * H * W / 1e6, 1),
        "robust_real_fps": round(robust_fps, 2) if robust_fps else None,
        "robust_tags_found": n_found,
        "registration_1m_pts_s": round(reg_1m_s, 2) if reg_1m_s else None,
        # ok / low_fitness=<f> / exception=<type>: distinguishes "not
        # measured this run" (null) from "ran and broke"
        "registration_1m_status": reg_1m_status,
    }


def main():
    import jax

    from repas_tpu.utils.compile_cache import configure_compile_cache

    configure_compile_cache()
    if jax.devices()[0].platform != "gpu":
        sys.exit(f"bench.py needs a GPU, found {jax.devices()}")

    # ---- headline FIRST; its JSON line survives any later overrun ----
    fps = _time_pipeline(BATCH, 10)
    print(json.dumps(_record(fps, None, None)), flush=True)

    # ---- extras, each wall-clock gated ------------------------------
    results = {}
    failed = []

    def _run_robust():
        r, n = _time_robust_ladder()
        results["robust_fps"] = r
        results["n_found"] = n

    def _run_reg():
        r, status = _time_registration_1m()
        results["reg_1m_status"] = status
        results["reg_1m_s"] = r

    for name, min_s, fn in [("robust", 90, _run_robust),
                            ("reg1m", 240, _run_reg)]:
        if _remaining() <= min_s:
            continue
        try:
            fn()
        except Exception as e:  # noqa: BLE001 — recorded, then exit 1
            failed.append(name)
            print(json.dumps({"extra_failed": name,
                              "exception": type(e).__name__,
                              "detail": str(e)[:200]}),
                  file=sys.stderr, flush=True)
            if name == "reg1m":
                results["reg_1m_status"] = f"exception={type(e).__name__}"

    print(json.dumps(_record(fps, results.get("robust_fps"),
                             results.get("n_found"),
                             results.get("reg_1m_s"),
                             results.get("reg_1m_status"))),
          flush=True)
    if failed:
        sys.exit(f"extras failed: {failed}")


if __name__ == "__main__":
    main()
