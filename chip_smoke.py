#!/usr/bin/env python3
"""Smoke test of the main path on the GPU, through the public entry points.

    python chip_smoke.py               # one GPU: every phase below
    python chip_smoke.py --four-cards  # four GPUs: the sharded phase only

Phases (each raises on failure; nothing is caught):

  1. device     — a GPU must be JAX's default device, else exit non-zero
  2. pipeline   — `__graft_entry__.entry()`, then `process_frames` on 16
                  seeded 720p frames, checked against plain references:
                  analytic tag corners, the render's pose, a numpy
                  deprojection, and the same program on the CPU backend
  3. robust     — the staged robust ladder on 8 seeded 720p frames with
                  20-26 px tags, which decimated detection misses, so the
                  full-resolution stages run
  4. registration — the 1M-point registration recipe with its own gate
  (four cards) — `sharded_frame_pipeline` over a 4-GPU frames mesh plus
                  `fuse_views_allgather` and `batch_stats_psum`, against
                  single-card `process_frames` on the same frames

The last line of standard output is one JSON object naming the device.
Times printed on the way are information, not measurements of record.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

# the CPU backend serves the CPU-vs-GPU comparison in this same process
_platforms = os.environ.get("JAX_PLATFORMS", "")
if _platforms and "cpu" not in _platforms.split(","):
    os.environ["JAX_PLATFORMS"] = _platforms + ",cpu"

import jax  # noqa: E402
import numpy as np  # noqa: E402

BATCH = 16
H, W = 720, 1280
TAG_ID = 9
# analytic-corner gate for the bench frame's 216 px tag: its render takes
# one sample per pixel, so each border edge is quantized to pixel centers
# (up to 0.5 px), and the refiner places edges 0.25-0.75 px outward on
# such renders; with the frames' pixel noise the worst corner of 16
# frames lands ~2 px off (the same on the tree before the GPU port)
CORNER_TOL_PX = 2.5
# pose gates: the depth-corrected anchor position is read off the depth
# image (exact here); rotation of a fronto-parallel 216 px tag is weakly
# determined by its corners, and the corner offsets above tilt it by up
# to ~2.5 degrees (also the same before the GPU port)
# the ladder's small tags: median over frames (see phase_robust)
ROBUST_CORNER_TOL_PX = 1.0
POSE_TOL_M = 0.005
POSE_TOL_DEG = 3.0
# planar cloud vs a float64 numpy deprojection: the f32 chain
# depth*scale, (u-cx)*z, *(1/fx) rounds ~3 times (~2e-7 relative)
CLOUD_RTOL = 1e-6
CLOUD_ATOL = 1e-6          # m / color units, for values near zero
# same program on the CPU backend: the refine samplers contract bf16
# operands with f32 accumulation in another order, and GPU reductions
# associate differently, so samples differ in the last bits; where two
# gradient samples nearly tie, the peak of one of an edge's 12 profiles
# moves by an offset step (1 px in pass 1, 0.25 px in pass 2), and the
# line fit carries a fraction of that into the corner (0.06 px seen on
# an H100)
CPU_CORNER_TOL_PX = 0.25
CPU_FRAMES = 2


def _log(msg: str) -> None:
    print(msg, flush=True)


def _check(ok, detail) -> None:
    """Raise (not assert: the checks must survive python -O)."""
    if not ok:
        raise AssertionError(detail)


# ---------------------------------------------------------------- device
def phase_device() -> str:
    _log(f"[device] jax {jax.__version__}")
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"[device] no GPU: JAX's default device is {dev}")
    _log(f"[device] device_kind {dev.device_kind}, count "
         f"{len(jax.devices())}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    _log("[device] nvidia-smi name, power.limit:")
    for line in smi.strip().splitlines():
        _log(line.strip())
    return smi.strip().splitlines()[0].strip()


# -------------------------------------------------------- shared helpers
def _frames():
    """The bench's 16 frames: one 216 px tag 9 at 0.45 m, per-frame
    pixel noise, constant depth."""
    from bench import _frames as bench_frames

    return bench_frames(BATCH)


def _truth(K):
    """Analytic corners (4,2), pose and side length (m) of
    `_example_frame`'s tag."""
    f = float(K[0, 0])
    z = 0.45
    half = 0.3 * min(H, W) * z / f / 2.0
    obj = np.array([[-half, -half, 0], [half, -half, 0],
                    [half, half, 0], [-half, half, 0]], np.float64)
    t = np.array([0.0, 0.0, z])
    cam = obj + t
    uv = cam[:, :2] / cam[:, 2:3] * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]
    return uv, np.eye(3), t, 2.0 * half


def _angle_deg(Ra, Rb):
    c = (np.trace(Ra.T @ Rb) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def _numpy_cloud(depth_u16, rgb_u8, K, scale=0.001):
    """Planar (6, H*W) cloud in float64, independent of the package."""
    h, w = depth_u16.shape
    z = depth_u16.astype(np.float64) * scale
    v, u = np.mgrid[:h, :w].astype(np.float64)
    x = (u - K[0, 2]) * z / K[0, 0]
    y = (v - K[1, 2]) * z / K[1, 1]
    col = rgb_u8.astype(np.float64) / 255.0 * (z > 0)[..., None]
    return np.stack([x, y, z, col[..., 0], col[..., 1],
                     col[..., 2]]).reshape(6, -1)


def _run_pipeline(rgbs, depths, K, device=None):
    from repas_tpu.core.config import PipelineConfig
    from repas_tpu.pipeline import process_frames

    cfg = PipelineConfig()
    fn = jax.jit(lambda r, d: process_frames(r, d, K, cfg))
    if device is not None:
        rgbs = jax.device_put(rgbs, device)
        depths = jax.device_put(depths, device)
    return fn, rgbs, depths


# -------------------------------------------------------------- pipeline
def phase_pipeline(card: str) -> None:
    import __graft_entry__

    fn, args = __graft_entry__.entry()
    out = jax.block_until_ready(jax.jit(fn)(*args))
    ids = np.asarray(out[0])
    _log(f"[pipeline] entry() ids {ids.tolist()}")
    _check(TAG_ID in ids.tolist(), ids)

    rgbs, depths, K = _frames()
    fn, r, d = _run_pipeline(rgbs, depths, K, jax.devices()[0])
    t0 = time.perf_counter()
    compiled = fn.lower(r, d).compile()
    t_compile = time.perf_counter() - t0
    _log(f"[pipeline] cold compile of process_frames (batch {BATCH}, "
         f"{H}x{W}): {t_compile:.1f} s")
    res = jax.block_until_ready(compiled(r, d))

    ids = np.asarray(res.detections.ids)
    valid = np.asarray(res.detections.valid)
    _check((valid.sum(axis=1) == 1).all(), valid.sum(axis=1))
    _check((ids[valid] == TAG_ID).all(), ids)

    uv, R_true, t_true, side = _truth(K)
    corners = np.asarray(res.detections.corners)[valid]       # (B,4,2)
    c_err = np.linalg.norm(corners - uv[None], axis=-1)
    _log(f"[pipeline] corners vs analytic projection: max "
         f"{c_err.max():.4f} px, mean {c_err.mean():.4f} px "
         f"(tol {CORNER_TOL_PX} px)")
    _check(c_err.max() <= CORNER_TOL_PX, c_err.max())

    # tag 9 carries the fusion's 180-degree Z-flip fix; PnP assumes the
    # configured tag size, so its translation scales by size ratio
    from repas_tpu.core.config import PnPConfig

    R_flip = R_true @ np.diag([-1.0, -1.0, 1.0])
    R_avg = np.asarray(res.pose.R_avg, np.float64)
    ang = max(_angle_deg(R, R_flip) for R in R_avg)
    t_pnp = t_true * PnPConfig().tag_size_m / side
    t_err = np.abs(np.asarray(res.pose.anchor_t) - t_pnp).max()
    p_err = np.abs(np.asarray(res.pose.anchor_P_depth) - t_true).max()
    _log(f"[pipeline] fused pose vs render: rot {ang:.4f} deg, PnP t "
         f"{t_err * 1e3:.3f} mm, depth-corrected P {p_err * 1e3:.3f} mm "
         f"(tol {POSE_TOL_DEG} deg / {POSE_TOL_M * 1e3:.0f} mm)")
    _check(ang <= POSE_TOL_DEG and t_err <= POSE_TOL_M
           and p_err <= POSE_TOL_M, (ang, t_err, p_err))

    cloud = np.asarray(res.pointcloud)                        # (B,6,N)
    worst = 0.0
    for i in range(BATCH):
        ref = _numpy_cloud(depths[i], rgbs[i], K)
        np.testing.assert_allclose(cloud[i], ref, rtol=CLOUD_RTOL,
                                   atol=CLOUD_ATOL)
        worst = max(worst, float(np.max(np.abs(cloud[i] - ref)
                                        / (np.abs(ref) + CLOUD_ATOL))))
    _log(f"[pipeline] cloud vs numpy float64 deprojection: worst "
         f"|diff|/(|ref|+atol) {worst:.2e} (rtol {CLOUD_RTOL}, atol "
         f"{CLOUD_ATOL})")

    cpu = jax.devices("cpu")[0]
    fn_c, r_c, d_c = _run_pipeline(rgbs[:CPU_FRAMES], depths[:CPU_FRAMES],
                                   K, cpu)
    res_c = fn_c(r_c, d_c)
    ids_c = np.asarray(res_c.detections.ids)
    _check(np.array_equal(ids_c, ids[:CPU_FRAMES]), (ids_c, ids))
    v = valid[:CPU_FRAMES]
    dc = np.abs(np.asarray(res_c.detections.corners)[v]
                - np.asarray(res.detections.corners)[:CPU_FRAMES][v]).max()
    _log(f"[pipeline] GPU vs CPU backend on {CPU_FRAMES} frames: ids "
         f"identical, corners max |diff| {dc:.2e} px "
         f"(tol {CPU_CORNER_TOL_PX} px)")
    _check(dc <= CPU_CORNER_TOL_PX, dc)

    steps = 10
    t0 = time.perf_counter()
    for _ in range(steps):
        out = compiled(r, d)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / steps
    _log(f"[pipeline] {steps} steps: {dt * 1e3:.2f} ms per batch of "
         f"{BATCH} ({BATCH / dt:.1f} frames/s) on {card} — information, "
         f"not a claim")


# ---------------------------------------------------------------- robust
def robust_frames(n=8, seed=0):
    """n seeded 720p RGB frames, one 20-26 px tag each (random id,
    position, depth and in-plane roll) plus sigma-6 sensor noise, which
    decimated detection misses in 7 of 8 frames. Returns
    (frames (n,H,W,3) u8, ids (n,), corners (n,4,2) analytic)."""
    from repas_tpu.detect.render import render_tag_in_scene

    rng = np.random.default_rng(seed)
    f = 0.6 * W
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1.0]])
    frames, ids, corners = [], [], []
    for _ in range(n):
        tid = int(rng.integers(0, 587))
        side_px = rng.uniform(20.0, 26.0)
        z = rng.uniform(0.5, 1.5)
        u, v = rng.uniform(150, W - 150), rng.uniform(150, H - 150)
        size = side_px * z / f
        a = rng.uniform(-0.6, 0.6)
        R = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                      [0, 0, 1.0]])
        t = np.array([(u - K[0, 2]) * z / f, (v - K[1, 2]) * z / f, z])
        gray = render_tag_in_scene(tid, R, t, K, size, (H, W),
                                   supersample=2)
        gray = gray + rng.normal(0.0, 6.0, gray.shape)
        img = np.clip(np.round(gray), 0, 255).astype(np.uint8)
        frames.append(np.repeat(img[..., None], 3, axis=-1))
        half = size / 2
        obj = np.array([[-half, -half, 0], [half, -half, 0],
                        [half, half, 0], [-half, half, 0]])
        cam = obj @ R.T + t
        corners.append(cam[:, :2] / cam[:, 2:3] * f + [K[0, 2], K[1, 2]])
        ids.append(tid)
    return np.stack(frames), np.array(ids), np.stack(corners)


def _recall(det, ids, corners):
    """(found (n,) bool, corner error (n,) px or nan) for the true id."""
    d_ids = np.asarray(det.ids)
    d_valid = np.asarray(det.valid)
    d_corners = np.asarray(det.corners)
    found = np.zeros(len(ids), bool)
    err = np.full(len(ids), np.nan)
    for i, tid in enumerate(ids):
        hit = np.nonzero(d_valid[i] & (d_ids[i] == tid))[0]
        if len(hit):
            found[i] = True
            err[i] = np.linalg.norm(d_corners[i, hit[0]] - corners[i],
                                    axis=-1).max()
    return found, err


def phase_robust() -> None:
    import jax.numpy as jnp

    from repas_tpu.core.config import DetectorConfig
    from repas_tpu.detect.detector import detect_tags_batch
    from repas_tpu.detect.robust import detect_tags_robust_staged

    frames_np, ids, corners = robust_frames()
    frames = jnp.asarray(frames_np)
    cfg = DetectorConfig()
    dec_found, _ = _recall(
        jax.jit(lambda f: detect_tags_batch(f, cfg))(frames), ids, corners)
    t0 = time.perf_counter()
    det = jax.block_until_ready(detect_tags_robust_staged(frames, cfg))
    t_first = time.perf_counter() - t0
    found, err = _recall(det, ids, corners)
    t0 = time.perf_counter()
    jax.block_until_ready(detect_tags_robust_staged(frames, cfg))
    t_steady = time.perf_counter() - t0
    _log(f"[robust] decimated-only recall {dec_found.sum()}/{len(ids)}; "
         f"ladder recall {found.sum()}/{len(ids)}; corner error max "
         f"{np.nanmax(err):.3f} px, median {np.nanmedian(err):.3f} px")
    _log(f"[robust] first call {t_first:.1f} s (compile included), second "
         f"call {t_steady * 1e3:.1f} ms for {len(ids)} frames")
    # the full-resolution stages must have done the work, and done it.
    # The median gates the corners: a frame that stage A's decimated
    # pass decodes keeps that pass's corners when its margin wins the
    # merge, and decimated corners of a 20-26 px tag can sit ~3 px off
    _check(found.sum() > dec_found.sum(), (found, dec_found))
    _check(found.sum() >= 7, found)
    _check(np.nanmedian(err) <= ROBUST_CORNER_TOL_PX, err)


# ---------------------------------------------------------- registration
def phase_registration() -> None:
    from bench import _time_registration_1m

    secs, status = _time_registration_1m()
    _log(f"[registration] 1M points: status {status}, "
         f"{secs if secs is None else f'{secs:.2f} s'} "
         f"(gate: fitness >= 0.3, translation error <= 2 cm)")
    _check(status == "ok", status)


# ------------------------------------------------------------ four cards
def phase_four_cards() -> None:
    from repas_tpu.parallel.mesh import (batch_stats_psum, frames_mesh,
                                         fuse_views_allgather, shard_batch,
                                         sharded_frame_pipeline)
    from repas_tpu.core.config import PipelineConfig
    from repas_tpu.pipeline import process_frames

    n = 4
    if len(jax.devices()) < n:
        sys.exit(f"[four-cards] need {n} GPUs, have {jax.devices()}")
    rgbs, depths, K = _frames()

    fn, r1, d1 = _run_pipeline(rgbs, depths, K, jax.devices()[0])
    single = jax.block_until_ready(fn(r1, d1))

    mesh = frames_mesh(n)
    cfg = PipelineConfig()
    run = sharded_frame_pipeline(
        lambda r, d: process_frames(r, d, K, cfg), mesh)
    rs = shard_batch(jax.numpy.asarray(rgbs), mesh)
    ds = shard_batch(jax.numpy.asarray(depths), mesh)
    t0 = time.perf_counter()
    with mesh:
        out = jax.block_until_ready(run(rs, ds))
    _log(f"[four-cards] sharded process_frames over {n} GPUs, batch "
         f"{BATCH} ({BATCH // n} per card): first call "
         f"{time.perf_counter() - t0:.1f} s; output sharding "
         f"{out.pointcloud.sharding}")

    ids_s, ids_1 = np.asarray(out.detections.ids), \
        np.asarray(single.detections.ids)
    _check(np.array_equal(ids_s, ids_1), (ids_s, ids_1))
    v = np.asarray(single.detections.valid)
    dc = np.abs(np.asarray(out.detections.corners)[v]
                - np.asarray(single.detections.corners)[v]).max()
    cloud_s = np.asarray(out.pointcloud)
    cloud_1 = np.asarray(single.pointcloud)
    np.testing.assert_allclose(cloud_s, cloud_1, rtol=CLOUD_RTOL,
                               atol=CLOUD_ATOL)
    _log(f"[four-cards] vs single card: ids identical, corners max |diff| "
         f"{dc:.2e} px (tol {CPU_CORNER_TOL_PX}), cloud within rtol "
         f"{CLOUD_RTOL}")
    _check(dc <= CPU_CORNER_TOL_PX, dc)

    with mesh:
        pts = jax.numpy.moveaxis(out.pointcloud[:, :3, :], 1, -1)
        valid = out.pointcloud[:, 2, :] > 0
        fused_pts, fused_mask = fuse_views_allgather(mesh)(pts, valid)
        mean_z, count = batch_stats_psum(mesh)(
            out.pointcloud[:, 2, :].mean(axis=1),
            jax.numpy.ones((BATCH,), bool))
        jax.block_until_ready((fused_pts, fused_mask, mean_z, count))
    # the all-gather is a copy: bit-equal to the sharded clouds, and so
    # within the cloud tolerance of the single-card ones
    np.testing.assert_array_equal(
        np.asarray(fused_pts),
        np.moveaxis(cloud_s[:, :3, :], 1, -1).reshape(-1, 3))
    _check(np.array_equal(np.asarray(fused_mask),
                          (cloud_1[:, 2, :] > 0).reshape(-1)), "fused mask")
    # float64 reference; the device sums 921,600 f32 depths per frame in
    # its own order, ~1e-7 relative per addition level
    ref_mean = float(cloud_1[:, 2, :].astype(np.float64).mean())
    _check(int(count) == BATCH, count)
    _check(abs(float(mean_z) - ref_mean) <= 1e-5 * abs(ref_mean),
           (float(mean_z), ref_mean))
    _log(f"[four-cards] fuse_views_allgather {tuple(fused_pts.shape)} "
         f"matches the single-card clouds; batch_stats_psum mean_z "
         f"{float(mean_z):.6f} (ref {ref_mean:.6f}), count {int(count)}")


def main() -> None:
    four = "--four-cards" in sys.argv[1:]
    card = phase_device()

    from repas_tpu.utils.compile_cache import configure_compile_cache

    _log(f"[device] compile cache {configure_compile_cache()}")
    phases = ([phase_four_cards] if four else
              [lambda: phase_pipeline(card), phase_robust,
               phase_registration])
    for phase in phases:
        t0 = time.perf_counter()
        phase()
        _log(f"[time] phase done in {time.perf_counter() - t0:.1f} s")
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
