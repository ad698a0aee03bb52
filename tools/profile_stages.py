#!/usr/bin/env python3
"""Stage-level timing of the headline detector pipeline on JAX's default
device (the GPU; JAX_PLATFORMS=cpu for a CPU dry run, whose times
describe XLA's CPU backend only).

    python tools/profile_stages.py

Builds one jitted sub-program per cumulative stage prefix and times each;
stage cost = successive difference. Each timing ends with a device-side
scalar reduce pulled to the host.
"""
from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from repas_tpu.core.config import DetectorConfig, PipelineConfig
from repas_tpu.detect import tag_families
from repas_tpu.detect.detector import (_decode_quad, _quad_from_support,
                                       _refine_edges, _support_points,
                                       detect_tags)
from repas_tpu.kernels.ccl import connected_components, top_k_components
from repas_tpu.kernels.image import (adaptive_threshold, bilinear_sample_patch,
                                     decimate, rgb_to_gray)
from repas_tpu.kernels.pointcloud import fused_pointcloud
from repas_tpu.pipeline import process_frames
from repas_tpu.utils.compile_cache import configure_compile_cache

BATCH = int(os.environ.get("PROF_BATCH", "16"))
ITERS = int(os.environ.get("PROF_ITERS", "10"))
H, W = 720, 1280


def _frames():
    from __graft_entry__ import _example_frame
    rgb, depth, K = _example_frame(H, W)
    rng = np.random.default_rng(0)
    rgbs = np.clip(np.stack([rgb] * BATCH).astype(np.int16)
                   + rng.integers(-8, 8, (BATCH, H, W, 3)), 0, 255
                   ).astype(np.uint8)
    return jnp.asarray(rgbs), jnp.asarray(np.stack([depth] * BATCH)), K


def _stage_prefix(img, config: DetectorConfig, upto: str):
    """Run detector stages up to `upto`, return a scalar."""
    gray = rgb_to_gray(img)
    h, w = gray.shape
    dec = max(1, int(config.quad_decimate))
    gray_lo = decimate(gray, dec) if dec > 1 else gray
    hl, wl = gray_lo.shape
    if upto == "gray":
        return jnp.sum(gray_lo)
    binary, ambiguous = adaptive_threshold(gray_lo, tile=config.tile,
                                           min_contrast=config.min_contrast)
    dark = (~binary) & (~ambiguous)
    if upto == "thresh":
        return jnp.sum(dark)
    labels = connected_components(dark, iters=config.ccl_iters)
    if upto == "ccl":
        return jnp.sum(labels)
    roots, areas, valid_c, bbox = top_k_components(
        labels, config.max_components,
        min_area=config.min_area_px / (dec * dec),
        max_area=config.max_area_frac * hl * wl, ring_filter=True,
        min_side=8.0 / dec, return_bbox=True)
    if upto == "topk":
        return jnp.sum(roots) + jnp.sum(areas)
    sup = _support_points(labels, roots, bbox)
    if upto == "support":
        return jnp.sum(sup)
    quads = jax.vmap(_quad_from_support)(sup)
    if dec > 1:
        quads = quads * dec + (dec - 1) / 2.0
    if upto == "quad":
        return jnp.sum(quads)

    # ---- refine/decode sub-stages (mirrors detect_tags' patch tier) ----
    from repas_tpu.detect.detector import _PATCH

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
    row_off, rows_l = [], []
    for a in lvl_imgs:
        hl_, wl_ = a.shape
        row_off.append(sum(r.shape[0] for r in rows_l))
        rows_l.append(jnp.pad(a.astype(jnp.bfloat16),
                              ((0, max(hl_, ph) - hl_), (0, w - wl_)),
                              mode="edge"))
    pyr = jnp.concatenate(rows_l, axis=0)
    row_off = jnp.asarray(row_off, jnp.int32)
    if upto == "pyramid":
        return jnp.sum(pyr.astype(jnp.float32))

    qlo = jnp.min(quads, axis=1)
    qhi = jnp.max(quads, axis=1)
    starts_l, fits_l = [], []
    for lv in range(n_levels):
        s = 2 ** lv
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
    fits_all = jnp.stack(fits_l, axis=1)
    fits = jnp.any(fits_all, axis=1)
    lvl = jnp.where(fits, jnp.argmax(fits_all, axis=1),
                    n_levels - 1).astype(jnp.int32)
    starts = jnp.take_along_axis(
        jnp.stack(starts_l, axis=1), lvl[:, None, None], axis=1)[:, 0]
    scale = jnp.exp2(lvl.astype(jnp.float32))[:, None, None]
    from repas_tpu.kernels.patch_extract import extract_patches_pyramid
    patches = extract_patches_pyramid(
        pyr, row_off[lvl] + starts[:, 1], starts[:, 0], ph, pw)
    if upto == "patches":
        return jnp.sum(patches.astype(jnp.float32))
    off = starts.astype(jnp.float32)[:, None, :]
    q_rel = (quads - (scale - 1) / 2.0) / scale - off
    if upto == "samp1":
        # sampler-only cost of refine pass 1: same sample positions, no
        # gradient/line-fit/intersection chain
        def samp_only(p, q):
            rolled = jnp.roll(q, -1, axis=0)
            ts = jnp.linspace(0.12, 0.88, 12)
            search = 2.0 + dec
            offs = jnp.linspace(-search, search,
                                2 * int(round(search)) + 1)
            d = rolled - q                                  # (4,2)
            n_hat = jnp.stack([-(d[:, 1]), d[:, 0]], -1)
            n_hat = n_hat / (jnp.linalg.norm(n_hat, axis=-1,
                                             keepdims=True) + 1e-9)
            base = q[:, None, :] + ts[None, :, None] * d[:, None, :]
            pts = base[:, :, None, :] + offs[None, None, :, None] \
                * n_hat[:, None, None, :]
            return jnp.sum(bilinear_sample_patch(p, pts))
        return jnp.sum(jax.vmap(samp_only)(patches, q_rel))
    q_ref = jax.vmap(lambda p, q: _refine_edges(
        p, q, search=2.0 + dec, offset_step=1.0,
        sampler=bilinear_sample_patch))(patches, q_rel)
    if upto == "refine1":
        return jnp.sum(q_ref)
    q_ref = jax.vmap(lambda p, q: _refine_edges(
        p, q, search=1.0, offset_step=0.25,
        sampler=bilinear_sample_patch))(patches, q_ref)
    if upto == "refine2":
        return jnp.sum(q_ref)
    raise ValueError(upto)


def main():
    configure_compile_cache()
    print("backend:", jax.default_backend(), flush=True)
    rgbs, depths, K = _frames()
    cfg = PipelineConfig()

    def timeit(name, fn, *args):
        out = fn(*args)
        float(jnp.sum(out) if out.ndim else out)  # compile+run
        t0 = time.perf_counter()
        for _ in range(ITERS):
            out = fn(*args)
        s = float(jnp.sum(out) if out.ndim else out)
        dt = (time.perf_counter() - t0) / ITERS / BATCH * 1e3
        print(f"{name:28s} {dt:8.3f} ms/frame   (sum={s:.1f})", flush=True)
        return dt

    stages = ["gray", "thresh", "ccl", "topk", "support", "quad",
              "pyramid", "patches", "samp1", "refine1", "refine2"]
    prev = 0.0
    for st in stages:
        f = jax.jit(jax.vmap(
            lambda im, st=st: _stage_prefix(im, cfg.detector, st)))
        t = timeit(f"prefix:{st}", lambda r: jnp.sum(f(r)), rgbs)
        print(f"    stage delta {st}: {t - prev:+.3f} ms", flush=True)
        prev = t

    det = jax.jit(jax.vmap(lambda im: detect_tags(im, cfg.detector)))
    t_det = timeit("detect_tags (full)", lambda r: jnp.sum(
        det(r).decision_margin), rgbs)
    print(f"    stage delta refine+decode: {t_det - prev:+.3f} ms",
          flush=True)

    pc = jax.jit(jax.vmap(lambda d, r: jnp.sum(
        fused_pointcloud(d, r, jnp.asarray(K), scale=0.001))))
    timeit("pointcloud", lambda d, r: jnp.sum(pc(d, r)), depths, rgbs)

    pipe = jax.jit(lambda r, d: process_frames(r, d, K, cfg))
    timeit("full pipeline", lambda r, d: jnp.sum(
        pipe(r, d).pose.anchor_P_depth), rgbs, depths)


if __name__ == "__main__":
    main()
