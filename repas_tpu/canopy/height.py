"""Plant-height measurement pipeline (C20,
process_canopy_detection canopy_return_upgraded.py:430-558).

Steps (reference line cites inline):
  1. bar detect + image rotation                       (:11-95)
  2. bar midpoint -> median depth (5 then 11) -> 3D    (:350-399)
  3. background removal (GrabCut-lite)                 (:97-117)
  4. strict green mask + morphology                    (:119-131)
  5. canopy mark: highest plant pixel                  (:133-151)
  6. inverse-rotate canopy pixel to original coords    (:230-247)
  7. median depth at canopy -> deproject               (:310-348)
  8. height = bar_Y - canopy_Y (abs)                   (:401-428)
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from repas_tpu.canopy.bar import detect_bar
from repas_tpu.canopy.segment import (apply_green_mask, green_seed_mask,
                                      refine_plant_mask)
from repas_tpu.core.config import CanopyConfig
from repas_tpu.kernels.image import invert_affine, transform_points_2d
from repas_tpu.kernels.pointcloud import (masked_median_depth_window,
                                           median_depth_window)
from repas_tpu.kernels.project import deproject_pixels


class CanopyResult(NamedTuple):
    found: jnp.ndarray           # () bool
    plant_height_m: jnp.ndarray  # ()
    canopy_3d: jnp.ndarray       # (3,)
    bar_3d: jnp.ndarray          # (3,)
    canopy_px: jnp.ndarray       # (2,) original-image pixel
    canopy_px_rot: jnp.ndarray   # (2,) bar-aligned-frame coords
    bar_px: jnp.ndarray          # (2,)
    rotation_deg: jnp.ndarray    # ()
    plant_mask: jnp.ndarray      # (H,W) bool (unrotated, decimated)


def measure_plant_height(rgb: jnp.ndarray, depth_m: jnp.ndarray, K,
                         cfg: CanopyConfig = CanopyConfig()) -> CanopyResult:
    """rgb (H,W,3) uint8, depth_m (H,W) aligned depth in meters, K (3,3).

    The 2-D stages (Canny/Hough/rotation/segmentation) run at
    1/cfg.proc_decimate resolution — full-image gathers/scatters dominate
    them, and the pipeline's outputs are depth-gated 3-D points whose
    precision is set by the depth lookup, not 2-D pixel quantization.
    Depth lookups and deprojection use the full-resolution image and K.
    """
    from repas_tpu.kernels.image import decimate

    K = jnp.asarray(K, jnp.float32)
    dec = max(1, int(cfg.proc_decimate))
    if dec > 1:
        rgb_proc = jnp.stack([decimate(rgb[..., c], dec) for c in range(3)],
                             axis=-1)
    else:
        rgb_proc = rgb

    def to_full(px):
        return px * dec + (dec - 1) / 2.0

    # 1. bar line + rotation matrix — NO image warp: the reference
    # rotates the frame so the bar is horizontal, segments, takes the
    # highest mask row, and inverse-rotates the point
    # (canopy_return_upgraded.py:133-151). The rotated-frame row of any
    # pixel is the affine form yr = M10 x + M11 y + M12, so 'highest
    # plant pixel above the bar' is a masked min of that elementwise
    # field — a full-image bilinear warp (a gather per pixel) never has
    # to happen.
    line, M = detect_bar(
        rgb_proc, cfg.canny_low, cfg.canny_high,
        max(1, cfg.hough_threshold // dec),
        cfg.min_coverage, cfg.max_bar_angle_deg)

    # 2. bar 3D at segment midpoint in ORIGINAL full-res image coords
    bar_px = to_full((line.p0 + line.p1) / 2.0)
    bu = jnp.round(bar_px[0]).astype(jnp.int32)
    bv = jnp.round(bar_px[1]).astype(jnp.int32)
    bz = median_depth_window(depth_m, bu, bv, cfg.depth_win)
    bz = jnp.where(bz > 0, bz,
                   median_depth_window(depth_m, bu, bv,
                                       cfg.depth_fallback_win))
    bar_3d = deproject_pixels(bar_px, bz, K)

    # 3-4. segmentation on the (unrotated) decimated image
    seed = green_seed_mask(rgb_proc, cfg.green_seed_lo, cfg.green_seed_hi)
    fg = refine_plant_mask(rgb_proc, seed, iters=cfg.grabcut_iters)
    plant = apply_green_mask(rgb_proc, fg, cfg.green_lo, cfg.green_hi,
                             cfg.morph_kernel)

    # 4b. full-resolution tip recovery: a 1-2 px leaf tip does not
    # survive decimation + 3x3 opening, so the canopy mark lands several
    # pixels below the real plant top (measured on the checked-in canopy
    # captures: decimated-mask top row 302-308 vs 294-296 for the
    # full-res strict-green mask — a 10-20 mm canopy_y error; the
    # reference's own GrabCut loses the same tip in 3 of 4 captures,
    # which is why its recorded canopy_y values scatter 21.7 mm over a
    # static plant). Geodesic reconstruction grows the upsampled plant
    # mask into the FULL-RES strict-green mask: tips connected to the
    # plant body are recovered exactly; isolated specks stay excluded.
    # Cost: elementwise HSV + ~16 3x3 dilations at full res — stencil
    # passes, no gathers.
    from repas_tpu.canopy.segment import _reconstruct_by_dilation
    from repas_tpu.kernels.image import hsv_in_range, rgb_to_hsv_cv

    if dec > 1:
        hf, wf = rgb.shape[0], rgb.shape[1]
        strict_full = hsv_in_range(rgb_to_hsv_cv(rgb), cfg.green_lo,
                                   cfg.green_hi)
        marker = jnp.repeat(jnp.repeat(plant, dec, axis=0), dec, axis=1)
        marker = jnp.pad(marker, ((0, hf - marker.shape[0]),
                                  (0, wf - marker.shape[1])))
        plant_scan = _reconstruct_by_dilation(marker, strict_full,
                                              cfg.tip_reconstruct_iters)
        # full-res pixel -> proc coords (low-res pixel i covers full-res
        # [i*dec, i*dec+dec-1])
        def to_proc(v):
            return (v - (dec - 1) / 2.0) / dec
    else:
        plant_scan = plant

        def to_proc(v):
            return v

    # 5. canopy mark via projection into the bar-aligned frame (scan at
    # full resolution; M is a proc-coordinate affine, so project the
    # proc-mapped full-res grid)
    hs, ws = plant_scan.shape
    xg = to_proc(jax.lax.broadcasted_iota(jnp.float32, (hs, ws), 1))
    yg = to_proc(jax.lax.broadcasted_iota(jnp.float32, (hs, ws), 0))
    yr = M[1, 0] * xg + M[1, 1] * yg + M[1, 2]
    xr = M[0, 0] * xg + M[0, 1] * yg + M[0, 2]
    yr_m = jnp.where(plant_scan, yr, jnp.inf)
    y_top = jnp.min(yr_m)
    c_found = jnp.isfinite(y_top)
    # the reference takes the median x of the top mask row; the top
    # 'row' here is the band of rotated-frame rows within one full-res
    # pixel of the minimum
    band = plant_scan & (yr_m < y_top + 1.0 / dec)
    xr_band = jnp.sort(jnp.where(band, xr, jnp.inf).reshape(-1))
    cnt = jnp.sum(band)
    x_top = xr_band[jnp.maximum((cnt - 1) // 2, 0)]
    canopy_rot = jnp.stack([x_top, y_top])

    # 6. inverse-rotate the point, then map to full-res original coords
    Minv = invert_affine(M)
    canopy_px = to_full(transform_points_2d(Minv, canopy_rot))

    # 7. canopy depth + 3D. The tip is 1-2 px wide, so the depth camera
    # often reads the BACKGROUND through it (measured 7.9 m vs the true
    # 1.07 m); anchor the lookup to plant-mask pixels in a wider window
    # first, then fall back to the reference's plain medians.
    cu = jnp.round(canopy_px[0]).astype(jnp.int32)
    cv = jnp.round(canopy_px[1]).astype(jnp.int32)
    cz = masked_median_depth_window(depth_m, plant_scan, cu, cv,
                                    cfg.canopy_depth_win)
    cz = jnp.where(cz > 0, cz,
                   median_depth_window(depth_m, cu, cv, cfg.depth_win))
    cz = jnp.where(cz > 0, cz,
                   median_depth_window(depth_m, cu, cv,
                                       cfg.depth_fallback_win))
    canopy_3d = deproject_pixels(canopy_px, cz, K)

    # 8. height
    height = jnp.abs(bar_3d[1] - canopy_3d[1])
    found = line.found & c_found & (bz > 0) & (cz > 0)
    return CanopyResult(
        found=found, plant_height_m=height, canopy_3d=canopy_3d,
        bar_3d=bar_3d, canopy_px=canopy_px, canopy_px_rot=canopy_rot,
        bar_px=bar_px, rotation_deg=line.angle_deg, plant_mask=plant)
