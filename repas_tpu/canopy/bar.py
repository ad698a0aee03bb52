"""Aluminum-bar detection: Canny -> Hough -> rotation (C20 step 1,
canopy_return_upgraded.py:11-95).

cv2.Canny + cv2.HoughLinesP become device kernels:
  * Canny: blur, Sobel, direction-quantized non-max suppression, double
    threshold, hysteresis by iterated dilation of strong edges through the
    weak mask.
  * Hough: one scatter-add accumulator over (theta, rho) bins fed by edge
    pixels (the data-parallel dual of the C++ probabilistic line scan);
    line endpoints recovered by projecting near-line edge pixels onto the
    line direction.

The bar filter matches the reference: length >= 10% of image width and
|angle| < 20 deg (lines 48-51); the selected line's angle drives a
warpAffine rotation about the image center with white border fill
(lines 64-79).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from repas_tpu.kernels.image import (gaussian_blur, get_rotation_matrix_2d,
                                     rgb_to_gray, sobel, warp_affine)


@functools.partial(jax.jit, static_argnames=("hysteresis_iters",))
def canny_edges(gray: jnp.ndarray, low: float = 50.0, high: float = 150.0,
                sigma: float = 1.1, hysteresis_iters: int = 16) -> jnp.ndarray:
    """cv2.Canny(blurred, low, high) equivalent -> bool edge map.

    The reference blurs with GaussianBlur((5,5),0) first
    (canopy_return_upgraded.py:26-27); sigma 1.1 matches OpenCV's default
    sigma for ksize 5.
    """
    g = gaussian_blur(gray.astype(jnp.float32), sigma, radius=2)
    gx, gy = sobel(g)
    mag = jnp.sqrt(gx * gx + gy * gy)

    # non-max suppression along quantized gradient direction
    ang = jnp.arctan2(gy, gx)                      # [-pi, pi]
    a = jnp.rad2deg(ang) % 180.0
    p = jnp.pad(mag, 1)
    n = {
        0: (p[1:-1, 2:], p[1:-1, :-2]),            # E/W
        45: (p[:-2, 2:], p[2:, :-2]),              # NE/SW
        90: (p[:-2, 1:-1], p[2:, 1:-1]),           # N/S
        135: (p[:-2, :-2], p[2:, 2:]),             # NW/SE
    }
    sel = jnp.where(a < 22.5, 0,
                    jnp.where(a < 67.5, 45,
                              jnp.where(a < 112.5, 90,
                                        jnp.where(a < 157.5, 135, 0))))
    keep = jnp.zeros_like(mag, dtype=bool)
    for q, (n1, n2) in n.items():
        k = (mag >= n1) & (mag >= n2)
        keep = jnp.where(sel == q, k, keep)
    nms = jnp.where(keep, mag, 0.0)

    strong = nms >= high
    weak = nms >= low

    def body(_, s):
        grown = jax.lax.reduce_window(
            s.astype(jnp.float32), -jnp.inf, jax.lax.max, (3, 3), (1, 1),
            "SAME") > 0
        return s | (grown & weak)

    return jax.lax.fori_loop(0, hysteresis_iters, body, strong)


class HoughLine(NamedTuple):
    found: jnp.ndarray        # () bool
    angle_deg: jnp.ndarray    # signed angle of the segment (atan2 dy,dx)
    p0: jnp.ndarray           # (2,) segment start (pixel)
    p1: jnp.ndarray           # (2,) segment end
    coverage: jnp.ndarray     # length / image width
    length: jnp.ndarray


@functools.partial(jax.jit, static_argnames=("n_theta", "rho_step",
                                              "max_edges"))
def hough_horizontal_bar(edges: jnp.ndarray, threshold: int = 50,
                         min_line_frac: float = 0.1,
                         max_angle_deg: float = 20.0,
                         n_theta: int = 41, rho_step: float = 1.0,
                         max_edges: int = 16384) -> HoughLine:
    """Find the dominant near-horizontal line among edge pixels.

    Specialization of HoughLinesP to the reference's filter (length >=
    min_line_frac * width, |angle| < max_angle_deg): only angles within
    the band are binned. Returns the longest qualifying line.

    Edge pixels are compacted to `max_edges` slots first (edges are ~2-5%
    of pixels) so the (theta x edge) vote pass is one small scatter
    instead of n_theta full-image scatters.
    """
    h, w = edges.shape
    e_flat = edges.reshape(-1)
    # compact edge pixels: top-k over the edge indicator yields the set
    scores, idx = jax.lax.top_k(e_flat.astype(jnp.float32), max_edges)
    valid = scores > 0
    xs = (idx % w).astype(jnp.float32)
    ys = (idx // w).astype(jnp.float32)

    # line angle band +-max_angle_deg around horizontal -> normal angles
    # around vertical
    line_angles = jnp.linspace(-max_angle_deg, max_angle_deg, n_theta)
    theta = jnp.deg2rad(line_angles + 90.0)        # normal direction
    ct, st = jnp.cos(theta), jnp.sin(theta)

    diag = float(np.hypot(h, w))
    n_rho = int(np.ceil(2 * diag / rho_step)) + 1

    # one scatter over all (theta, edge) pairs
    rho_all = xs[None, :] * ct[:, None] + ys[None, :] * st[:, None] + diag
    b = jnp.clip((rho_all / rho_step).astype(jnp.int32), 0, n_rho - 1)
    flat_bins = (jnp.arange(n_theta, dtype=jnp.int32)[:, None] * n_rho + b)
    flat_bins = jnp.where(valid[None, :], flat_bins, n_theta * n_rho)
    acc = jnp.zeros(n_theta * n_rho + 1, jnp.float32).at[
        flat_bins.reshape(-1)].add(1.0)[:-1]

    # find peak bin
    flat = jnp.argmax(acc)
    ti = flat // n_rho
    ri = flat % n_rho
    votes = acc[flat]
    c, s = ct[ti], st[ti]
    rho = ri.astype(jnp.float32) * rho_step - diag

    # endpoints: edge pixels within 2px of the line, min/max along it
    d = jnp.abs(xs * c + ys * s - rho)
    on = valid & (d < 2.0)
    tdir = jnp.stack([-s, c])                        # line direction
    tproj = xs * tdir[0] + ys * tdir[1]
    tmin = jnp.min(jnp.where(on, tproj, jnp.inf))
    tmax = jnp.max(jnp.where(on, tproj, -jnp.inf))
    base = rho * jnp.stack([c, s])
    p0 = base + tmin * tdir
    p1 = base + tmax * tdir
    length = jnp.maximum(tmax - tmin, 0.0)
    coverage = length / w
    dxy = p1 - p0
    angle = jnp.rad2deg(jnp.arctan2(dxy[1], dxy[0]))
    # normalize to (-90, 90]
    angle = jnp.where(angle > 90.0, angle - 180.0,
                      jnp.where(angle <= -90.0, angle + 180.0, angle))
    found = (votes >= threshold) & (coverage >= min_line_frac) & \
            (jnp.abs(angle) < max_angle_deg)
    return HoughLine(found=found, angle_deg=angle, p0=p0, p1=p1,
                     coverage=coverage, length=length)


def detect_bar(rgb: jnp.ndarray, canny_low: float = 50.0,
               canny_high: float = 150.0, hough_threshold: int = 50,
               min_coverage: float = 0.1,
               max_bar_angle_deg: float = 20.0):
    """Bar line + rotation matrix WITHOUT warping the image.

    The reference rotates the whole frame so the bar is horizontal and
    segments in the rotated frame (canopy_return_upgraded.py:11-95); a
    full-image bilinear warp is a gather per pixel, and the
    rotated-frame row coordinate of any pixel is just an affine form
    yr = M10 x + M11 y + M12 — so the pipeline measures 'highest plant
    pixel above the bar' by projecting mask pixels directly
    (height.py), no warp needed. Returns (line, M)."""
    gray = rgb_to_gray(rgb)
    edges = canny_edges(gray, canny_low, canny_high)
    line = hough_horizontal_bar(edges, threshold=hough_threshold,
                                min_line_frac=min_coverage,
                                max_angle_deg=max_bar_angle_deg)
    h, w = gray.shape
    M = get_rotation_matrix_2d((w // 2, h // 2), line.angle_deg, 1.0)
    M = jnp.where(line.found, M,
                  get_rotation_matrix_2d((w // 2, h // 2), 0.0, 1.0))
    return line, M


def detect_rotate_bar(rgb: jnp.ndarray, canny_low: float = 50.0,
                      canny_high: float = 150.0, hough_threshold: int = 50,
                      min_coverage: float = 0.1,
                      max_bar_angle_deg: float = 20.0):
    """detect_rotate_aluminum_bar_edges equivalent
    (canopy_return_upgraded.py:11-95).

    Returns (line: HoughLine, rotation_M (2,3), rotated_rgb) — the image
    rotated by the bar angle about its center with white border, and the
    affine used (for inverse point mapping).
    """
    gray = rgb_to_gray(rgb)
    edges = canny_edges(gray, canny_low, canny_high)
    line = hough_horizontal_bar(edges, threshold=hough_threshold,
                                min_line_frac=min_coverage,
                                max_angle_deg=max_bar_angle_deg)
    h, w = gray.shape
    # cv2.getRotationMatrix2D(center, angle, 1.0) with angle = bar angle
    M = get_rotation_matrix_2d((w // 2, h // 2), line.angle_deg, 1.0)
    M = jnp.where(line.found, M, get_rotation_matrix_2d((w // 2, h // 2), 0.0, 1.0))
    rotated = warp_affine(rgb.astype(jnp.float32), M, border_value=255.0)
    return line, M, rotated
