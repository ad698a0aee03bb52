"""Device-side point-cloud splat renderer.

The reference renders point clouds with a CPU software rasterizer —
project / view transform / grid / frustum culling / painter's-sort point
splatting (capture_aligned_all.py:127-186, AppState view controls :26-53).
On-device equivalent: one jitted pass

  view transform -> pinhole project -> two-pass z-buffer splat
  (scatter-min depth, then color write where a point owns its pixel)

which replaces the painter's sort entirely (a z-buffer needs no ordering,
so the whole render is two scatters — no O(N log N) host sort per frame).
Used by view_pointcloud for orbit renders and by fuse_views previews; at
~1M points a 720p frame renders in single-digit ms on one chip.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


@functools.partial(jax.jit, static_argnames=("shape", "splat"))
def render_pointcloud(xyzrgb: jnp.ndarray, K, R, t,
                      shape: tuple = (720, 1280), splat: int = 2,
                      background: float = 1.0,
                      z_near: float = 1e-3) -> jnp.ndarray:
    """Render (N,6) xyzrgb points seen from camera (R, t): x_cam = R x + t.

    Colors in [0,1] (uint8 inputs are scaled). Returns (H,W,3) float32.
    `splat` is the square splat side in pixels (2 fills typical RGB-D
    cloud density at capture resolution).
    """
    H, W = shape
    pts = xyzrgb[:, :3]
    rgb = xyzrgb[:, 3:6]
    rgb = jnp.where(jnp.max(rgb) > 1.5, rgb / 255.0, rgb)

    K = jnp.asarray(K, jnp.float32)
    cam = pts @ jnp.asarray(R, jnp.float32).T + jnp.asarray(t, jnp.float32)
    z = cam[:, 2]
    valid = z > z_near
    zs = jnp.where(valid, z, 1.0)
    u = (K[0, 0] * cam[:, 0] / zs + K[0, 2]).astype(jnp.int32)
    v = (K[1, 1] * cam[:, 1] / zs + K[1, 2]).astype(jnp.int32)

    zbuf = jnp.full((H, W), jnp.inf, jnp.float32)
    img = jnp.full((H, W, 3), background, jnp.float32)

    for dv in range(splat):
        for du in range(splat):
            uu = u + du
            vv = v + dv
            ok = valid & (uu >= 0) & (uu < W) & (vv >= 0) & (vv < H)
            ui = jnp.where(ok, uu, 0)
            vi = jnp.where(ok, vv, 0)
            zi = jnp.where(ok, z, jnp.inf)
            # pass 1: nearest depth per pixel
            zbuf = zbuf.at[vi, ui].min(zi, mode="drop")
    for dv in range(splat):
        for du in range(splat):
            uu = u + du
            vv = v + dv
            ok = valid & (uu >= 0) & (uu < W) & (vv >= 0) & (vv < H)
            ui = jnp.where(ok, uu, 0)
            vi = jnp.where(ok, vv, 0)
            # pass 2: the z-winner writes its color; losers are dropped
            # via out-of-bounds indices (duplicate-index scatter order is
            # undefined, so they must not write at all)
            win = ok & (z <= zbuf[vi, ui] * (1 + 1e-6))
            img = img.at[jnp.where(win, vi, -H - 1),
                         jnp.where(win, ui, -W - 1)].set(rgb, mode="drop")
    return img


def look_at(eye, center, up=(0.0, 1.0, 0.0)):
    """Camera (R, t) looking from `eye` at `center` (OpenCV convention:
    +z forward, +y down). Returns (R (3,3), t (3,))."""
    eye = np.asarray(eye, np.float64)
    center = np.asarray(center, np.float64)
    up = np.asarray(up, np.float64)
    fwd = center - eye
    fwd = fwd / max(np.linalg.norm(fwd), 1e-12)
    right = np.cross(fwd, up)
    if np.linalg.norm(right) < 1e-9:
        right = np.cross(fwd, np.array([1.0, 0, 0]))
    right = right / max(np.linalg.norm(right), 1e-12)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd])
    t = -R @ eye
    return R.astype(np.float32), t.astype(np.float32)


def orbit_views(center, radius: float, n: int = 8, elev_deg: float = 25.0):
    """n camera poses orbiting `center` (the view_pointcloud orbit set)."""
    out = []
    el = np.radians(elev_deg)
    for i in range(n):
        az = 2 * np.pi * i / n
        eye = np.asarray(center) + radius * np.array([
            np.cos(el) * np.sin(az), -np.sin(el), -np.cos(el) * np.cos(az)])
        out.append(look_at(eye, center))
    return out


def rasterize_segments(img: jnp.ndarray, segs, colors, K, R, t,
                       samples: int = 256) -> jnp.ndarray:
    """Overlay 3-D line segments (grid/axes/frustum wireframes from
    viz.scene) by sampling each segment and splatting — the device-side
    version of the reference's grid/axes overlay
    (capture_aligned_all.py:147-170).

    segs (S,2,3) endpoints, colors (S,3)."""
    segs = jnp.asarray(segs, jnp.float32)
    colors = jnp.asarray(colors, jnp.float32)
    ts = jnp.linspace(0.0, 1.0, samples)[None, :, None]
    pts = segs[:, None, 0, :] * (1 - ts) + segs[:, None, 1, :] * ts
    pts = pts.reshape(-1, 3)
    col = jnp.repeat(colors, samples, axis=0)
    H, W = img.shape[:2]
    K = jnp.asarray(K, jnp.float32)
    cam = pts @ jnp.asarray(R, jnp.float32).T + jnp.asarray(t, jnp.float32)
    z = cam[:, 2]
    ok = z > 1e-3
    zs = jnp.where(ok, z, 1.0)
    u = (K[0, 0] * cam[:, 0] / zs + K[0, 2]).astype(jnp.int32)
    v = (K[1, 1] * cam[:, 1] / zs + K[1, 2]).astype(jnp.int32)
    ok = ok & (u >= 0) & (u < W) & (v >= 0) & (v < H)
    return img.at[jnp.where(ok, v, -H - 1),
                  jnp.where(ok, u, -W - 1)].set(col, mode="drop")
