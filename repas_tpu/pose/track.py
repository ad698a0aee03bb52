"""Temporal register-then-track pose streaming.

The reference has two temporal-tracking shapes this module mirrors:
  * the FoundationPose register-then-track loop (run_custom.py:33-76 —
    frame 0 registers, later frames call track_one with the previous pose
    as the implicit prior), and
  * the realtime per-frame AprilTag pose stream
    (realtime_pose_estimation_april_tag.py:73-76).

On-device design (instead of re-detecting every frame from scratch):

  register : full-frame detection (optionally the robust ladder) + 8-order
             IPPE PnP — the expensive, prior-free path.
  track    : a fixed-size ROI is dynamic-sliced around the tag center
             predicted from the previous pose (static shapes — one small
             XLA program, ~14x fewer pixels than 720p), the detector runs
             on the ROI only, and the pose is refined from the previous
             frame's (rvec, tvec) with Gauss-Newton — the 8-order corner
             search is skipped because the corner order is pinned once
             registered (decode fixes the tag's rotation).
  recovery : a miss (no acceptable detection in the ROI) keeps the prior
             for up to `max_misses` frames, then falls back to full-frame
             registration — the detection-failure retry ladder of
             SURVEY.md §5.3 applied in time.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from repas_tpu.core.config import DetectorConfig
from repas_tpu.core.transforms import rodrigues, rodrigues_inv
from repas_tpu.detect.detector import detect_tags
from repas_tpu.pose.pnp import (refine_pnp_gn, solve_pnp_ippe_square,
                                square_object_points)


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    roi: int = 256                 # ROI side in px (static shape)
    max_misses: int = 3            # tracked-mode failures before re-register
    max_err_px: float = 3.0        # GN reprojection gate to accept a track
    min_margin: float = 10.0       # decision-margin gate (reference's >= 10,
                                   # three_pose_vertical_translation_validation.py:38)
    gn_iters: int = 10
    robust_register: bool = False  # use the enhancement ladder on register


class TrackResult(NamedTuple):
    ok: bool
    tag_id: int
    R: np.ndarray                  # (3,3)
    t: np.ndarray                  # (3,)
    err_px: float
    mode: str                      # "track" | "register" | "lost"


def _roi_detector_config(cfg: DetectorConfig, roi: int) -> DetectorConfig:
    """Detector sized for the ROI: no decimation (the crop is small), a
    modest component budget."""
    return dataclasses.replace(
        cfg, quad_decimate=1.0,
        max_components=min(cfg.max_components, 16),
        max_detections=min(cfg.max_detections, 4))


@functools.partial(jax.jit,
                   static_argnames=("det_cfg", "roi", "gn_iters"))
def _track_roi(rgb, u0, v0, tag_id, rvec_prev, tvec_prev, K, dist,
               tag_size, det_cfg: DetectorConfig, roi: int,
               min_margin: float, gn_iters: int):
    """Detect inside rgb[v0:v0+roi, u0:u0+roi] and GN-refine the prior."""
    if rgb.ndim == 3:
        patch = jax.lax.dynamic_slice(rgb, (v0, u0, 0),
                                      (roi, roi, rgb.shape[-1]))
    else:
        patch = jax.lax.dynamic_slice(rgb, (v0, u0), (roi, roi))
    det = detect_tags(patch, det_cfg)
    off = jnp.stack([u0, v0]).astype(jnp.float32)

    match = det.valid & (det.ids == tag_id) & \
        (det.decision_margin >= min_margin)
    i = jnp.argmax(jnp.where(match, det.decision_margin, -1.0))
    found = match.any()

    corners = det.corners[i] + off[None, :]
    obj = square_object_points(tag_size)
    rvec, tvec, err = refine_pnp_gn(obj, corners, rvec_prev, tvec_prev,
                                    K, dist, iters=gn_iters)
    # fall back to the prior when the ROI lost the tag
    rvec = jnp.where(found, rvec, rvec_prev)
    tvec = jnp.where(found, tvec, tvec_prev)
    err = jnp.where(found, err, jnp.inf)
    return found, rvec, tvec, err, corners


class TagTracker:
    """Host-side streaming tracker around the jitted register/track paths.

    Usage:
        tr = TagTracker(K, dist, tag_size=0.0303)
        for frame in stream:
            res = tr.step(frame_rgb)   # TrackResult
    """

    def __init__(self, K, dist=None, tag_size: float = 0.0303,
                 config: TrackerConfig = TrackerConfig(),
                 det_cfg: DetectorConfig = DetectorConfig(),
                 tag_id: Optional[int] = None):
        self.K = jnp.asarray(K, jnp.float32)
        d = np.zeros(8, np.float32) if dist is None else \
            np.asarray(dist, np.float32).reshape(-1)
        self.dist = jnp.asarray(np.concatenate([d, np.zeros(8)])[:8],
                                jnp.float32)
        self.tag_size = float(tag_size)
        self.cfg = config
        self.det_cfg = det_cfg
        self.roi_cfg = _roi_detector_config(det_cfg, config.roi)
        self.want_id = tag_id
        self.reset()

    def reset(self):
        self._rvec = None
        self._tvec = None
        self._id = -1
        self._missed = 0

    # -- registration ------------------------------------------------
    def _register(self, rgb) -> TrackResult:
        if self.cfg.robust_register:
            from repas_tpu.detect.robust import detect_tags_robust
            det = detect_tags_robust(rgb, self.det_cfg)
        else:
            det = detect_tags(rgb, self.det_cfg)
        valid = np.asarray(det.valid) & \
            (np.asarray(det.decision_margin) >= self.cfg.min_margin)
        ids = np.asarray(det.ids)
        if self.want_id is not None:
            valid &= ids == self.want_id
        if not valid.any():
            self.reset()
            return TrackResult(False, -1, np.eye(3), np.zeros(3),
                               float("inf"), "lost")
        i = int(np.argmax(np.where(valid, np.asarray(det.decision_margin),
                                   -1.0)))
        # decoded corners are already in canonical order (detector.py:277
        # pins the rotation) — solve IPPE-square directly; the 8-order
        # search would tie across the square's 90-degree symmetries and
        # can return a z-flipped pose that poisons the GN prior
        R, t, err = solve_pnp_ippe_square(
            det.corners[i], self.K, self.dist, self.tag_size)
        R = np.asarray(R)
        t = np.asarray(t)
        err = float(err)
        if not np.isfinite(err) or err > self.cfg.max_err_px * 2:
            self.reset()
            return TrackResult(False, -1, np.eye(3), np.zeros(3), err,
                               "lost")
        self._id = int(ids[i])
        self._rvec = jnp.asarray(rodrigues_inv(jnp.asarray(R)))
        self._tvec = jnp.asarray(t, jnp.float32)
        self._missed = 0
        return TrackResult(True, self._id, R, t, err, "register")

    # -- prediction --------------------------------------------------
    def _predict_roi_origin(self, shape, roi: int) -> tuple:
        """Top-left of the ROI centered on the projected tag origin."""
        K = np.asarray(self.K)
        t = np.asarray(self._tvec)
        z = max(float(t[2]), 1e-6)
        u = K[0, 0] * float(t[0]) / z + K[0, 2]
        v = K[1, 1] * float(t[1]) / z + K[1, 2]
        h, w = shape[:2]
        u0 = int(np.clip(round(u - roi / 2), 0, max(w - roi, 0)))
        v0 = int(np.clip(round(v - roi / 2), 0, max(h - roi, 0)))
        return u0, v0

    # -- public step -------------------------------------------------
    def step(self, rgb) -> TrackResult:
        rgb = jnp.asarray(rgb)
        if self._rvec is None:
            return self._register(rgb)

        roi = min(self.cfg.roi, rgb.shape[0], rgb.shape[1])
        u0, v0 = self._predict_roi_origin(rgb.shape, roi)
        found, rvec, tvec, err, corners = _track_roi(
            rgb, jnp.int32(u0), jnp.int32(v0), jnp.int32(self._id),
            self._rvec, self._tvec, self.K, self.dist, self.tag_size,
            self.roi_cfg, roi, self.cfg.min_margin,
            self.cfg.gn_iters)
        err_f = float(err)
        if bool(found) and err_f <= self.cfg.max_err_px:
            self._rvec, self._tvec = rvec, tvec
            self._missed = 0
            R = np.asarray(rodrigues(rvec))
            return TrackResult(True, self._id, R, np.asarray(tvec), err_f,
                               "track")
        self._missed += 1
        if self._missed > self.cfg.max_misses:
            return self._register(rgb)
        # hold the prior while within the miss budget
        R = np.asarray(rodrigues(self._rvec))
        return TrackResult(False, self._id, R, np.asarray(self._tvec),
                           err_f, "lost")
