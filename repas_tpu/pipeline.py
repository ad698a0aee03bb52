"""The flagship end-to-end frame pipeline.

One fused, jittable function per frame (batched via vmap, sharded via
parallel.mesh): RGB + aligned u16 depth ->
  tag36h11 detection -> per-tag best-order IPPE PnP -> depth-corrected
  translation -> weighted quaternion fusion -> colored point cloud.

This is the on-device equivalent of the reference's hot loop
(better_three_capture.py streaming + mpa_final_view_with_export.py pose
stack): everything after the camera read happens in one XLA program on
device — no per-frame OpenCV/Open3D host hops.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from repas_tpu.core.config import PipelineConfig
from repas_tpu.detect.detector import Detections, detect_tags
from repas_tpu.kernels.pointcloud import depth_to_meters, fused_pointcloud
from repas_tpu.pose.fusion import FusedPose, fuse_tag_poses


class FrameResult(NamedTuple):
    detections: Detections
    pose: FusedPose
    pointcloud: jnp.ndarray      # (6, H*W) planar [x,y,z,r,g,b] rows
                                 # (kernels.pointcloud.xyzrgb_rows for
                                 #  (N,6) export layout)


@functools.partial(jax.jit, static_argnames=("config", "with_pointcloud"))
def process_frame(rgb: jnp.ndarray, depth_u16: jnp.ndarray, K,
                  config: PipelineConfig = PipelineConfig(),
                  with_pointcloud: bool = True, dist=None) -> FrameResult:
    """rgb (H,W,3) uint8, depth_u16 (H,W) uint16 aligned to color, K (3,3).

    dist: optional distortion coefficients (k1,k2,p1,p2,k3[,k4,k5,k6]) as
    produced by checkerboard calibration (checkerboard_callibration.py
    coeffs usage :241-255); None means an undistorted camera (factory
    RealSense/Femto color streams ship ~zero coeffs)."""
    K = jnp.asarray(K, jnp.float32)
    if dist is not None:
        # dist=None stays None: the PnP solvers statically skip the
        # (identity) distortion polynomial on their LM dependency chain
        dist = jnp.asarray(dist, jnp.float32).reshape(-1)[:8]
        dist = jnp.concatenate(
            [dist, jnp.zeros(8 - dist.shape[0], jnp.float32)])
    # pack RGB to one u32/pixel ONCE; grayscale and the point cloud both
    # consume the packed form (kernels/image.py pack_rgb_u32)
    if rgb.ndim == 3 and rgb.dtype == jnp.uint8:
        from repas_tpu.kernels.image import gray_from_u32, pack_rgb_u32
        packed = pack_rgb_u32(rgb)
        det = detect_tags(gray_from_u32(packed), config.detector)
        pc_rgb = packed
    else:
        det = detect_tags(rgb, config.detector)
        pc_rgb = rgb
    depth_m = depth_to_meters(depth_u16, config.depth.depth_scale)
    pose = fuse_tag_poses(
        det.corners, det.ids, det.areas, det.valid, depth_m, K,
        dist, config.pnp.tag_size_m,
        anchor_id=config.anchor_id,
        flip_z_ids=jnp.asarray(config.cad.flip_z_tag_ids, jnp.int32),
        win=config.depth.center_win)
    if with_pointcloud:
        pc = fused_pointcloud(depth_u16, pc_rgb, K,
                              scale=config.depth.depth_scale)
    else:
        pc = jnp.zeros((6, 0), jnp.float32)
    return FrameResult(detections=det, pose=pose, pointcloud=pc)


def process_frames(rgbs, depths_u16, K,
                   config: PipelineConfig = PipelineConfig(),
                   with_pointcloud: bool = True, dist=None) -> FrameResult:
    """Batched pipeline over (B,H,W,3)/(B,H,W)."""
    return jax.vmap(
        lambda r, d: process_frame(r, d, K, config, with_pointcloud, dist)
    )(rgbs, depths_u16)
