"""repas_tpu — a JAX (XLA/Pallas) RGB-D vision framework.

A ground-up rebuild of the capabilities of blanklavender/repas-vision
(AprilTag detection, 6-DOF PnP pose, depth->color alignment, point-cloud
generation/cropping, CAD placement + ICP, camera calibration, plant-canopy
height measurement) designed for an accelerator: batched frames, fused
XLA/Pallas kernels, `shard_map` scale-out over a device mesh.

Subpackage map (see SURVEY.md §7 for the blueprint):
  core/     intrinsics & calibration schemas, SO(3)/SE(3), config tree
  kernels/  Pallas + lax compute kernels (image ops, point cloud, align, knn)
  detect/   batched tag36h11 AprilTag detector
  pose/     PnP solvers (IPPE-square, SQPnP, GN), depth correction, fusion
  cloud/    point-cloud ops, cropping, ICP / global registration
  calib/    checkerboard calibration (corner detect + Zhang + LM)
  canopy/   plant-height pipeline (bar detect, segmentation, height)
  io/       PNG/PLY/STL/pose/meta I/O, replay camera backend
  parallel/ device-mesh sharding helpers (frame DP, fusion collectives)
  eval/     error reports & validation harnesses
  viz/      host-side visualization
  apps/     CLI entry points mirroring the reference scripts
"""

__version__ = "0.1.0"

import jax as _jax

# Geometry code (PnP, SE(3), ICP) needs true f32 matmuls: on the GPU an
# f32 matrix product may otherwise run in TF32 (~3 decimal digits), which
# costs ~1e-3 relative error per product on rotation chains. Hot
# throughput kernels opt into bf16 explicitly via preferred_element_type
# / precision arguments.
_jax.config.update("jax_default_matmul_precision", "highest")

