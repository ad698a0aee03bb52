"""Dataclass config tree with the reference's shared constants as defaults.

The reference configures via module-level UPPER_CASE constants at the top of
every script (SURVEY.md §5.6). This module collapses them into one typed
config tree. Defaults cite their reference origin.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class DetectorConfig:
    """AprilTag detector knobs (april_tag_detector_solvepnp.py:154-162)."""

    family: str = "tag36h11"
    quad_decimate: float = 2.0   # segmentation at half res; corners refined
    quad_sigma: float = 0.0      # at full res (C detector's quad_decimate)
    refine_edges: bool = True
    decode_sharpening: float = 0.25
    max_hamming: int = 2
    min_decision_margin: float = 10.0   # three_pose_vertical_translation_validation.py:38
    # capacities of the fixed-size masked-slot formulation
    max_components: int = 48            # candidate dark regions per frame
    max_detections: int = 8             # decoded tags returned per frame
    min_area_px: float = 64.0
    max_area_frac: float = 0.45   # cap on component area (vs frame area);
                                  # excludes background-sized blobs while
                                  # allowing close-up tags
    tile: int = 4                       # adaptive-threshold tile (AprilTag uses 4)
    min_contrast: float = 10.0          # min (max-min) per neighborhood to threshold
    ccl_iters: int = 5                  # scan+stencil propagation rounds
                                        # (each covers full straight runs)


@dataclass(frozen=True)
class PnPConfig:
    """PnP / pose solve (final_view_with_cad.py:177-231)."""

    tag_size_m: float = 0.0303          # april_tag_detector_solvepnp.py:40
    method: str = "ippe_square"         # ippe_square | sqpnp | iterative
    refine_iters: int = 8               # Gauss-Newton refinement steps
    z_penalty: float = 1000.0           # score penalty when z <= 0
    try_all_orders: bool = True         # 8 cyclic/reflected corner orders (C3)


@dataclass(frozen=True)
class DepthConfig:
    """Depth stream handling."""

    depth_scale: float = 0.001          # u16 -> meters (better_three_capture.py:118-125)
    center_win: int = 5                 # median window (mpa_final_view_with_export.py:30)
    fallback_win: int = 11              # canopy_return_upgraded.py:384
    min_depth_m: float = 0.25           # april_tag_detector_ToF.py:33
    max_depth_m: float = 8.0            # april_tag_detector_ToF.py:34


@dataclass(frozen=True)
class ICPConfig:
    """Point-to-plane ICP (mpa_icp_export.py:38-44,166-208)."""

    max_corr_dist: float = 0.05
    max_iters: int = 100
    rel_tol: float = 1e-6
    cad_samples: int = 50_000
    scene_voxel: float = 0.005
    normal_radius: float = 0.02
    normal_max_nn: int = 30


@dataclass(frozen=True)
class RansacConfig:
    """Global registration (icp_cad_model.py:38-96)."""

    voxel_frac_of_diag: float = 0.02
    max_points: int = 1_000_000
    fpfh_radius_mult: float = 5.0
    max_iterations: int = 200_000
    edge_length_check: float = 0.9
    dist_check_mult: float = 2.5
    # hypotheses scored as one batch
    hypothesis_batch: int = 8192


@dataclass(frozen=True)
class CanopyConfig:
    """Plant-height pipeline (canopy_return_upgraded.py)."""

    canny_low: float = 50.0
    canny_high: float = 150.0
    hough_threshold: int = 50
    hough_min_line_len: float = 50.0
    hough_max_line_gap: float = 10.0
    min_coverage: float = 0.1           # line >= 10% of image width
    max_bar_angle_deg: float = 20.0
    grabcut_iters: int = 5
    # HSV green ranges: seed (remove_background_grabcut) and strict (apply_green_mask)
    green_seed_lo: Tuple[int, int, int] = (35, 40, 40)
    green_seed_hi: Tuple[int, int, int] = (85, 255, 255)
    green_lo: Tuple[int, int, int] = (35, 80, 30)
    green_hi: Tuple[int, int, int] = (85, 255, 255)
    morph_kernel: int = 3
    depth_win: int = 5
    depth_fallback_win: int = 11
    proc_decimate: int = 2   # run 2-D stages at 1/dec res (depth lookups
                             # and 3-D math stay at full resolution)
    tip_reconstruct_iters: int = 16  # full-res geodesic growth recovering
                                     # thin leaf tips lost to decimation
                                     # + opening (canopy/height.py step 4b)
    canopy_depth_win: int = 25       # plant-masked median window for the
                                     # canopy depth (thin tips are depth
                                     # holes; see kernels/pointcloud.py)


@dataclass(frozen=True)
class CalibrationConfig:
    """Checkerboard calibration (checkerboard_callibration.py)."""

    inner_cols: int = 19
    inner_rows: int = 19
    square_size_mm: float = 12.7
    num_views: int = 20
    solver_iters: int = 100
    solver_tol: float = 1e-6
    subpix_win: int = 5
    subpix_iters: int = 50
    subpix_tol: float = 1e-4


@dataclass(frozen=True)
class CropConfig:
    """Tag-anchored AABB crop (april_tag_bg_removal_pl.py:40-48)."""

    tag_ids: Tuple[int, ...] = (9, 16)
    anchor_id: int = 16
    # offsets in tag-local frame, meters
    dx_front: float = 0.0
    dx_back: float = 0.0
    dy_front: float = 0.0
    dy_back: float = 0.0
    dz_front: float = 0.0
    dz_back: float = 0.0
    pad_m: float = 0.0


@dataclass(frozen=True)
class CadConfig:
    """CAD placement (mpa_final_view_with_export.py:39-47)."""

    units_to_meters: float = 0.001
    pre_rot_deg_zyx: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    center_on_origin: bool = False
    origin_offset_local: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    flip_z_tag_ids: Tuple[int, ...] = (9,)  # tag-9 180deg Z-flip fix


@dataclass(frozen=True)
class PipelineConfig:
    """Top-level config tree."""

    detector: DetectorConfig = field(default_factory=DetectorConfig)
    pnp: PnPConfig = field(default_factory=PnPConfig)
    depth: DepthConfig = field(default_factory=DepthConfig)
    icp: ICPConfig = field(default_factory=ICPConfig)
    ransac: RansacConfig = field(default_factory=RansacConfig)
    canopy: CanopyConfig = field(default_factory=CanopyConfig)
    calibration: CalibrationConfig = field(default_factory=CalibrationConfig)
    crop: CropConfig = field(default_factory=CropConfig)
    cad: CadConfig = field(default_factory=CadConfig)
    tag_ids: Tuple[int, ...] = (9, 16)  # mpa_final_view_with_export.py:27
    anchor_id: int = 16
