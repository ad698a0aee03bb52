import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repas_tpu.kernels import (align_depth_to_color, deproject_pixels,
                               depth_image_to_points, depth_to_meters,
                               distort_normalized, median_depth_window,
                               project_points, rgbd_to_pointcloud,
                               undistort_points)
from repas_tpu.kernels.pointcloud import fused_pointcloud
from repas_tpu.core.transforms import rodrigues

K = np.array([[600.0, 0, 320.0], [0, 610.0, 240.0], [0, 0, 1.0]])


def test_project_deproject_roundtrip(rng):
    pts = rng.uniform(0.3, 2.0, size=(50, 3)).astype(np.float32)
    pts[:, :2] = rng.uniform(-0.5, 0.5, size=(50, 2))
    uv = project_points(jnp.asarray(pts), jnp.zeros(3), jnp.zeros(3), K)
    back = deproject_pixels(uv, jnp.asarray(pts[:, 2]), K)
    np.testing.assert_allclose(np.asarray(back), pts, atol=1e-3)


def test_project_matches_reference_pinhole():
    # canopy_return_upgraded.py:284-308: x = X*fx/Z + cx
    p = jnp.array([[0.1, -0.2, 1.5]])
    uv = np.asarray(project_points(p, jnp.zeros(3), jnp.zeros(3), K))
    assert abs(uv[0, 0] - (0.1 * 600 / 1.5 + 320)) < 1e-4
    assert abs(uv[0, 1] - (-0.2 * 610 / 1.5 + 240)) < 1e-4


def test_project_with_rotation(rng):
    rvec = jnp.asarray(rng.normal(size=3).astype(np.float32) * 0.3)
    tvec = jnp.array([0.05, -0.02, 1.0])
    obj = jnp.asarray(rng.uniform(-0.1, 0.1, size=(8, 3)).astype(np.float32))
    uv = project_points(obj, rvec, tvec, K)
    # manual
    R = np.asarray(rodrigues(rvec))
    cam = np.asarray(obj) @ R.T + np.asarray(tvec)
    expect = np.stack([600 * cam[:, 0] / cam[:, 2] + 320,
                       610 * cam[:, 1] / cam[:, 2] + 240], axis=1)
    np.testing.assert_allclose(np.asarray(uv), expect, atol=1e-3)


def test_distortion_roundtrip(rng):
    dist = jnp.array([0.09, -0.115, 0.0013, 0.002, 0.046, 0, 0, 0])
    xy = jnp.asarray(rng.uniform(-0.4, 0.4, size=(100, 2)).astype(np.float32))
    xyd = distort_normalized(xy, dist)
    # undistort via pixel-space helper
    uv = jnp.stack([600 * xyd[:, 0] + 320, 610 * xyd[:, 1] + 240], axis=1)
    back = undistort_points(uv, K, dist, iters=20)
    np.testing.assert_allclose(np.asarray(back), np.asarray(xy), atol=1e-5)


def test_depth_image_to_points():
    depth = jnp.ones((48, 64), dtype=jnp.float32) * 2.0
    pts = depth_image_to_points(depth, K)
    assert pts.shape == (48, 64, 3)
    np.testing.assert_allclose(np.asarray(pts[..., 2]), 2.0)
    # center pixel maps close to optical axis
    np.testing.assert_allclose(
        np.asarray(pts[24, 32]),
        [(32 - 320) / 600 * 2, (24 - 240) / 610 * 2, 2.0], atol=1e-5)


def test_rgbd_to_pointcloud_masks():
    depth = np.full((8, 16), 1.5, dtype=np.float32)
    depth[0, 0] = 0.0        # invalid
    depth[1, 1] = np.nan     # invalid
    rgb = np.full((8, 16, 3), 128, dtype=np.uint8)
    pts, cols, valid = rgbd_to_pointcloud(jnp.asarray(rgb), jnp.asarray(depth), K)
    assert pts.shape == (128, 3) and valid.shape == (128,)
    v = np.asarray(valid)
    assert not v[0] and not v[17] and v.sum() == 126
    np.testing.assert_allclose(np.asarray(cols)[v], 128 / 255.0, atol=1e-6)
    np.testing.assert_allclose(np.asarray(pts)[0], 0.0)


def test_fused_pointcloud_xla_fallback():
    depth = (np.ones((16, 128)) * 1000).astype(np.uint16)
    rgb = np.zeros((16, 128, 3), dtype=np.uint8)
    out = fused_pointcloud(jnp.asarray(depth), jnp.asarray(rgb), K)
    assert out.shape == (6, 16 * 128)
    np.testing.assert_allclose(np.asarray(out)[2, :], 1.0, atol=1e-6)


def test_median_depth_window():
    depth = np.zeros((20, 20), dtype=np.float32)
    depth[9:12, 9:12] = [[1.0, 2.0, 3.0], [4.0, 5.0, 6.0], [7.0, 8.0, 100.0]]
    med = float(median_depth_window(jnp.asarray(depth), 10, 10, win=5))
    # valid values are the 9 nonzero ones; median = 5.0
    assert abs(med - 5.0) < 1e-6
    # empty window -> 0.0
    assert float(median_depth_window(jnp.asarray(depth), 0, 0, win=3)) == 0.0
    # even count: mean of middle two
    depth2 = np.zeros((5, 5), dtype=np.float32)
    depth2[2, 2] = 1.0
    depth2[2, 3] = 3.0
    med2 = float(median_depth_window(jnp.asarray(depth2), 2, 2, win=3))
    assert abs(med2 - 2.0) < 1e-6


def test_align_identity_extrinsics():
    # depth and color share intrinsics + identity extrinsics -> align is
    # (nearly) the identity warp
    depth = np.zeros((48, 64), dtype=np.float32)
    depth[10:30, 20:40] = 1.25
    out = align_depth_to_color(jnp.asarray(depth), K, K, np.eye(3),
                               np.zeros(3), out_shape=(48, 64))
    out = np.asarray(out)
    inner = out[11:29, 21:39]
    np.testing.assert_allclose(inner, 1.25, atol=1e-5)
    assert out[0, 0] == 0.0


def test_align_translation_shifts():
    # translate depth camera 10cm along +x: points land left in color image
    depth = np.full((48, 64), 1.0, dtype=np.float32)
    t = np.array([0.1, 0.0, 0.0])
    out = np.asarray(align_depth_to_color(
        jnp.asarray(depth), K, K, np.eye(3), t, out_shape=(48, 64),
        fill_holes=False))
    # u shift = fx * 0.1 / 1.0 = 60 px -> only columns >= 60 get values
    # (shift is +x so pixels move right by 60)
    assert (out[:, :59] == 0).all()
    assert (out[:, 61:] == 1.0).all()


def test_replay_backend(reference_root):
    from repas_tpu.io.replay import ReplayBackend, select_profile, StreamProfile

    rb = ReplayBackend(
        reference_root / "realsense_d415i/testing_scripts/aligned_outputs",
        intrinsics_json=reference_root /
        "realsense_d415i/april_tag_detection_caliberation/factory_color_intrinsics_1280_720.json")
    frames = rb.read_all()
    assert len(frames) >= 3
    f = frames[0]
    assert f.color.shape == (720, 1280, 3)
    assert f.depth_raw is not None and f.depth_raw.dtype == np.uint16
    assert f.color_intrinsics.width == 1280
    d = f.depth_meters()
    assert d is not None and 0.1 < np.median(d[d > 0]) < 10

    profs = rb.profiles()
    p = select_profile(profs, "color", 1280, 720)
    assert p.stream == "color" and p.width == 1280
    # fallback ladder: non-existent size falls back to default
    p2 = select_profile(profs, "color", 999, 999)
    assert p2.width == 1280
    with pytest.raises(LookupError):
        select_profile(profs, "infrared", 640, 480)


def _numpy_ccl(mask, iters, connectivity):
    """Round-for-round numpy model of the CCL: per round, every run of
    mask pixels along each row, then each column, takes its minimum
    label (what a forward+backward segmented min-scan computes), then a
    3x3 (or 4-neighbour) min stencil."""
    h, w = mask.shape
    n = h * w
    lab = np.where(mask, np.arange(n).reshape(h, w), n)

    def runs_min(line, m):
        out = np.full_like(line, n)
        i = 0
        while i < len(line):
            if not m[i]:
                i += 1
                continue
            j = i
            while j < len(line) and m[j]:
                j += 1
            out[i:j] = line[i:j].min()
            i = j
        return out

    shifts = [(-1, 0), (1, 0), (0, -1), (0, 1)]
    if connectivity == 8:
        shifts += [(-1, -1), (-1, 1), (1, -1), (1, 1)]
    for _ in range(iters):
        lab = np.stack([runs_min(lab[r], mask[r]) for r in range(h)])
        lab = np.stack([runs_min(lab[:, c], mask[:, c])
                        for c in range(w)], axis=1)
        p = np.pad(lab, 1, constant_values=n)
        m = lab.copy()
        for dy, dx in shifts:
            m = np.minimum(m, p[1 + dy:1 + dy + h, 1 + dx:1 + dx + w])
        lab = np.where(mask, m, n)
    return lab


@pytest.mark.parametrize("shape", [(40, 56), (90, 160)])
def test_ccl_xla_matches_numpy_rounds(rng, shape):
    """The XLA scan formulation equals the numpy round-for-round model
    (labels are integers: bit-exact), including rounds that have not
    converged yet."""
    from repas_tpu.kernels.ccl import _connected_components_xla

    mask = rng.random(shape) > 0.45
    for iters, conn in [(1, 8), (3, 4), (5, 8)]:
        got = np.asarray(_connected_components_xla(
            jnp.asarray(mask), iters=iters, connectivity=conn))
        np.testing.assert_array_equal(got, _numpy_ccl(mask, iters, conn))


@pytest.mark.parametrize("connectivity", [4, 8])
@pytest.mark.parametrize("shape", [(90, 160), (64, 256), (37, 50)])
def test_ccl_triton_parity_interpret(rng, shape, connectivity):
    """The Triton segmented-scan CCL (the CUDA path) is bit-identical to
    the XLA scan formulation; interpret mode runs the kernel's own code
    on the CPU. Shapes cover partial column blocks in both scan
    directions (the row scans run on the transpose)."""
    from repas_tpu.kernels.ccl import (_connected_components_triton,
                                       _connected_components_xla)

    mask = jnp.asarray(rng.random(shape) > 0.5)
    ref = np.asarray(_connected_components_xla(
        mask, iters=5, connectivity=connectivity))
    got = np.asarray(_connected_components_triton(
        mask, iters=5, connectivity=connectivity, interpret=True))
    np.testing.assert_array_equal(got, ref)


def test_ccl_triton_batched_interpret(rng):
    """Under vmap (the detector labels a frame batch) the kernel grid
    gains a batch axis; each frame still matches the XLA path."""
    from repas_tpu.kernels.ccl import (_connected_components_triton,
                                       _connected_components_xla)

    masks = jnp.asarray(rng.random((3, 24, 40)) > 0.5)
    got = jax.vmap(lambda m: _connected_components_triton(
        m, iters=3, interpret=True))(masks)
    for i in range(3):
        np.testing.assert_array_equal(
            np.asarray(got[i]),
            np.asarray(_connected_components_xla(masks[i], iters=3)))


def test_connected_components_cpu_takes_xla_path(rng):
    """Off CUDA the platform switch lowers the XLA formulation, inside
    jit and vmap as the detector calls it."""
    from repas_tpu.kernels.ccl import (_connected_components_xla,
                                       connected_components)

    masks = jnp.asarray(rng.random((2, 30, 44)) > 0.5)
    got = jax.jit(jax.vmap(lambda m: connected_components(m, iters=4)))(
        masks)
    for i in range(2):
        np.testing.assert_array_equal(
            np.asarray(got[i]),
            np.asarray(_connected_components_xla(masks[i], iters=4)))


def test_extract_patches_pyramid_exact_window(rng):
    """Patches are the exact (ph,pw) windows at the given origins,
    including windows flush with the bottom/right edges."""
    from repas_tpu.kernels.patch_extract import extract_patches_pyramid

    pyr = rng.random((300, 200)).astype(np.float32)
    ph, pw = 48, 64
    y0 = np.array([0, 17, 300 - ph, 123], np.int32)
    x0 = np.array([0, 99, 200 - pw, 5], np.int32)
    got = np.asarray(extract_patches_pyramid(
        jnp.asarray(pyr, jnp.bfloat16), jnp.asarray(y0), jnp.asarray(x0),
        ph, pw))
    assert got.shape == (4, ph, pw)
    ref = np.stack([pyr[y:y + ph, x:x + pw] for y, x in zip(y0, x0)])
    np.testing.assert_array_equal(
        got.astype(np.float32),
        np.asarray(jnp.asarray(ref, jnp.bfloat16), np.float32))


@pytest.mark.parametrize("packed", [True, False])
def test_fused_pointcloud_planar_matches_numpy(rng, packed):
    """Planar (6, H*W) cloud equals a float64 numpy deprojection for
    packed u32 and (H,W,3) u8 colors; zero depth gives zero XYZ and
    zero color."""
    from repas_tpu.kernels.image import pack_rgb_u32

    h, w = 12, 20
    depth = rng.integers(0, 4000, (h, w)).astype(np.uint16)
    depth[::3, ::4] = 0
    rgb = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    color = pack_rgb_u32(jnp.asarray(rgb)) if packed else jnp.asarray(rgb)
    got = np.asarray(fused_pointcloud(jnp.asarray(depth), color, K))
    z = depth.astype(np.float64) * 0.001
    v, u = np.mgrid[:h, :w].astype(np.float64)
    col = rgb / 255.0 * (z > 0)[..., None]
    ref = np.stack([(u - K[0, 2]) * z / K[0, 0],
                    (v - K[1, 2]) * z / K[1, 1], z,
                    col[..., 0], col[..., 1], col[..., 2]]).reshape(6, -1)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    zero = (depth == 0).reshape(-1)
    assert zero.any() and (got[:, zero] == 0).all()
