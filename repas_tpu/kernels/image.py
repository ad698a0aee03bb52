"""Core 2-D image kernels (pure XLA; stencil ops lower to fused
reduce-window/conv).

Replaces the cv2 image-processing call sites scattered through the
reference: cvtColor grayscale, GaussianBlur, Sobel gradients, morphology
(canopy_return_upgraded.py:25-35,127-129), CLAHE/gamma enhancement retry
ladders (vis_tool_april_tag_pose_validaiton.py:49-86, vis_tool_solvepnp.py:
35-45), warpAffine rotation (canopy_return_upgraded.py:69-79), and the
tile-based adaptive threshold of the AprilTag C detector (N1).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def pack_rgb_u32(img: jnp.ndarray) -> jnp.ndarray:
    """(H,W,3) uint8 -> (H,W) uint32 with r | g<<8 | b<<16.

    Padding the channel dim to 4 bytes and bitcasting reads the
    channel-minor u8 image in one contiguous pass (no stride-3 channel
    slices), and every later consumer extracts channels with shifts and
    masks on one 32-bit word per pixel."""
    x4 = jnp.pad(img, ((0, 0), (0, 0), (0, 1)))
    return jax.lax.bitcast_convert_type(x4, jnp.uint32)


def gray_from_u32(packed: jnp.ndarray) -> jnp.ndarray:
    """(H,W) uint32 r|g<<8|b<<16 -> BT.601 luma float32 [0,255]."""
    r = (packed & 255).astype(jnp.float32)
    g = ((packed >> 8) & 255).astype(jnp.float32)
    b = ((packed >> 16) & 255).astype(jnp.float32)
    return 0.299 * r + 0.587 * g + 0.114 * b


def rgb_to_gray(img: jnp.ndarray) -> jnp.ndarray:
    """BT.601 luma -> float32 [0,255] (cv2.cvtColor RGB2GRAY weights).

    uint8 inputs go through pack_rgb_u32 (pad+bitcast) and extract
    channels with vector shifts/masks. Bit-identical to the
    naive path: byte extraction is exact and the f32 weighted sum sees
    the same integer values in the same order. Pipelines that also feed
    the pointcloud kernel should pack_rgb_u32 ONCE and use gray_from_u32
    (repas_tpu.pipeline does)."""
    if img.ndim == 2:
        return img.astype(jnp.float32)
    if img.dtype == jnp.uint8:
        return gray_from_u32(pack_rgb_u32(img))
    img = img.astype(jnp.float32)
    return (0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2])


def _gaussian_kernel1d(sigma: float, radius: int) -> jnp.ndarray:
    x = jnp.arange(-radius, radius + 1, dtype=jnp.float32)
    k = jnp.exp(-0.5 * (x / sigma) ** 2)
    return k / jnp.sum(k)


def gaussian_blur(img: jnp.ndarray, sigma: float, radius: int | None = None
                  ) -> jnp.ndarray:
    """Separable Gaussian blur on a 2-D image (reflect padding)."""
    if sigma <= 0:
        return img
    if radius is None:
        radius = max(1, int(3.0 * sigma + 0.5))
    k = _gaussian_kernel1d(float(sigma), radius)
    img = img.astype(jnp.float32)
    x = jnp.pad(img, [(0, 0), (radius, radius)], mode="edge")

    # horizontal then vertical via conv_general_dilated on (1,1,H,W)
    def conv1d(a, kern, axis):
        kshape = (1, 1) + ((1, kern.shape[0]) if axis == 1 else (kern.shape[0], 1))
        return jax.lax.conv_general_dilated(
            a[None, None], kern.reshape(kshape), (1, 1), "VALID",
        )[0, 0]
    x = conv1d(x, k, axis=1)
    x = jnp.pad(x, [(radius, radius), (0, 0)], mode="edge")
    return conv1d(x, k, axis=0)


def sobel(img: jnp.ndarray):
    """Sobel gradients (gx, gy), cv2.Sobel ksize=3 convention."""
    img = img.astype(jnp.float32)
    p = jnp.pad(img, 1, mode="edge")
    # 3x3 sobel via shifted sums
    tl, tc, tr = p[:-2, :-2], p[:-2, 1:-1], p[:-2, 2:]
    ml, mr = p[1:-1, :-2], p[1:-1, 2:]
    bl, bc, br = p[2:, :-2], p[2:, 1:-1], p[2:, 2:]
    gx = (tr + 2 * mr + br) - (tl + 2 * ml + bl)
    gy = (bl + 2 * bc + br) - (tl + 2 * tc + tr)
    return gx, gy


def _pool2d(img: jnp.ndarray, size: int, op, init) -> jnp.ndarray:
    return jax.lax.reduce_window(img, init, op, (size, size), (size, size),
                                 "VALID")


def _window2d(img: jnp.ndarray, size: int, op, init) -> jnp.ndarray:
    return jax.lax.reduce_window(img, init, op, (size, size), (1, 1), "SAME")


def dilate(img: jnp.ndarray, size: int = 3) -> jnp.ndarray:
    """Grayscale/binary dilation with a size x size box (cv2.dilate)."""
    return _window2d(img.astype(jnp.float32), size, jax.lax.max, -jnp.inf)


def erode(img: jnp.ndarray, size: int = 3) -> jnp.ndarray:
    return _window2d(img.astype(jnp.float32), size, jax.lax.min, jnp.inf)


def morph_open(img: jnp.ndarray, size: int = 3) -> jnp.ndarray:
    """cv2.MORPH_OPEN: erode then dilate."""
    return dilate(erode(img, size), size)


def morph_close(img: jnp.ndarray, size: int = 3) -> jnp.ndarray:
    """cv2.MORPH_CLOSE: dilate then erode."""
    return erode(dilate(img, size), size)


def adaptive_threshold(gray: jnp.ndarray, tile: int = 4,
                       min_contrast: float = 10.0):
    """AprilTag-style tile adaptive threshold.

    Computes per-(tile x tile) min/max, takes min/max over the 3x3 tile
    neighborhood, and thresholds at (min+max)/2. Pixels in low-contrast
    neighborhoods (max-min < min_contrast) are marked ambiguous.

    Returns (binary (H,W) bool  [True = above threshold, i.e. white],
             ambiguous (H,W) bool).
    Mirrors the behavior of the AprilTag C threshold stage used via
    pupil-apriltags (N1, april_tag_detector_solvepnp.py:154-162).
    """
    g = gray.astype(jnp.float32)
    h, w = g.shape
    th, tw = h // tile, w // tile
    g_crop = g[: th * tile, : tw * tile]
    tmin = _pool2d(g_crop, tile, jax.lax.min, jnp.inf)
    tmax = _pool2d(g_crop, tile, jax.lax.max, -jnp.inf)
    nmin = _window2d(tmin, 3, jax.lax.min, jnp.inf)
    nmax = _window2d(tmax, 3, jax.lax.max, -jnp.inf)
    thresh_t = 0.5 * (nmin + nmax)
    contrast_t = nmax - nmin
    # upsample tile maps back to pixels
    thresh = jnp.repeat(jnp.repeat(thresh_t, tile, axis=0), tile, axis=1)
    contrast = jnp.repeat(jnp.repeat(contrast_t, tile, axis=0), tile, axis=1)
    thresh = jnp.pad(thresh, ((0, h - th * tile), (0, w - tw * tile)),
                     mode="edge")
    contrast = jnp.pad(contrast, ((0, h - th * tile), (0, w - tw * tile)),
                       mode="edge")
    binary = g > thresh
    ambiguous = contrast < min_contrast
    return binary, ambiguous


def bilinear_sample(img: jnp.ndarray, uv: jnp.ndarray) -> jnp.ndarray:
    """Bilinear sample a 2-D image at float pixel coords uv (...,2)."""
    img = img.astype(jnp.float32)
    h, w = img.shape
    u = jnp.clip(uv[..., 0], 0.0, w - 1.001)
    v = jnp.clip(uv[..., 1], 0.0, h - 1.001)
    u0 = jnp.floor(u).astype(jnp.int32)
    v0 = jnp.floor(v).astype(jnp.int32)
    fu = u - u0
    fv = v - v0
    i00 = img[v0, u0]
    i01 = img[v0, u0 + 1]
    i10 = img[v0 + 1, u0]
    i11 = img[v0 + 1, u0 + 1]
    return ((1 - fv) * ((1 - fu) * i00 + fu * i01)
            + fv * ((1 - fu) * i10 + fu * i11))


def bilinear_sample_patch(patch: jnp.ndarray, uv: jnp.ndarray
                          ) -> jnp.ndarray:
    """Gather-free bilinear sampling for SMALL images (ROI patches).

    Reformulates bilinear interpolation as two dense contractions with
    hat-function weight matrices: W_row[p,h] = max(0, 1-|h - y_p|) holds
    exactly the two bilinear row weights per sample, so
    val[p] = sum_h sum_w W_row[p,h] * patch[h,w] * W_col[p,w] — a
    matrix product plus an elementwise reduce, no gathers. Only
    worthwhile when patch H*W is small (cost is P*H*W flops).

    Coordinate clamping matches bilinear_sample. The contraction runs in
    bfloat16 with f32 accumulation (the tensor cores' native form):
    uint8 pixel values are exactly representable, and the hat weights'
    bf16 rounding
    (~0.4%) perturbs samples by ~1 gray level — an order of magnitude
    below the image noise the downstream gradient-peak / decode-threshold
    consumers already tolerate (corner accuracy measured unchanged at the
    0.01 px level on the synthetic render suite).
    """
    patch = patch.astype(jnp.bfloat16)
    h, w = patch.shape
    u = jnp.clip(uv[..., 0], 0.0, w - 1.001).reshape(-1)[:, None]
    v = jnp.clip(uv[..., 1], 0.0, h - 1.001).reshape(-1)[:, None]
    hi = jax.lax.broadcasted_iota(jnp.float32, (1, h), 1)
    wi = jax.lax.broadcasted_iota(jnp.float32, (1, w), 1)
    wr = jnp.maximum(0.0, 1.0 - jnp.abs(hi - v))        # (P,h)
    wc = jnp.maximum(0.0, 1.0 - jnp.abs(wi - u))        # (P,w)
    t = jnp.dot(wr.astype(jnp.bfloat16), patch,
                preferred_element_type=jnp.float32)
    return jnp.sum(t * wc, axis=1).reshape(uv.shape[:-1])


def extract_patches(img: jnp.ndarray, starts_xy: jnp.ndarray,
                    size: tuple) -> jnp.ndarray:
    """(C,2) int32 top-left corners -> (C,ph,pw) patches (contiguous
    dynamic-slice copies, not gathers). Starts must be pre-clamped to
    keep slices in bounds."""
    ph, pw = size
    return jax.vmap(lambda s: jax.lax.dynamic_slice(
        img, (s[1], s[0]), (ph, pw)))(starts_xy)


def decimate(img: jnp.ndarray, factor: int = 2) -> jnp.ndarray:
    """Average-pool decimation (quad_decimate equivalent).

    reduce_window, not reshape(h2,f,w2,f).mean((1,3)): the reshape form
    leaves a minor dim of size `factor` to reduce."""
    if factor <= 1:
        return img
    h, w = img.shape
    h2, w2 = h // factor, w // factor
    x = img[: h2 * factor, : w2 * factor].astype(jnp.float32)
    s = jax.lax.reduce_window(x, 0.0, jax.lax.add, (factor, factor),
                              (factor, factor), "VALID")
    return s * jnp.float32(1.0 / (factor * factor))


def get_rotation_matrix_2d(center, angle_deg, scale: float = 1.0) -> jnp.ndarray:
    """cv2.getRotationMatrix2D: 2x3 affine rotating about center.

    Positive angle rotates counter-clockwise in image coords (matching
    canopy_return_upgraded.py:71).
    """
    a = jnp.deg2rad(jnp.asarray(angle_deg, jnp.float32))
    ca = jnp.cos(a) * scale
    sa = jnp.sin(a) * scale
    cx, cy = jnp.asarray(center[0], jnp.float32), jnp.asarray(center[1], jnp.float32)
    return jnp.array([
        [ca, sa, (1 - ca) * cx - sa * cy],
        [-sa, ca, sa * cx + (1 - ca) * cy],
    ])


def invert_affine(M: jnp.ndarray) -> jnp.ndarray:
    """cv2.invertAffineTransform for a 2x3 matrix."""
    A = M[:, :2]
    b = M[:, 2]
    Ainv = jnp.linalg.inv(A)
    return jnp.concatenate([Ainv, (-Ainv @ b)[:, None]], axis=1)


def transform_points_2d(M: jnp.ndarray, pts: jnp.ndarray) -> jnp.ndarray:
    """Apply a 2x3 affine to (...,2) points (cv2.transform)."""
    return pts @ M[:, :2].T + M[:, 2]


def warp_affine(img: jnp.ndarray, M: jnp.ndarray,
                out_shape: tuple[int, int] | None = None,
                border_value: float = 0.0) -> jnp.ndarray:
    """cv2.warpAffine with bilinear sampling + constant border.

    Works on (H,W) or (H,W,C) images; M maps src -> dst.
    """
    h, w = img.shape[:2]
    oh, ow = out_shape if out_shape is not None else (h, w)
    Minv = invert_affine(M)
    xx = jax.lax.broadcasted_iota(jnp.float32, (oh, ow), 1)
    yy = jax.lax.broadcasted_iota(jnp.float32, (oh, ow), 0)
    uv = jnp.stack([xx, yy], axis=-1)
    src = transform_points_2d(Minv, uv)
    inb = ((src[..., 0] >= 0) & (src[..., 0] <= w - 1)
           & (src[..., 1] >= 0) & (src[..., 1] <= h - 1))
    if img.ndim == 2:
        out = bilinear_sample(img, src)
        return jnp.where(inb, out, border_value)
    outs = [jnp.where(inb, bilinear_sample(img[..., c], src), border_value)
            for c in range(img.shape[2])]
    return jnp.stack(outs, axis=-1)


def rgb_to_hsv_cv(img: jnp.ndarray) -> jnp.ndarray:
    """RGB uint8 -> OpenCV-convention HSV (H in [0,180), S,V in [0,255]).

    Matches cv2.cvtColor(..., COLOR_BGR2HSV) given RGB channel order input
    (used by the green-mask thresholds, canopy_return_upgraded.py:99-124).
    """
    x = img.astype(jnp.float32)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    v = jnp.maximum(jnp.maximum(r, g), b)
    mn = jnp.minimum(jnp.minimum(r, g), b)
    diff = v - mn
    s = jnp.where(v > 0, 255.0 * diff / jnp.maximum(v, 1e-9), 0.0)
    safe = jnp.maximum(diff, 1e-9)
    h = jnp.where(v == r, 60.0 * (g - b) / safe,
                  jnp.where(v == g, 120.0 + 60.0 * (b - r) / safe,
                            240.0 + 60.0 * (r - g) / safe))
    h = jnp.where(diff == 0, 0.0, h)
    h = jnp.where(h < 0, h + 360.0, h) / 2.0
    return jnp.stack([h, s, v], axis=-1)


def hsv_in_range(hsv: jnp.ndarray, lo, hi) -> jnp.ndarray:
    """cv2.inRange on an HSV image -> bool mask.

    cv2 stores HSV as uint8, so its inRange compares ROUNDED values: a
    boundary pixel with H=34.89 rounds to 35 and passes a [35,85] hue
    gate. Comparing raw floats excluded exactly those boundary pixels
    (measured: the topmost canopy leaf-tip rows of the checked-in
    captures all sit at H in [34.6, 35)), so quantize like cv2 first.
    """
    lo = jnp.asarray(lo, jnp.float32)
    hi = jnp.asarray(hi, jnp.float32)
    q = jnp.round(hsv)
    return jnp.all((q >= lo) & (q <= hi), axis=-1)


def gamma_lut(img: jnp.ndarray, gamma: float) -> jnp.ndarray:
    """Gamma correction (vis_tool_solvepnp.py:35-45 LUT equivalent)."""
    x = jnp.clip(img.astype(jnp.float32) / 255.0, 0.0, 1.0)
    return jnp.power(x, gamma) * 255.0


def clahe(gray: jnp.ndarray, clip_limit: float = 2.0, tiles: int = 8
          ) -> jnp.ndarray:
    """Contrast-limited adaptive histogram equalization (cv2.createCLAHE
    equivalent; used in the detection retry ladder,
    vis_tool_april_tag_pose_validaiton.py:49-64).

    Tile histograms (256 bins) are clipped, redistributed, turned into
    CDFs, and bilinearly interpolated between tile centers.

    Formulation without scatters or full-image gathers:

      * tile histograms: one-hot compare + reduce per tile (fused by
        XLA into a bandwidth-bound pass),
      * LUT application: the image is processed in quarter-tile blocks.
        Within a quarter-tile block every pixel interpolates the SAME
        four tile LUTs (the ty0/tx0 indices change only at half-tile
        boundaries), so the 256-entry lookup becomes a (N,256) one-hot
        @ (256,4) matmul per block instead of 4 full-image gathers. The per-pixel bilinear weights stay elementwise.
    """
    g = jnp.clip(gray.astype(jnp.float32), 0.0, 255.0)
    h, w = g.shape
    th, tw = h // tiles, w // tiles
    hc, wc = th * tiles, tw * tiles
    gc = g[:hc, :wc].reshape(tiles, th, tiles, tw)
    gc = gc.transpose(0, 2, 1, 3).reshape(tiles * tiles, th * tw)
    bins = 256
    idx = jnp.clip(gc.astype(jnp.int32), 0, 255)
    bin_iota = jax.lax.broadcasted_iota(jnp.int32, (1, bins), 1)
    hist = jax.lax.map(
        lambda r: jnp.sum((r[:, None] == bin_iota).astype(jnp.float32),
                          axis=0), idx)
    clip = clip_limit * (th * tw) / bins
    excess = jnp.sum(jnp.maximum(hist - clip, 0.0), axis=1, keepdims=True)
    hist = jnp.minimum(hist, clip) + excess / bins
    cdf = jnp.cumsum(hist, axis=1)
    cdf = (cdf - cdf[:, :1]) / jnp.maximum(cdf[:, -1:] - cdf[:, :1], 1e-6)
    luts = (cdf * 255.0).reshape(tiles, tiles, bins)

    # -- LUT application ---------------------------------------------
    import numpy as _np
    if th % 2 or tw % 2 or (hc, wc) != (h, w):
        # odd tile sizes (half-tile band boundaries fall mid-row, so the
        # quarter-tile block decomposition doesn't apply) or H/W not a
        # multiple of the tile grid (the remainder band must still be
        # LUT-transformed, not edge-replicated): use the gather
        # formulation (correct everywhere)
        yy = jnp.arange(h, dtype=jnp.float32)
        xx = jnp.arange(w, dtype=jnp.float32)
        ty = jnp.clip((yy - th / 2) / th, 0.0, tiles - 1.001)
        tx = jnp.clip((xx - tw / 2) / tw, 0.0, tiles - 1.001)
        ty0 = jnp.floor(ty).astype(jnp.int32)
        tx0 = jnp.floor(tx).astype(jnp.int32)
        fy = (ty - ty0)[:, None]
        fx = (tx - tx0)[None, :]
        gi = jnp.clip(g.astype(jnp.int32), 0, 255)
        ty0m = ty0[:, None]
        tx0m = tx0[None, :]
        v00 = luts[ty0m, tx0m, gi]
        v01 = luts[ty0m, tx0m + 1, gi]
        v10 = luts[ty0m + 1, tx0m, gi]
        v11 = luts[ty0m + 1, tx0m + 1, gi]
        return ((1 - fy) * ((1 - fx) * v00 + fx * v01)
                + fy * ((1 - fx) * v10 + fx * v11))

    # quarter-tile blocks: static per-block tile indices (ty0 is
    # constant within each half-tile row band, and quarter-tile blocks
    # never straddle a band)
    qh, qw = th // 2, tw // 2
    by = _np.arange(2 * tiles) * qh             # block start rows
    bx = _np.arange(2 * tiles) * qw
    ty0_b = _np.clip(_np.floor((by - th / 2) / th), 0, tiles - 2
                     ).astype(_np.int32)
    tx0_b = _np.clip(_np.floor((bx - tw / 2) / tw), 0, tiles - 2
                     ).astype(_np.int32)
    # (2T,2T,4,bins) LUT stack per block: [v00, v01, v10, v11]
    l00 = luts[ty0_b][:, tx0_b]
    l01 = luts[ty0_b][:, tx0_b + 1]
    l10 = luts[ty0_b + 1][:, tx0_b]
    l11 = luts[ty0_b + 1][:, tx0_b + 1]
    lut4 = jnp.stack([l00, l01, l10, l11], axis=2)         # (2T,2T,4,B)
    lut4 = lut4.reshape(4 * tiles * tiles, 4, bins)

    gi = jnp.clip(g[:hc, :wc].astype(jnp.int32), 0, 255)
    gb = gi.reshape(2 * tiles, qh, 2 * tiles, qw)
    gb = gb.transpose(0, 2, 1, 3).reshape(4 * tiles * tiles, qh * qw)
    onehot = (gb[:, :, None] == bin_iota[None]).astype(jnp.float32)
    v4 = jnp.einsum("bns,bks->bnk", onehot, lut4,
                    preferred_element_type=jnp.float32)    # (B,N,4)
    v4 = v4.reshape(2 * tiles, 2 * tiles, qh, qw, 4)
    v4 = v4.transpose(0, 2, 1, 3, 4).reshape(hc, wc, 4)

    yy = jnp.arange(hc, dtype=jnp.float32)
    xx = jnp.arange(wc, dtype=jnp.float32)
    ty = jnp.clip((yy - th / 2) / th, 0.0, tiles - 1.001)
    tx = jnp.clip((xx - tw / 2) / tw, 0.0, tiles - 1.001)
    fy = (ty - jnp.floor(ty))[:, None]
    fx = (tx - jnp.floor(tx))[None, :]
    out = ((1 - fy) * ((1 - fx) * v4[..., 0] + fx * v4[..., 1])
           + fy * ((1 - fx) * v4[..., 2] + fx * v4[..., 3]))
    return out
