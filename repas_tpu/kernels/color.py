"""Camera color-format conversion kernels.

The Femto Bolt streams NV12 / YUYV / MJPG color which the reference
decodes per-frame on CPU (frame_to_bgr_image, better_three_capture.py:
87-115; april_tag_detector_ToF.py:80-113). Here the YUV family converts
on device (one fused elementwise pass); MJPG is a host-side JPEG decode
(PIL) since entropy decoding is serial host work.

BT.601 limited-range coefficients match OpenCV's COLOR_YUV2RGB_NV12 /
COLOR_YUV2RGB_YUYV to rounding.
"""
from __future__ import annotations

import io

import jax
import jax.numpy as jnp
import numpy as np


def _yuv_to_rgb(y: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    y = y.astype(jnp.float32) - 16.0
    u = u.astype(jnp.float32) - 128.0
    v = v.astype(jnp.float32) - 128.0
    r = 1.164 * y + 1.596 * v
    g = 1.164 * y - 0.392 * u - 0.813 * v
    b = 1.164 * y + 2.017 * u
    rgb = jnp.stack([r, g, b], axis=-1)
    return jnp.clip(jnp.round(rgb), 0.0, 255.0).astype(jnp.uint8)


@jax.jit
def nv12_to_rgb(buf: jnp.ndarray) -> jnp.ndarray:
    """NV12 (H*3/2, W) u8 planar buffer -> (H,W,3) RGB."""
    hw32 = buf.shape[0]
    w = buf.shape[1]
    h = (hw32 * 2) // 3
    y = buf[:h, :]
    uv = buf[h:, :].reshape(h // 2, w // 2, 2)
    u = jnp.repeat(jnp.repeat(uv[..., 0], 2, axis=0), 2, axis=1)
    v = jnp.repeat(jnp.repeat(uv[..., 1], 2, axis=0), 2, axis=1)
    return _yuv_to_rgb(y, u, v)


@jax.jit
def yuyv_to_rgb(buf: jnp.ndarray) -> jnp.ndarray:
    """YUYV422 (H, W*2) u8 interleaved buffer -> (H,W,3) RGB."""
    h = buf.shape[0]
    w = buf.shape[1] // 2
    quads = buf.reshape(h, w // 2, 4)
    y0, u, y1, v = (quads[..., 0], quads[..., 1], quads[..., 2],
                    quads[..., 3])
    y = jnp.stack([y0, y1], axis=-1).reshape(h, w)
    uu = jnp.repeat(u, 2, axis=1)
    vv = jnp.repeat(v, 2, axis=1)
    return _yuv_to_rgb(y, uu, vv)


def mjpg_to_rgb(data: bytes) -> np.ndarray:
    """Host-side MJPG (JPEG) decode -> (H,W,3) uint8 RGB."""
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def frame_to_rgb(buf, fmt: str, width: int, height: int) -> np.ndarray:
    """Dispatch on stream format (the frame_to_bgr_image role, RGB order)."""
    fmt = fmt.lower()
    if fmt in ("rgb", "rgb8"):
        return np.asarray(buf, dtype=np.uint8).reshape(height, width, 3)
    if fmt in ("bgr", "bgr8"):
        return np.asarray(buf, dtype=np.uint8).reshape(height, width, 3)[..., ::-1]
    if fmt == "nv12":
        arr = jnp.asarray(np.asarray(buf, np.uint8).reshape(height * 3 // 2,
                                                            width))
        return np.asarray(nv12_to_rgb(arr))
    if fmt in ("yuyv", "yuy2"):
        arr = jnp.asarray(np.asarray(buf, np.uint8).reshape(height,
                                                            width * 2))
        return np.asarray(yuyv_to_rgb(arr))
    if fmt in ("mjpg", "mjpeg", "jpeg"):
        return mjpg_to_rgb(bytes(buf))
    raise ValueError(f"unsupported color format {fmt!r}")
