"""Per-component ROI patch extraction from a row-concatenated pyramid.

The detector's refine/decode tier slices one patch per candidate
component out of a (Hp,W) image pyramid at data-dependent offsets: a
vmap of `lax.dynamic_slice`, which XLA emits as one slicing fusion whose
threads read contiguous rows.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def extract_patches_pyramid(pyr: jnp.ndarray, y0: jnp.ndarray,
                            x0: jnp.ndarray, ph: int, pw: int):
    """pyr (Hp,W), y0/x0 (C,) int32 top-left corners of the (ph,pw)
    windows (pre-clipped in bounds) -> (C,ph,pw) patches."""
    return jax.vmap(lambda y, x: jax.lax.dynamic_slice(
        pyr, (y, x), (ph, pw)))(y0, x0)
