"""Batched integral-image kernels (sum, squared-sum, tilted 45°).

JAX equivalents of ``cv::integral`` as used by the reference
evaluators (reference: traincascade/lib/src/haarfeatures.cpp:100-114,
lbpfeatures.cpp:22-28). All functions are batched over a leading sample axis
and jit-friendly (static shapes, no Python control flow on traced values).

Conventions (identical to OpenCV):
  - input  ``img``  : (..., H, W) integer or float image
  - output ``sum``  : (..., H+1, W+1) with ``sum[..., y, x] = Σ_{i<y, j<x} img[..., i, j]``
    (first row and column are zero)
  - ``tilted[..., Y, X] = Σ over pixels (y, x) with |X - x - 1| <= Y - y - 1``
    (45°-rotated prefix sum, validated bit-exact against ``cv2.integral3``)

dtype policy:
  - ``sum`` / ``tilted`` accumulate in int32: a 1080p uint8 image sums to
    at most 255·2.1e6 ≈ 5.3e8 < 2^31.
  - ``sqsum`` accumulates in float64 on CPU and int64 elsewhere by default;
    for window-sized training images (≤ 2^31 / 255² ≈ 33k px) int32 is safe
    and ``integral_sq(img, dtype=jnp.int32)`` may be used.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def integral_image(img: jax.Array, dtype=jnp.int32) -> jax.Array:
    """Standard integral image with a zero top row / left column.

    img: (..., H, W) -> (..., H+1, W+1) of ``dtype``.
    """
    x = img.astype(dtype)
    s = jnp.cumsum(jnp.cumsum(x, axis=-1, dtype=dtype), axis=-2, dtype=dtype)
    pad = [(0, 0)] * (img.ndim - 2) + [(1, 0), (1, 0)]
    return jnp.pad(s, pad)


def integral_sq(img: jax.Array, dtype=jnp.int64) -> jax.Array:
    """Integral image of squared pixel values.

    Defaults to exact int64 accumulation (a 1080p uint8 image needs up to
    ~37 bits); uses a trace-time x64 scope so the surrounding program can
    keep JAX's default 32-bit mode.
    """
    if dtype == jnp.int64:
        with jax.enable_x64(True):
            x = img.astype(jnp.int64)
            return integral_image(x * x, dtype=jnp.int64)
    x = img.astype(dtype)
    return integral_image(x * x, dtype=dtype)


def _tilted_2d(img: jax.Array) -> jax.Array:
    """Tilted integral for one (H, W) image; returns (H+1, W+1) int32.

    Row recurrence (validated against cv2.integral3):
      T[Y, X] = T[Y-1, X-1] + T[Y-1, X+1] - T[Y-2, X]
                + img[Y-1, X-1] + img[Y-2, X-1]
    The recurrence is exact in the interior; boundary effects propagate
    inward by at most one column per row, so computing on a canvas padded
    with H+1 zero columns on each side and cropping yields the exact result
    everywhere.
    """
    H, W = img.shape
    P = H + 1
    x = jnp.pad(img.astype(jnp.int32), ((0, 0), (P, P)))
    Wp = W + 2 * P
    # rows shifted right by one (img[Y-1, X-1] term), with leading zero col
    rows = jnp.pad(x, ((0, 0), (1, 0)))[:, : Wp + 1]
    zero_row = jnp.zeros((Wp + 1,), jnp.int32)

    def step(carry, row_pair):
        t_m1, t_m2 = carry  # T[Y-1], T[Y-2]
        r1, r2 = row_pair  # img rows Y-1, Y-2 (shifted)
        left = jnp.pad(t_m1[:-1], (1, 0))
        right = jnp.pad(t_m1[1:], (0, 1))
        t = left + right - t_m2 + r1 + r2
        return (t, t_m1), t

    prev_rows = jnp.concatenate([zero_row[None], rows[:-1]], axis=0)
    (_, _), body = jax.lax.scan(step, (zero_row, zero_row), (rows, prev_rows))
    t = jnp.concatenate([zero_row[None], body], axis=0)
    return t[:, P : P + W + 1]


def integral_tilted(img: jax.Array) -> jax.Array:
    """Batched tilted (45°-rotated) integral image.

    img: (..., H, W) -> (..., H+1, W+1) int32. Matches cv2.integral3's third
    output bit-exactly (reference consumer: CV_TILTED_OFFSETS,
    traincascade_features.h:54-63).
    """
    if img.ndim == 2:
        return _tilted_2d(img)
    flat = img.reshape((-1,) + img.shape[-2:])
    out = jax.vmap(_tilted_2d)(flat)
    return out.reshape(img.shape[:-2] + out.shape[-2:])


def integral_all(img: jax.Array, need_tilted: bool = False, sq_dtype=jnp.int64):
    """Compute (sum, sqsum, tilted-or-None) in one call."""
    s = integral_image(img)
    sq = integral_sq(img, dtype=sq_dtype)
    t = integral_tilted(img) if need_tilted else None
    return s, sq, t


def window_norm_factor(sum_img: jax.Array, sq_img: jax.Array) -> jax.Array:
    """Per-window normalization factor sqrt(area·sqSum − sum²).

    Matches the reference ``calcNormFactor`` (features.cpp:13-25): the norm
    rect is (x=1, y=1, w=W-2, h=H-2) in pixel coordinates for an (H, W)-pixel
    window whose integral arrays are (H+1, W+1) — i.e. the window interior
    excluding a one-pixel border.

    sum_img: (..., H+1, W+1); returns (...,) float32.
    """
    h1, w1 = sum_img.shape[-2], sum_img.shape[-1]
    rh, rw = h1 - 3, w1 - 3  # rect height/width = H-2, W-2
    area = rh * rw

    with jax.enable_x64(True):

        def rect4(a):
            return (
                a[..., 1, 1].astype(jnp.int64)
                - a[..., 1, 1 + rw].astype(jnp.int64)
                - a[..., 1 + rh, 1].astype(jnp.int64)
                + a[..., 1 + rh, 1 + rw].astype(jnp.int64)
            )

        v_sum = rect4(sum_img)
        v_sq = rect4(sq_img)
        val = area * v_sq - v_sum * v_sum  # exact in int64
        out = jnp.sqrt(jnp.maximum(val, 0).astype(jnp.float64))
    return out.astype(jnp.float32)


def normalized_response(raw: jax.Array, nf: jax.Array) -> jax.Array:
    """raw / nf as the reference's float division gives it, 0 where
    nf == 0 (haarfeatures.h:108-122); raw and nf broadcast.

    XLA's float32 division on a GPU is not correctly rounded (on an H100
    about a third of the quotients of random operands are off by an
    ulp). The quotient is therefore taken in float64 and rounded once,
    which gives the correctly rounded float32 quotient (53 ≥ 2·24 + 2
    bits). The float64 denominator passes an optimization barrier: in
    one kernel, LLVM would narrow a float64 division of two widened
    float32 values back to the float32 division."""
    safe = jnp.where(nf == 0.0, jnp.float32(1.0), nf)
    with jax.enable_x64(True):
        den = jax.lax.optimization_barrier(safe.astype(jnp.float64))
        q = (raw.astype(jnp.float64) / den).astype(jnp.float32)
    return jnp.where(nf != 0.0, q, jnp.float32(0.0))
