"""Bit-exact replication of OpenCV's INTER_LINEAR_EXACT resize for uint8.

The OpenCV runtime detector builds its image pyramid with
``resize(..., INTER_LINEAR_EXACT)``; detection parity therefore requires
reproducing its fixed-point arithmetic bit-for-bit:

  - source position: exact rational fx = (d + 0.5)·ssz/dsz − 0.5
  - border clamp: sx < 0 → (0, frac 0); sx ≥ ssz−1 → (ssz−2, frac 1)
  - 8-fractional-bit coefficients, round-half-even
  - separable passes accumulated in uint32, final (v + 2^15) >> 16 saturated

Validated bit-exact against cv2.resize(INTER_LINEAR_EXACT) across up/down
scales including degenerate sizes (see tests/test_resize.py).

Coefficient tables are tiny, shape-static, and computed host-side; the JAX
apply is two gathers + integer math (jit/vmap friendly).
"""

from __future__ import annotations

import functools
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np


@functools.lru_cache(maxsize=4096)
def _axis_tab(ssz: int, dsz: int):
    """(src_idx, coef1) int32 arrays for one axis."""
    sx_l = np.empty(dsz, np.int32)
    c_l = np.empty(dsz, np.int32)
    for d in range(dsz):
        fx = Fraction((2 * d + 1) * ssz - dsz, 2 * dsz)
        sx = fx.numerator // fx.denominator  # floor
        frac = fx - sx
        if sx < 0:
            sx, frac = 0, Fraction(0)
        if sx >= ssz - 1:
            sx, frac = (ssz - 2, Fraction(1)) if ssz > 1 else (0, Fraction(0))
        sx_l[d] = sx
        c_l[d] = round(frac * 256)  # Fraction round() = half-even, like OpenCV
    return sx_l, c_l


def resize_linear_exact(img: jax.Array, dst_w: int, dst_h: int) -> jax.Array:
    """Resize (..., H, W) uint8 → (..., dst_h, dst_w) uint8, bit-exact with
    cv2.resize(INTER_LINEAR_EXACT)."""
    sh, sw = img.shape[-2], img.shape[-1]
    if (sh, sw) == (dst_h, dst_w):
        return img
    sxs, cxs = _axis_tab(sw, dst_w)
    sys_, cys = _axis_tab(sh, dst_h)
    sx0 = jnp.asarray(sxs)
    sx1 = jnp.asarray(np.minimum(sxs + 1, sw - 1))
    cx = jnp.asarray(cxs, jnp.uint32)
    sy0 = jnp.asarray(sys_)
    sy1 = jnp.asarray(np.minimum(sys_ + 1, sh - 1))
    cy = jnp.asarray(cys, jnp.uint32)

    s = img.astype(jnp.uint32)
    h = (256 - cx) * jnp.take(s, sx0, axis=-1) + cx * jnp.take(s, sx1, axis=-1)
    v = (256 - cy)[:, None] * jnp.take(h, sy0, axis=-2) + cy[:, None] * jnp.take(
        h, sy1, axis=-2
    )
    out = (v + (1 << 15)) >> 16
    return jnp.minimum(out, 255).astype(jnp.uint8)


def resize_linear_exact_np(img: np.ndarray, dst_w: int, dst_h: int) -> np.ndarray:
    """NumPy twin of resize_linear_exact (host-side pipelines/tools)."""
    sh, sw = img.shape[-2], img.shape[-1]
    if (sh, sw) == (dst_h, dst_w):
        return img
    sxs, cxs = _axis_tab(sw, dst_w)
    sys_, cys = _axis_tab(sh, dst_h)
    s = img.astype(np.uint32)
    h = (256 - cxs) * np.take(s, sxs, axis=-1) + cxs * np.take(
        s, np.minimum(sxs + 1, sw - 1), axis=-1
    )
    v = (256 - cys)[:, None] * np.take(h, sys_, axis=-2) + cys[:, None] * np.take(
        h, np.minimum(sys_ + 1, sh - 1), axis=-2
    )
    return np.minimum((v + (1 << 15)) >> 16, 255).astype(np.uint8)


def _axis_tab_dev(ssz, sbound, dsz, off, out_n: int):
    """Device twin of _axis_tab with an origin shift.

    Returns (idx0, idx1, coef) int32 arrays for output coords
    off..off+out_n-1 of an (ssz → dsz) INTER_LINEAR_EXACT axis; ssz,
    dsz, off are traced scalars, so ONE compiled program serves every
    mining level of a geometry bucket (host tables would cost an upload
    per level). sbound clamps idx1 for sources padded wider than
    ssz. Integer round-half-even identical to the Fraction math of
    _axis_tab (tested value-for-value in tests/test_resize.py)."""
    d = jax.lax.iota(jnp.int32, out_n) + off
    two = 2 * dsz
    num = (2 * d + 1) * ssz - dsz  # = fx · 2·dsz
    sx = jnp.floor_divide(num, two)
    rem = num - sx * two  # ∈ [0, 2·dsz)
    a = 128 * rem  # coef·dsz = frac·256·dsz / 2 → a / dsz
    q = jnp.floor_divide(a, dsz)
    r = a - q * dsz
    c = q + (
        (2 * r > dsz) | ((2 * r == dsz) & (q % 2 == 1))
    ).astype(jnp.int32)
    neg = sx < 0
    sx = jnp.where(neg, 0, sx)
    c = jnp.where(neg, 0, c)
    hi = sx >= ssz - 1
    sx = jnp.where(hi, jnp.maximum(ssz - 2, 0), sx)
    c = jnp.where(hi, jnp.where(ssz > 1, 256, 0), c)
    oob = d >= dsz  # slot rows past the level (caller masks the output)
    sx = jnp.where(oob, 0, sx)
    c = jnp.where(oob, 0, c)
    return sx, jnp.minimum(sx + 1, sbound - 1), c


def _build_level_one(src, sh, sw, dh, dw, oy, ox, hp: int, wp: int):
    """One origin-shifted resized mining level slot, on device.

    src: (Hs, Ws) uint8 (true size (sh, sw), zero-padded); output
    (hp, wp) uint8 = resize_linear_exact(src)[oy:oy+hp, ox:ox+wp] with
    zeros past the level bounds. Both interpolation passes stay exact
    integers in uint32 (coef ≤ 256, pixel ≤ 255 ⇒ v < 2^25), so pass
    order is free: rows first, then columns via transpose + row gather
    (row gathers move whole contiguous rows)."""
    hs, ws = src.shape
    ry0, ry1, cy = _axis_tab_dev(sh, hs, dh, oy, hp)
    cx0, cx1, cx = _axis_tab_dev(sw, ws, dw, ox, wp)
    s = src.astype(jnp.uint32)
    cyu = cy.astype(jnp.uint32)
    cxu = cx.astype(jnp.uint32)
    v = (256 - cyu)[:, None] * jnp.take(s, ry0, axis=0) + cyu[
        :, None
    ] * jnp.take(s, ry1, axis=0)  # (hp, Ws) exact integers
    vt = v.T  # (Ws, hp)
    h = (256 - cxu)[:, None] * jnp.take(vt, cx0, axis=0) + cxu[
        :, None
    ] * jnp.take(vt, cx1, axis=0)  # (wp, hp)
    out = jnp.minimum((h + (1 << 15)) >> 16, 255).astype(jnp.uint8).T
    ri = jax.lax.broadcasted_iota(jnp.int32, (hp, wp), 0)
    ci = jax.lax.broadcasted_iota(jnp.int32, (hp, wp), 1)
    return jnp.where((ri < dh - oy) & (ci < dw - ox), out, 0)


@functools.partial(jax.jit, static_argnames=("hp", "wp"))
def build_level_stack(src_stack, params, hp: int, wp: int):
    """(L, Hs, Ws) uint8 sources + (6, L) int32 scalar params
    [sh, sw, dh, dw, oy, ox] → (L, hp, wp) uint8 origin-shifted resized
    level slots (dense-mining stack input). One program per (source
    bucket, slot bucket) geometry."""
    f = lambda src, p: _build_level_one(  # noqa: E731
        src, p[0], p[1], p[2], p[3], p[4], p[5], hp, wp
    )
    return jax.vmap(f, in_axes=(0, 1))(src_stack, params)
