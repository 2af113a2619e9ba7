"""Integral-image kernels vs cv2 / numpy golden semantics."""

import numpy as np
import pytest

import jax.numpy as jnp

from cascadeclassifier_tpu.ops.integral import (
    integral_image,
    integral_sq,
    integral_tilted,
    window_norm_factor,
)

cv2 = pytest.importorskip("cv2")


@pytest.mark.parametrize("shape", [(1, 1), (5, 9), (24, 24), (33, 57), (75, 32)])
def test_integral_sum_matches_cv2(shape):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, shape).astype(np.uint8)
    ref = cv2.integral(img)
    out = np.asarray(integral_image(jnp.asarray(img)))
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("shape", [(5, 9), (24, 24), (75, 32)])
def test_integral_sq_matches_cv2(shape):
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, shape).astype(np.uint8)
    _, ref_sq = cv2.integral2(img)
    out = np.asarray(integral_sq(jnp.asarray(img)))
    np.testing.assert_array_equal(out.astype(np.int64), ref_sq.astype(np.int64))


@pytest.mark.parametrize("shape", [(1, 1), (3, 3), (8, 5), (24, 24), (31, 17)])
def test_integral_tilted_matches_cv2(shape):
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, shape).astype(np.uint8)
    _, _, ref = cv2.integral3(img)
    out = np.asarray(integral_tilted(jnp.asarray(img)))
    np.testing.assert_array_equal(out, ref)


def test_integral_batched():
    rng = np.random.default_rng(3)
    imgs = rng.integers(0, 256, (7, 20, 16)).astype(np.uint8)
    s = np.asarray(integral_image(jnp.asarray(imgs)))
    t = np.asarray(integral_tilted(jnp.asarray(imgs)))
    for i in range(7):
        ref_s, _, ref_t = cv2.integral3(imgs[i])
        np.testing.assert_array_equal(s[i], ref_s)
        np.testing.assert_array_equal(t[i], ref_t)


def test_norm_factor_matches_reference_formula():
    """calcNormFactor (features.cpp:13-25): rect (1,1,W-2,H-2), sqrt(area·sq−s²)."""
    rng = np.random.default_rng(4)
    for (h, w) in [(24, 24), (32, 75), (16, 20)]:
        img = rng.integers(0, 256, (h, w)).astype(np.uint8)
        s, sq = cv2.integral2(img)
        area = (w - 2) * (h - 2)
        v_s = int(s[1, 1]) - int(s[1, w - 1]) - int(s[h - 1, 1]) + int(s[h - 1, w - 1])
        v_q = sq[1, 1] - sq[1, w - 1] - sq[h - 1, 1] + sq[h - 1, w - 1]
        ref = np.float32(np.sqrt(area * v_q - float(v_s) ** 2))
        out = np.asarray(
            window_norm_factor(
                integral_image(jnp.asarray(img))[None],
                integral_sq(jnp.asarray(img))[None],
            )
        )[0]
        assert out == pytest.approx(float(ref), rel=1e-6)


def test_norm_factor_zero_on_constant_image():
    img = np.full((24, 24), 77, np.uint8)
    out = np.asarray(
        window_norm_factor(
            integral_image(jnp.asarray(img))[None],
            integral_sq(jnp.asarray(img))[None],
        )
    )[0]
    assert out == 0.0
