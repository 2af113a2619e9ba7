"""Numbers that depend on the accelerator's matmul precision: the f32
contractions that must run at HIGHEST, and the exactness of the bf16-limb
products the detector's tail and canvas rely on."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cascadeclassifier_tpu.detect.compact import (
    _exact_int_matmul,
    _limbs_rel,
    _matmul_limbs,
)


def _dot_precisions(jaxpr):
    """precision params of every dot_general, nested programs included."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for v in eqn.params.values():
            sub = getattr(v, "jaxpr", v)
            if hasattr(sub, "eqns"):
                out += _dot_precisions(sub)
    return out


def test_haar_responses_highest_precision_exact():
    """eval_haar's weighted rect-sum contraction asks for HIGHEST and is
    exact on integer rect sums far past TF32's 11-bit mantissa."""
    from cascadeclassifier_tpu.ops.features import eval_haar

    rng = np.random.default_rng(0)
    n, f, p = 6, 5, 64
    # rect sums up to ±2^21 times weight 3: exact in f32, not in TF32
    sums = rng.integers(0, 1 << 20, (n, p)).astype(np.int32)
    offsets = rng.integers(0, p, (f, 3, 4)).astype(np.int32)
    weights = np.tile(np.float32([-1.0, 3.0, 0.0]), (f, 1))
    nf = np.ones(n, np.float32)
    args = (jnp.asarray(sums), None, jnp.asarray(nf), jnp.asarray(offsets),
            jnp.asarray(weights), None)
    jaxpr = jax.make_jaxpr(
        lambda s, q, o, w: eval_haar(s, None, q, o, w, None)
    )(args[0], args[2], args[3], args[4])
    precs = _dot_precisions(jaxpr.jaxpr)
    assert precs and all(
        pr is not None and jax.lax.Precision.HIGHEST in tuple(pr)
        for pr in precs
    ), precs
    got = np.asarray(eval_haar(*args))
    g = sums[:, offsets.reshape(-1)].reshape(n, f, 3, 4).astype(np.int64)
    rs = g[..., 0] - g[..., 1] - g[..., 2] + g[..., 3]
    want = (rs * weights[None].astype(np.int64)).sum(-1)
    np.testing.assert_array_equal(got, want.astype(np.float32))


def test_psum_dot_is_highest_precision():
    """The data-parallel evaluator's weighted accumulation (psum of a
    dot) asks for HIGHEST, like the corner matmul beside it."""
    from jax.sharding import Mesh

    from cascadeclassifier_tpu.parallel.sharded import sharded_batch_eval

    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    fn = sharded_batch_eval(mesh)
    args = (jnp.ones((4, 8), jnp.float32), jnp.ones((4, 8), jnp.float32),
            jnp.ones(4, jnp.float32))
    precs = _dot_precisions(jax.make_jaxpr(fn)(*args).jaxpr)
    assert len(precs) == 2 and all(
        jax.lax.Precision.HIGHEST in tuple(pr) for pr in precs
    ), precs


@pytest.mark.parametrize("stage", [3, 12])
def test_saturated_limb_products_exact(stage):
    """On an all-255 frame every limb is saturated: the bf16 limb matmuls
    (3 relative limbs, 4 absolute limbs) still give the exact int rect
    sums of a real cascade's corner matrix."""
    from cascadeclassifier_tpu.data.synth import HAAR_FRONTALFACE_ALT
    from cascadeclassifier_tpu.detect.compact import _pack_tail
    from cascadeclassifier_tpu.detect.detector import PackedCascade
    from cascadeclassifier_tpu.models.xml_io import read_cascade_xml

    packed = PackedCascade.from_model(read_cascade_xml(HAAR_FRONTALFACE_ALT))
    h, w = 300, 400
    # the detector's integral: int32 with wrap-around, no level reset
    canvas = np.full((h, w), 255, np.int64).cumsum(0).cumsum(1)
    canvas = (canvas + 7 * (1 << 31)).astype(np.int64)
    canvas = ((canvas + (1 << 31)) % (1 << 32) - (1 << 31)).astype(np.int32)
    rng = np.random.default_rng(stage)
    n = 512
    ph = pw = 21
    rr = rng.integers(0, h - ph, n)
    cc = rng.integers(0, w - pw, n)
    dy, dx = np.meshgrid(np.arange(ph), np.arange(pw), indexing="ij")
    ps = canvas[rr[:, None] + dy.reshape(-1), cc[:, None] + dx.reshape(-1)]
    a = _pack_tail(packed.stages, [stage], 20, 20)[0]
    want = (a.astype(np.int64) @ ps.astype(np.int64).T)
    want = ((want + (1 << 31)) % (1 << 32) - (1 << 31)).astype(np.int32)
    a_bf = jnp.asarray(a, jnp.bfloat16)
    got_rel = np.asarray(_matmul_limbs(a_bf, _limbs_rel(jnp.asarray(ps))))
    got_abs = np.asarray(_exact_int_matmul(a_bf, jnp.asarray(ps)))
    assert np.abs(want).max() > 10_000  # saturated window sums
    np.testing.assert_array_equal(got_rel, want)
    np.testing.assert_array_equal(got_abs, want)


def _division_operands(n=1 << 16):
    rng = np.random.default_rng(3)
    raw = rng.integers(-6_000_000, 6_000_000, (4, n)).astype(np.float32)
    nf = np.sqrt(rng.integers(1, 1 << 30, n).astype(np.float64)).astype(
        np.float32
    )
    nf[::97] = 0.0  # zero norm factor -> zero response
    return raw, nf


def _want_quotient(raw, nf):
    with np.errstate(divide="ignore", invalid="ignore"):
        q = raw / nf[None, :]
    return np.where(nf[None, :] != 0.0, q, np.float32(0.0))


def test_normalized_response_correctly_rounded():
    """The Haar/HOG response division is numpy's (IEEE) float32 quotient,
    0 where the norm factor is 0, and its float64 denominator sits behind
    an optimization barrier (the guard against narrowing on the GPU)."""
    from cascadeclassifier_tpu.ops.integral import normalized_response

    raw, nf = _division_operands()
    fn = jax.jit(lambda r, q: normalized_response(r, q[None, :]))
    np.testing.assert_array_equal(np.asarray(fn(raw, nf)), _want_quotient(raw, nf))
    prims = {e.primitive.name for e in fn.trace(raw, nf).jaxpr.eqns}
    assert "optimization_barrier" in prims


@pytest.mark.gpu
def test_gpu_responses_match_cpu_backend(gpu):
    """On the card: the division is correctly rounded, and Haar evaluator
    responses equal the CPU backend's bit for bit."""
    from cascadeclassifier_tpu.data import synth
    from cascadeclassifier_tpu.ops.features import HAAR_BASIC, haar_catalog
    from cascadeclassifier_tpu.ops.integral import normalized_response
    from cascadeclassifier_tpu.train.evaluators import HaarTrainEvaluator

    raw, nf = _division_operands()
    got = jax.jit(lambda r, q: normalized_response(r, q[None, :]))(raw, nf)
    np.testing.assert_array_equal(np.asarray(got), _want_quotient(raw, nf))

    samples = synth.face_samples(512, 5)
    cat = haar_catalog(24, 24, HAAR_BASIC)
    ev = HaarTrainEvaluator(cat, block_size=8192)
    ev.set_samples(samples)
    with jax.default_device(jax.devices("cpu")[0]):
        evc = HaarTrainEvaluator(cat, block_size=8192)
        evc.set_samples(samples)
        want = np.asarray(evc.values_block(3))
    np.testing.assert_array_equal(np.asarray(ev.values_block(3)), want)
