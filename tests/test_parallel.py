"""Sharded training step on the virtual 8-device CPU mesh."""

import os
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from cascadeclassifier_tpu.parallel.sharded import (
    make_mesh,
    shard_features,
    sharded_batch_eval,
    sharded_ordered_best_split,
)
from cascadeclassifier_tpu.train.boost import _ordered_split_block, as_f64

needs_8 = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


@needs_8
def test_sharded_split_matches_single_device():
    rng = np.random.default_rng(0)
    f, n = 64, 96
    values = rng.normal(size=(f, n)).astype(np.float32)
    sort_idx = np.argsort(values, axis=1).astype(np.int32)
    w = rng.uniform(0.1, 1, n)
    w /= w.sum()
    resp = rng.choice([-1.0, 1.0], n)
    mask = np.ones(n, bool)

    q, thr = _ordered_split_block(
        jnp.asarray(values), jnp.asarray(sort_idx), as_f64(w), as_f64(resp),
        jnp.asarray(mask),
    )
    q, thr = np.asarray(q), np.asarray(thr)
    ref_var = int(np.argmax(q))

    mesh = make_mesh(8)
    vs, si = shard_features(mesh, values, sort_idx)
    fn = sharded_ordered_best_split(mesh)
    gq, gvar, gthr = jax.device_get(
        fn(vs, si, as_f64(w), as_f64(resp), jnp.asarray(mask))
    )
    assert int(gvar) == ref_var
    assert float(gq) == pytest.approx(float(q[ref_var]), rel=1e-12)
    assert float(gthr) == pytest.approx(float(thr[ref_var]), abs=1e-6)


@needs_8
def test_sharded_batch_eval_psum():
    rng = np.random.default_rng(1)
    p_len, b = 128, 64
    corner_m = rng.normal(size=(32, p_len)).astype(np.float32)
    sum_rows = rng.normal(size=(b, p_len)).astype(np.float32)
    wts = np.full(b, 1.0 / b, np.float32)
    mesh = make_mesh(8, axis="data")
    from jax.sharding import NamedSharding, PartitionSpec as P

    sr = jax.device_put(sum_rows, NamedSharding(mesh, P("data", None)))
    wv = jax.device_put(wts, NamedSharding(mesh, P("data")))
    vals, wsum = jax.device_get(
        sharded_batch_eval(mesh)(jnp.asarray(corner_m), sr, wv)
    )
    ref = corner_m @ sum_rows.T @ wts
    np.testing.assert_allclose(wsum, ref, rtol=1e-4)
    np.testing.assert_allclose(vals, corner_m @ sum_rows.T, rtol=1e-4)


def test_graft_entry_dryrun():
    import __graft_entry__ as g

    if len(jax.devices()) >= 8:
        g.dryrun_multichip(8)
    fn, args = g.entry()
    r = jax.jit(fn)(*args)
    assert int(r) >= 0


def _haar_stage_setup(n=64, win=10):
    from cascadeclassifier_tpu.ops.features import HAAR_BASIC, haar_catalog
    from cascadeclassifier_tpu.train.evaluators import HaarTrainEvaluator

    rng = np.random.default_rng(3)
    samples = rng.integers(0, 256, (n, win, win)).astype(np.uint8)
    labels = (np.arange(n) % 2).astype(np.int32)
    samples[labels == 1, 2:7, 2:7] = 230
    cat = haar_catalog(win, win, HAAR_BASIC)

    def make_ev(block_size=4096):
        ev = HaarTrainEvaluator(cat, block_size=block_size)
        ev.set_samples(samples)
        return ev

    return make_ev, labels


def _stages_equal(a, b):
    assert a is not None and b is not None
    assert a.threshold == b.threshold
    assert len(a.trees) == len(b.trees)
    for ta, tb in zip(a.trees, b.trees):
        np.testing.assert_array_equal(ta.feature_idx, tb.feature_idx)
        np.testing.assert_array_equal(ta.threshold, tb.threshold)
        np.testing.assert_array_equal(ta.leaf_values, tb.leaf_values)


@needs_8
def test_stage_trainer_sharded_identical():
    """StageTrainer on an 8-device feature-sharded mesh must produce the
    exact stage the single-device run does (GSPMD partitioning of the
    split kernels preserves per-feature arithmetic bit-for-bit)."""
    from cascadeclassifier_tpu.train.boost import BoostParams, StageTrainer

    make_ev, labels = _haar_stage_setup()
    params = BoostParams(weak_count=3, max_depth=1)
    s_local, sums_local = StageTrainer(make_ev(), params).train(
        labels, verbose=False
    )
    mesh = make_mesh(8)
    s_shard, sums_shard = StageTrainer(make_ev(), params, mesh=mesh).train(
        labels, verbose=False
    )
    _stages_equal(s_local, s_shard)
    np.testing.assert_array_equal(sums_local, sums_shard)


def test_stage_trainer_budgeted_cache_identical():
    """A tiny precalc budget (forcing value recompute + on-demand sorts for
    most blocks — the valBufMB/idxBufMB fallbacks of
    o_cvcascadeboosttraindata.cpp:250-264) must not change the result."""
    from cascadeclassifier_tpu.train.boost import BoostParams, StageTrainer

    make_ev, labels = _haar_stage_setup()
    params = BoostParams(weak_count=3, max_depth=2)
    s_full, _ = StageTrainer(make_ev(512), params).train(
        labels, verbose=False
    )
    # 512-feature blocks × 64 samples × 4B = 128 KiB/value block;
    # 0.15 MB → 1 of 2 value blocks resident, 0 idx blocks: block 1
    # re-evaluates its values and re-sorts on every access
    tr = StageTrainer(make_ev(512), params, val_buf_mb=0.15, idx_buf_mb=0.01)
    cache_probe = []
    orig_find = tr._find_best_split

    def probe(cache, *a, **k):
        cache_probe.append((cache.n_val, cache.n_idx, cache.num_blocks))
        return orig_find(cache, *a, **k)

    tr._find_best_split = probe
    s_budget, _ = tr.train(labels, verbose=False)
    _stages_equal(s_full, s_budget)
    n_val, n_idx, nb = cache_probe[0]
    assert nb > 1 and n_val == 1 and n_idx == 0


@needs_8
def test_cli_mesh_flag_resolves():
    """-numDevices builds the feature mesh the trainer receives."""
    from cascadeclassifier_tpu.tools.traincascade_cli import (
        build_parser,
        make_trainer,
        resolve_mesh,
    )

    args = build_parser().parse_args(
        ["-data", "/tmp/x", "-vec", "a.vec", "-bg", "bg.txt",
         "-numDevices", "8", "-w", "12", "-h", "12"]
    )
    mesh = resolve_mesh(args)
    assert mesh is not None and dict(mesh.shape) == {"feat": 8}
    tr = make_trainer(args, mesh=mesh)
    assert tr.mesh is mesh
    # 0/1 devices -> single-device path
    args1 = build_parser().parse_args(
        ["-data", "/tmp/x", "-vec", "a.vec", "-bg", "bg.txt",
         "-numDevices", "1"]
    )
    assert resolve_mesh(args1) is None


@needs_8
@pytest.mark.slow
def test_cli_sharded_training_identical(tmp_path):
    """CLI-driven sharded training (-numDevices 8) writes stages
    byte-identical to the single-device run."""
    import cv2

    from cascadeclassifier_tpu.data.vec import write_vec
    from cascadeclassifier_tpu.tools.traincascade_cli import main

    rng = np.random.default_rng(5)
    pos = rng.integers(0, 90, (120, 12, 12)).astype(np.uint8)
    pos[:, 3:9, 3:9] = rng.integers(190, 256, (120, 6, 6))
    write_vec(str(tmp_path / "pos.vec"), pos)
    bg = rng.integers(0, 256, (96, 128)).astype(np.uint8)
    cv2.imwrite(str(tmp_path / "bg.png"), bg)
    with open(tmp_path / "bg.txt", "w") as f:
        f.write(str(tmp_path / "bg.png") + "\n")

    outs = {}
    for nd in (1, 8):
        d = tmp_path / f"data{nd}"
        d.mkdir()
        rc = main(
            ["-data", str(d), "-vec", str(tmp_path / "pos.vec"),
             "-bg", str(tmp_path / "bg.txt"), "-w", "12", "-h", "12",
             "-numPos", "100", "-numNeg", "80", "-numStages", "1",
             "-maxWeakCount", "3", "-numDevices", str(nd)]
        )
        assert rc == 0
        outs[nd] = (d / "stage0.xml").read_text()
    assert outs[1] == outs[8]


def test_multihost_dcn_split_matches_single_process(tmp_path):
    """Executed multi-host path: two OS processes,
    one CPU device each, joined via jax.distributed.initialize through
    `sharded.init_distributed`; the feature-sharded split search runs on
    the 2-device global mesh (all_gather crosses the process boundary)
    and both processes must report exactly the single-process answer."""
    import json
    import socket
    import subprocess
    import sys

    from cascadeclassifier_tpu.train.boost import as_f64 as _f64

    # single-process reference on the same seed-0 problem
    rng = np.random.default_rng(0)
    f, n = 64, 96
    values = rng.normal(size=(f, n)).astype(np.float32)
    sort_idx = np.argsort(values, axis=1).astype(np.int32)
    w = rng.uniform(0.1, 1, n)
    w /= w.sum()
    resp = rng.choice([-1.0, 1.0], n)
    q, thr = _ordered_split_block(
        jnp.asarray(values), jnp.asarray(sort_idx), _f64(w), _f64(resp),
        jnp.ones(n, bool),
    )
    q, thr = np.asarray(q), np.asarray(thr)
    ref_var = int(np.argmax(q))

    with socket.socket() as s:  # free port for the coordinator
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"
    worker = os.path.join(os.path.dirname(__file__), "multihost_worker.py")
    outs = [str(tmp_path / f"p{i}.json") for i in range(2)]
    env = {
        k: v for k, v in os.environ.items()
        if k not in ("XLA_FLAGS", "JAX_PLATFORMS", "JAX_PLATFORM_NAME")
    }
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(i), coord, outs[i]],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for i in range(2)
    ]
    logs = []
    for p in procs:
        out, _ = p.communicate(timeout=180)
        logs.append(out.decode(errors="replace"))
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    for i in range(2):
        with open(outs[i]) as fh:
            res = json.load(fh)
        assert res["process_id"] == i
        assert res["var"] == ref_var
        assert res["quality"] == pytest.approx(float(q[ref_var]), rel=1e-12)
        assert res["threshold"] == pytest.approx(
            float(thr[ref_var]), abs=1e-6
        )


def test_multi_device_detection_batch_identical():
    """Data-parallel detection: frames round-robin across the 8 virtual
    devices must produce exactly the single-device per-frame results
    (detector.detect_multi_scale_batch(devices=...))."""
    import jax

    from cascadeclassifier_tpu.detect.detector import TPUDetector
    from cascadeclassifier_tpu.models.xml_io import read_cascade_xml
    from .utils_synth import face_blob_image

    xml = "/usr/share/opencv4/haarcascades/haarcascade_frontalface_alt.xml"
    if not os.path.exists(xml):
        pytest.skip("pretrained cascade missing")
    import dataclasses

    m = read_cascade_xml(xml)
    m4 = dataclasses.replace(m, stages=list(m.stages[:4]))
    frames = [face_blob_image(240, 180, n=3, seed=s) for s in range(5)]
    det = TPUDetector(m4, exact=False, engine="fused")
    det._fused.tail_n = 4096
    single = det.detect_multi_scale_batch(frames, 1.2, 0)
    multi = det.detect_multi_scale_batch(
        frames, 1.2, 0, devices=jax.devices()[:4]
    )
    assert len(single) == len(multi) == 5
    total = 0
    for a, b in zip(single, multi):
        np.testing.assert_array_equal(a, b)
        total += len(a)
    assert total > 0
