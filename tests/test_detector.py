"""Detector vs the independent OpenCV C++ runtime (parity oracle).

The reference's detection path is OpenCV's detectMultiScale
(tools/detection/Cpp/main.cpp:42-49); these tests assert raw-window and
grouped-detection parity of our detection engines against it."""

import os
import subprocess

import numpy as np
import pytest

from cascadeclassifier_tpu.data.synth import (
    HAAR_FRONTALFACE_ALT as HAAR_ALT,
    LBP_FRONTALFACE as LBP_FRONTAL,
)
from cascadeclassifier_tpu.detect.detector import TPUDetector
from cascadeclassifier_tpu.detect.grouping import group_rectangles
from cascadeclassifier_tpu.models.xml_io import read_cascade_xml

from .utils_synth import face_blob_image

cv2 = pytest.importorskip("cv2")


def _oracle(oracle_bin, xml, img, tmp_path, sf="1.1", mn="0"):
    p = str(tmp_path / "oracle_img.png")
    cv2.imwrite(p, img)
    r = subprocess.run(
        [oracle_bin, xml, p, sf, mn], capture_output=True, text=True
    )
    assert "LOADED" in r.stdout
    return sorted(
        tuple(map(int, l.split())) for l in r.stdout.splitlines()[1:]
    )


@pytest.fixture(scope="module")
def face_img():
    return face_blob_image(240, 180, n=6, seed=3)


# ---- shared truncated-cascade fixtures: the oracle-parity tests are
# compile-bound on cold CPU (dozens of per-stage-chunk programs per
# (plan, engine, precision)); parity over the first 8 stages at one
# shared geometry is equally conclusive for the engine mechanics, so
# all but the full-cascade keystone test run on these -------------------


@pytest.fixture(scope="module")
def haar8(tmp_path_factory):
    """(model, xml_path): haarcascade_frontalface_alt truncated to 8
    stages, re-serialized so the C++ oracle loads the same truncation."""
    import dataclasses

    from cascadeclassifier_tpu.models.xml_io import write_cascade_xml

    m = read_cascade_xml(HAAR_ALT)
    m8 = dataclasses.replace(m, stages=list(m.stages[:8]))
    p = str(tmp_path_factory.mktemp("trunc") / "haar8.xml")
    write_cascade_xml(m8, p)
    return m8, p


@pytest.fixture(scope="module")
def det8(haar8):
    """Shared exact-mode XLA detector over the truncated cascade — its
    per-plan compiled programs are reused across the whole module."""
    return TPUDetector(haar8[0], exact=True, engine="xla")


@pytest.fixture(scope="module")
def det_full():
    """Shared exact-mode detector over the FULL cascade (keystone)."""
    return TPUDetector(read_cascade_xml(HAAR_ALT))


@pytest.mark.slow
def test_bench_config_f32_grouped_parity(oracle_bin, tmp_path):
    """The precision mode bench.py actually measures (exact=False, f32
    fused engine) matches the C++ runtime's grouped detections on the
    FULL cascade at the bench parameters (sf=1.1, minNeighbors=3) —
    including a bench-style adversarial synthetic frame (the same
    generator bench.py times, at a CPU-tractable geometry). Closes the
    gap between the headline fps and the parity proof: the f32 XLA
    front here is the one the GPU serves. Reference oracle:
    tools/detection/Cpp/main.cpp:42-49."""
    from cascadeclassifier_tpu.data.synth import bench_frame

    m = read_cascade_xml(HAAR_ALT)
    det = TPUDetector(m, exact=False, engine="fused")
    imgs = [
        bench_frame(0, 480, 640),
        face_blob_image(640, 480, n=8, seed=11),
        face_blob_image(320, 240, n=4, seed=5),
    ]
    for img in imgs:
        ours = sorted(map(tuple, det.detect_multi_scale(img, 1.1, 3)))
        ref = _oracle(oracle_bin, HAAR_ALT, img, tmp_path, "1.1", "3")
        assert ours == ref


@pytest.mark.slow
def test_haar_raw_window_parity(oracle_bin, tmp_path, det_full, face_img):
    """Keystone: FULL 22-stage cascade, OpenCV-default scaleFactor."""
    ours = sorted(map(tuple, det_full.detect_multi_scale(face_img, 1.1, 0)))
    ref = _oracle(oracle_bin, HAAR_ALT, face_img, tmp_path)
    assert ours == ref


@pytest.mark.slow
def test_haar_grouped_parity(oracle_bin, tmp_path, det_full, face_img):
    # same plan as the raw test → reuses det_full's compiled programs
    ours = sorted(map(tuple, det_full.detect_multi_scale(face_img, 1.1, 2)))
    ref = _oracle(oracle_bin, HAAR_ALT, face_img, tmp_path, mn="2")
    assert ours == ref


@pytest.mark.slow
def test_haar_parity_random_textures(oracle_bin, tmp_path, haar8, det8):
    """Random blurred textures exercise knife-edge windows."""
    rng = np.random.default_rng(11)
    img = rng.integers(0, 256, (160, 200)).astype(np.uint8)
    img = cv2.GaussianBlur(img, (7, 7), 2.0)
    ours = sorted(map(tuple, det8.detect_multi_scale(img, 1.2, 0)))
    ref = _oracle(oracle_bin, haar8[1], img, tmp_path, sf="1.2")
    assert len(ref) > 0
    assert ours == ref


@pytest.mark.slow
def test_lbp_raw_window_parity(oracle_bin, tmp_path, face_img):
    m = read_cascade_xml(LBP_FRONTAL)
    det = TPUDetector(m)
    ours = sorted(map(tuple, det.detect_multi_scale(face_img, 1.2, 0)))
    ref = _oracle(oracle_bin, LBP_FRONTAL, face_img, tmp_path, sf="1.2")
    assert len(ref) > 0
    assert ours == ref


def test_static_front_matches_dense(tmp_path):
    """The fused engine's chunked front programs (stages 1..5 of the full
    cascade, split at FRONT_CHUNK trees) are bit-identical to the XLA
    dense f32 stages applied one by one to the same prep output."""
    import jax.numpy as jnp

    from cascadeclassifier_tpu.detect.dense import dense_stage_haar
    from cascadeclassifier_tpu.detect.detector import (
        PackedCascade,
        plan_tables,
    )
    from cascadeclassifier_tpu.detect.engine import FusedEngine
    from cascadeclassifier_tpu.detect.pyramid import build_plan

    m = read_cascade_xml(HAAR_ALT)
    packed = PackedCascade.from_model(m)
    rng = np.random.default_rng(5)
    w, h = 160, 120
    img = rng.integers(0, 256, (h, w)).astype(np.uint8)
    plan = build_plan(w, h, packed.win_w, packed.win_h, 1.1, None, None)
    tab = plan_tables(plan)
    eng = FusedEngine(packed, exact=False, n_front=6)
    eng.FRONT_CHUNK = 40  # several front programs over stages 1..5
    (canvas, prep), fronts, _tail, (R, Cs) = eng.program(plan, 1 << 10)
    assert len(fronts) > 1
    sum2d, sq2d, tilt2d = canvas(jnp.asarray(img), tab, R, Cs)
    inv_nf, alive0 = prep(sum2d, sq2d, tilt2d, tab)
    got = alive0
    for f in fronts:
        got = f(sum2d, tilt2d, inv_nf, got)
    out_h = plan.canvas_h - packed.win_h
    out_w = plan.canvas_w - packed.win_w
    ref = alive0
    for si in range(1, 6):
        st = packed.stages[si]
        ref = ref & (
            dense_stage_haar(
                sum2d, sum2d, st, out_h, out_w, inv_nf, exact=False
            )
            >= jnp.float32(st.threshold)
        )
    refn = np.asarray(ref)
    assert 0 < refn.sum() < np.asarray(alive0).sum()  # non-vacuous
    np.testing.assert_array_equal(np.asarray(got), refn)


def test_visit_set_matches_oracle_exactly(oracle_bin, tmp_path):
    """Pin the exact window visit-set + output mapping of the OpenCV 4.x
    invoker (pure numpy vs an always-pass cascade run through the C++
    oracle — no detector compile):

      - nstripes = cvCeil(szw0.width/32.); y < min(nstripes·stripeSize,
        prH) with stripeSize = max(ceil((prH//ystep)/nstripes),1)·ystep —
        stripe OVERSHOOT visits the last odd grid row iff nstripes does
        not divide prH//ystep (cascadedetect.cpp invoker geometry)
      - x < prW stepped by ystep
      - output rect = cvRound(x·scale) with FLOAT32 multiplies (ScaleData
        ::scale is float; 50·1.21f == 60.5f rounds to even 60), box =
        cvRound(origWin·scale_f32), clipped per-axis to image bounds
    """
    import dataclasses
    from collections import Counter

    from cascadeclassifier_tpu.detect.pyramid import build_plan
    from cascadeclassifier_tpu.models.xml_io import write_cascade_xml

    m = read_cascade_xml(HAAR_ALT)
    st0 = dataclasses.replace(m.stages[0], threshold=-1e6)
    mp = dataclasses.replace(m, stages=[st0])
    tpath = str(tmp_path / "pass.xml")
    write_cascade_xml(mp, tpath)
    rng = np.random.default_rng(7)
    for (w, h) in [(137, 101), (64, 55), (200, 173)]:
        img = rng.integers(0, 256, (h, w)).astype(np.uint8)
        ref = Counter(map(tuple, _oracle(oracle_bin, tpath, img, tmp_path)))
        plan = build_plan(w, h, 20, 20, 1.1, None, None)
        mine = Counter()
        for s in range(len(plan.scales)):
            sc = np.float32(plan.scales[s])
            step = int(plan.ystep[s])
            t = int(plan.block_top[s])
            h_s, w_s = int(plan.scaled_h[s]), int(plan.scaled_w[s])
            if w_s < 20 or h_s < 20:
                continue
            bw, bh = int(plan.box_w[s]), int(plan.box_h[s])
            for yc in np.nonzero(plan.row_is_grid[t : t + h_s + 1])[0]:
                for xc in range(0, w_s + 1 - 20, step):
                    xi = int(np.rint(np.float32(xc) * sc))
                    yi = int(np.rint(np.float32(yc) * sc))
                    mine[(xi, yi, min(bw, w - xi), min(bh, h - yi))] += 1
        assert mine == ref, (w, h)


@pytest.mark.slow
def test_variance_gate_rejects_flat_regions(det8, face_img):
    # face_img geometry + scale → plan cache hit on the shared detector
    flat = np.full(face_img.shape, 90, np.uint8)
    assert len(det8.detect_multi_scale(flat, 1.2, 0)) == 0


@pytest.mark.slow
def test_min_size_filter(oracle_bin, tmp_path, haar8, det8, face_img):
    ours = sorted(
        map(tuple, det8.detect_multi_scale(face_img, 1.2, 0, min_size=(40, 40)))
    )
    p = str(tmp_path / "oracle_img.png")
    cv2.imwrite(p, face_img)
    r = subprocess.run(
        [oracle_bin, haar8[1], p, "1.2", "0", "40", "40"],
        capture_output=True,
        text=True,
    )
    ref = sorted(tuple(map(int, l.split())) for l in r.stdout.splitlines()[1:])
    assert len(ref) > 0
    assert ours == ref


def test_grouping_clips_after_average():
    """detectMultiScale clips to the image AFTER groupRectangles
    (cascadedetect.cpp clipObjects runs on the grouped output): a
    coarsest-level candidate overhanging the bottom edge contributes its
    UNCLIPPED height to the cluster average. Captured from a real
    640x480 frontalface_alt divergence: grouping the pre-clipped list
    gives h=132, the oracle (group-then-clip) gives h=133."""
    from cascadeclassifier_tpu.detect.grouping import clip_rects

    members = np.array(
        [
            (22, 333, 148, 148),   # y+h=481 > 480: unclipped height
            (30, 333, 148, 148),   # ditto
            (34, 343, 135, 135),
            (51, 359, 101, 101),
        ],
        np.int64,
    )
    # unclipped heights sum 532 -> avg 133.0; pre-clipped sum 530 ->
    # avg 132.5 -> round-half-even 132 (the old wrong answer)
    grouped = clip_rects(group_rectangles(members, 2), 640, 480)
    assert grouped.shape == (1, 4)
    assert tuple(map(int, grouped[0])) == (34, 342, 133, 133)
    pre = members.copy()
    pre[:, 3] = np.minimum(pre[:, 3], 480 - pre[:, 1])
    assert int(group_rectangles(pre, 2)[0][3]) == 132


def test_group_rectangles_semantics():
    # three nearly identical rects + one outlier; threshold 2 keeps the
    # averaged cluster only
    rects = [(10, 10, 50, 50), (12, 11, 50, 50), (9, 10, 51, 50), (200, 200, 40, 40)]
    out = group_rectangles(rects, 2)
    assert out.shape == (1, 4)
    assert abs(out[0][0] - 10) <= 1 and abs(out[0][2] - 50) <= 1
    # threshold 0 → unchanged
    out0 = group_rectangles(rects, 0)
    assert len(out0) == 4


@pytest.mark.slow
def test_deep_tree_parity(oracle_bin, tmp_path, face_img):
    """Depth-2 weak trees (predictOrdered path in the OpenCV runtime)."""
    from cascadeclassifier_tpu.models.model import (
        CascadeModel,
        HaarFeature,
        Stage,
        WeakTree,
    )
    from cascadeclassifier_tpu.models.xml_io import write_cascade_xml

    # two depth-2 trees over simple edge features
    t1 = WeakTree(
        left=np.array([1, 0, -1], np.int32),
        right=np.array([2, -2, -3], np.int32),
        feature_idx=np.array([0, 1, 2], np.int32),
        threshold=np.array([0.01, -0.05, 0.03], np.float32),
        leaf_values=np.array([0.9, -0.8, 0.7, -0.6], np.float32),
    )
    t2 = WeakTree(
        left=np.array([0, ], np.int32),
        right=np.array([-1, ], np.int32),
        feature_idx=np.array([1], np.int32),
        threshold=np.array([0.0], np.float32),
        leaf_values=np.array([0.5, -0.5], np.float32),
    )
    m = CascadeModel(
        feature_type=0,
        width=20,
        height=20,
        stages=[Stage(threshold=0.2, trees=[t1, t2])],
        features=[
            HaarFeature(rects=[(2, 2, 8, 8, -1.0), (2, 2, 4, 8, 2.0)]),
            HaarFeature(rects=[(4, 4, 12, 6, -1.0), (4, 7, 12, 3, 2.0)]),
            HaarFeature(rects=[(0, 0, 20, 20, -1.0), (5, 5, 10, 10, 4.0)]),
        ],
        max_depth=2,
    )
    xml = str(tmp_path / "deep.xml")
    write_cascade_xml(m, xml)
    det = TPUDetector(m)
    ours = sorted(map(tuple, det.detect_multi_scale(face_img, 1.2, 0)))
    ref = _oracle(oracle_bin, xml, face_img, tmp_path, sf="1.2")
    assert len(ref) > 0  # non-vacuous
    assert ours == ref


@pytest.mark.slow
def test_tilted_cascade_parity(oracle_bin, tmp_path):
    """ALL-mode Haar cascade with tilted features + deep trees
    (haarcascade_eye_tree_eyeglasses ships both; truncated to 6 stages —
    tilted-integral + deep-walk semantics are fully exercised)."""
    import dataclasses

    from cascadeclassifier_tpu.models.xml_io import write_cascade_xml

    xml = "/usr/share/opencv4/haarcascades/haarcascade_eye_tree_eyeglasses.xml"
    if not os.path.exists(xml):
        pytest.skip("pretrained tilted cascade missing")
    m = read_cascade_xml(xml)
    assert m.uses_tilted()
    m6 = dataclasses.replace(m, stages=list(m.stages[:6]))
    x6 = str(tmp_path / "eye6.xml")
    write_cascade_xml(m6, x6)
    rng = np.random.default_rng(4)
    img = cv2.GaussianBlur(
        rng.integers(0, 256, (160, 200)).astype(np.uint8), (9, 9), 3
    )
    det = TPUDetector(m6)
    ours = sorted(map(tuple, det.detect_multi_scale(img, 1.2, 0)))
    ref = _oracle(oracle_bin, x6, img, tmp_path, sf="1.2")
    assert len(ref) > 0
    assert ours == ref


@pytest.fixture(scope="module")
def ref8f(haar8, face_img):
    """f32 XLA detections over the truncated cascade — the shared
    reference for the engine-parity tests."""
    xla = TPUDetector(haar8[0], exact=False, engine="xla")
    out = sorted(map(tuple, xla.detect_multi_scale(face_img, 1.2, 0)))
    assert len(out) > 0
    return out


@pytest.mark.slow
def test_compact_engine_matches_xla(haar8, det8, face_img, ref8f):
    """The survivor-compaction engine (dense front + limb-matmul tail)
    must reproduce the XLA dense path exactly, in both precision modes."""
    refs = {
        True: sorted(
            map(tuple, det8.detect_multi_scale(face_img, 1.2, 0))
        ),
        False: ref8f,
    }
    for exact in (True, False):
        cmp_ = TPUDetector(haar8[0], exact=exact, engine="compact")
        # small trigger forces the tail path even on a small test image
        cmp_.trigger_n = 1 << 12
        cmp_.compact_batch = 1 << 10
        b = sorted(map(tuple, cmp_.detect_multi_scale(face_img, 1.2, 0)))
        assert b == refs[exact] and len(b) > 0


@pytest.mark.slow
def test_fused_engine_matches_xla(haar8, det8, face_img, ref8f):
    """The single-dispatch fused engine (canvas + walk + dense front +
    fixed-capacity matmul tail in chained programs with no host syncs) must
    reproduce the XLA dense path exactly, in both precision modes."""
    refs = {
        True: sorted(
            map(tuple, det8.detect_multi_scale(face_img, 1.2, 0))
        ),
        False: ref8f,
    }
    for exact in (False, True):
        fus = TPUDetector(haar8[0], exact=exact, engine="fused")
        fus._fused.tail_n = 8192  # CPU-sized tail capacity
        got = sorted(map(tuple, fus.detect_multi_scale(face_img, 1.2, 0)))
        assert got == refs[exact] and len(got) > 0


def _fused(model, n_front=6, tail_n=4096):
    from cascadeclassifier_tpu.detect.engine import FusedEngine

    det = TPUDetector(model, exact=False, engine="fused")
    det._fused = FusedEngine(
        det.packed, exact=False, n_front=n_front, tail_n=tail_n,
    )
    return det


def test_fused_static_engine_parity():
    """End-to-end fused engine with its dense front over every stage of a
    6-stage cascade — detections come from the dense path's own
    extraction — must match the XLA engine exactly."""
    import dataclasses

    m = read_cascade_xml(HAAR_ALT)
    m6 = dataclasses.replace(m, stages=list(m.stages[:6]))
    img = face_blob_image(240, 180, n=4, seed=7)
    fus = _fused(m6)
    got = sorted(map(tuple, fus.detect_multi_scale(img, 1.2, 0)))
    assert fus._fused.n_dense == len(m6.stages)
    ref = TPUDetector(m6, exact=False, engine="xla")
    want = sorted(map(tuple, ref.detect_multi_scale(img, 1.2, 0)))
    assert got == want and len(got) > 0


@pytest.mark.parametrize("variant", ["default"])
def test_fused_hybrid_slot_tail_parity(variant):
    """Dense front + limb-matmul tail: front stages 1..2,
    survivor extraction, patch gather and the re-compacting tail over
    stages 3.. must match the XLA engine exactly."""
    import dataclasses

    m = read_cascade_xml(HAAR_ALT)
    m10 = dataclasses.replace(m, stages=list(m.stages[:10]))
    img = face_blob_image(240, 180, n=4, seed=7)
    fus = _fused(m10, n_front=3)
    got = sorted(map(tuple, fus.detect_multi_scale(img, 1.2, 0)))
    assert fus._fused.n_dense < len(m10.stages)  # tail actually ran
    ref = TPUDetector(m10, exact=False, engine="xla")
    want = sorted(map(tuple, ref.detect_multi_scale(img, 1.2, 0)))
    assert got == want and len(got) > 0


def test_fused_lbp_engine_parity():
    """The fused LBP path (LBP prep without variance gate + LBP compact
    tail) must match the XLA engine exactly."""
    import dataclasses

    m = read_cascade_xml(LBP_FRONTAL)
    m4 = dataclasses.replace(m, stages=list(m.stages[:4]))
    img = face_blob_image(240, 180, n=4, seed=9)
    fus = TPUDetector(m4, exact=False, engine="fused")
    assert fus._fused is not None
    fus._fused.tail_n = 4096
    got = sorted(map(tuple, fus.detect_multi_scale(img, 1.2, 0)))
    ref = TPUDetector(m4, exact=False, engine="xla")
    want = sorted(map(tuple, ref.detect_multi_scale(img, 1.2, 0)))
    assert got == want and len(got) > 0


def test_parity_visited_matches_walk_scan():
    """Closed-form visited mask == the serial lax.scan walk."""
    import jax.numpy as jnp
    from cascadeclassifier_tpu.detect.dense import dense_walk_visited
    from cascadeclassifier_tpu.detect.engine import (
        parity_visited, static_visit_grid,
    )
    from cascadeclassifier_tpu.detect.pyramid import build_plan

    rng = np.random.default_rng(2)
    plan = build_plan(160, 120, 20, 20, 1.2)
    out_h = plan.canvas_h - 20
    out_w = plan.canvas_w - 20
    m0 = jnp.asarray(rng.random((out_h, out_w)) < 0.35)
    ref = dense_walk_visited(
        m0,
        jnp.asarray(plan.row_is_grid[:out_h]),
        jnp.asarray(plan.row_step2[:out_h]),
        jnp.asarray(plan.row_maxc[:out_h]),
    )
    got = parity_visited(m0, jnp.asarray(static_visit_grid(plan)))
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def test_fused_engine_tilted_deep_parity():
    """Tilted + depth-2 cascades (eye_tree_eyeglasses) run on the fused
    single-dispatch engine (all-dense XLA front, tilted canvas) and must
    match the XLA engine exactly — previously they fell back to the
    host-synced dense path."""
    import dataclasses

    xml = "/usr/share/opencv4/haarcascades/haarcascade_eye_tree_eyeglasses.xml"
    if not os.path.exists(xml):
        pytest.skip("pretrained tilted cascade missing")
    m = read_cascade_xml(xml)
    m4 = dataclasses.replace(m, stages=list(m.stages[:4]))
    rng = np.random.default_rng(6)
    img = cv2.GaussianBlur(
        rng.integers(0, 256, (120, 160)).astype(np.uint8), (9, 9), 3
    )
    ref = TPUDetector(m4, exact=False, engine="xla")
    want = sorted(map(tuple, ref.detect_multi_scale(img, 1.2, 0)))
    fus = TPUDetector(m4, exact=False, engine="fused")
    assert fus._fused is not None
    got = sorted(map(tuple, fus.detect_multi_scale(img, 1.2, 0)))
    assert got == want and len(got) > 0


def test_fused_engine_tilted_stump_tail_parity(tmp_path):
    """A tilted all-stump cascade exercises the fused matmul tail's tilted
    patch path (patchify over the tilted canvas)."""
    import dataclasses

    xml = "/usr/share/opencv4/haarcascades/haarcascade_eye_tree_eyeglasses.xml"
    if not os.path.exists(xml):
        pytest.skip("pretrained tilted cascade missing")
    m = read_cascade_xml(xml)
    # stump-ify: keep only the root split of every tree so the cascade
    # stays tilted but all-stump (tail-packable)
    def stumpify(t):
        from cascadeclassifier_tpu.models.model import WeakTree

        return WeakTree(
            left=np.array([0], np.int32),
            right=np.array([-1], np.int32),
            feature_idx=t.feature_idx[:1].copy(),
            threshold=t.threshold[:1].copy(),
            leaf_values=np.array(
                [t.leaf_values[0], t.leaf_values[-1]], np.float32
            ),
        )

    from cascadeclassifier_tpu.models.model import Stage

    stages = [
        Stage(threshold=st.threshold - 2.0,
              trees=[stumpify(t) for t in st.trees])
        for st in m.stages[:8]
    ]
    ms = dataclasses.replace(m, stages=stages, max_depth=1)
    rng = np.random.default_rng(8)
    img = cv2.GaussianBlur(
        rng.integers(0, 256, (120, 160)).astype(np.uint8), (7, 7), 2
    )
    ref = TPUDetector(ms, exact=False, engine="xla")
    want = sorted(map(tuple, ref.detect_multi_scale(img, 1.2, 0)))
    fus = TPUDetector(ms, exact=False, engine="fused")
    fus._fused.tail_n = 4096
    got = sorted(map(tuple, fus.detect_multi_scale(img, 1.2, 0)))
    assert fus._fused.n_dense < len(ms.stages)  # tail actually ran
    assert got == want and len(got) > 0


def test_fused_batched_head_programs_identical(face_img):
    """The vmapped F-frame head programs (detect_async_batch: canvas,
    prep and the front vmapped, tail per frame) must produce exactly the
    per-frame results."""
    import dataclasses

    m = read_cascade_xml(HAAR_ALT)
    m6 = dataclasses.replace(m, stages=list(m.stages[:6]))
    frames = [face_blob_image(240, 180, n=4, seed=s) for s in range(6)]

    det1 = TPUDetector(m6, exact=False, engine="fused")
    det1._fused.tail_n = 4096
    det1._fused.BATCH_F = 1  # per-frame reference
    ref = det1.detect_multi_scale_batch(frames, 1.2, 0)
    assert sum(len(r) for r in ref) > 0

    det2 = TPUDetector(m6, exact=False, engine="fused")
    det2._fused.tail_n = 4096
    det2._fused.BATCH_F = 4  # 4-frame groups + 2 per-frame remainder
    got = det2.detect_multi_scale_batch(frames, 1.2, 0)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a, b)


def test_windowed_batch_submission_matches_per_frame(face_img):
    """The single-chip batch path packs PACK=16-frame result chunks and
    fetches the oldest once more than IN_FLIGHT are outstanding
    (allocator backpressure fix). 21 frames exercise a full chunk plus
    a partial 5-frame final chunk (its own pack program size), and
    result-order preservation across the windowed fetches."""
    import dataclasses

    m = read_cascade_xml(HAAR_ALT)
    m6 = dataclasses.replace(m, stages=list(m.stages[:6]))
    frames = [face_blob_image(160, 140, n=3, seed=s) for s in range(21)]

    det = TPUDetector(m6, exact=False, engine="fused")
    det._fused.tail_n = 4096
    ref = [det.detect_multi_scale(f, 1.2, 0) for f in frames]
    assert sum(len(r) for r in ref) > 0
    got = det.detect_multi_scale_batch(frames, 1.2, 0)
    assert len(got) == len(frames)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("wh", [(1920, 1080), (1280, 720), (640, 480),
                                (333, 257)])
def test_fused_engine_builds_at_geometry(wh):
    """Program construction (plan → chained program set) must succeed at
    production geometries — catches canvas and front chunking arithmetic
    bugs without executing any program."""
    from cascadeclassifier_tpu.detect.detector import PackedCascade
    from cascadeclassifier_tpu.detect.engine import FusedEngine
    from cascadeclassifier_tpu.detect.pyramid import build_plan

    w, h = wh
    m = read_cascade_xml(HAAR_ALT)
    packed = PackedCascade.from_model(m)
    plan = build_plan(w, h, packed.win_w, packed.win_h, 1.1, None, None)
    n_front_trees = sum(st.ntrees for st in packed.stages[1:6])
    eng = FusedEngine(packed, exact=False)
    (canvas, prep), fronts, tail, consts = eng.program(plan, 1 << 14)
    assert eng.n_dense == 6 and tail is not None
    assert len(fronts) >= n_front_trees // FusedEngine.FRONT_CHUNK
    R, Cs = consts
    assert R.shape == (plan.canvas_h, plan.img_h)
    assert len(Cs) == len(plan.scales)


@pytest.mark.parametrize("n_front", [2, 3])
def test_fused_split_tail_parity(n_front):
    """Fused XLA front cut over to the limb-matmul tail after n_front
    stages (survivor extraction → patch gather → re-compacting tail)
    matches the XLA engine exactly."""
    import dataclasses

    from cascadeclassifier_tpu.detect.engine import FusedEngine

    m = read_cascade_xml(HAAR_ALT)
    m6 = dataclasses.replace(m, stages=list(m.stages[:6]))
    img = face_blob_image(240, 180, n=4, seed=7)
    fus = TPUDetector(m6, exact=False, engine="fused")
    fus._fused = FusedEngine(
        fus.packed, exact=False, n_front=n_front, tail_n=4096,
    )
    got = sorted(map(tuple, fus.detect_multi_scale(img, 1.2, 0)))
    assert fus._fused.n_dense == n_front < len(m6.stages)
    ref = TPUDetector(m6, exact=False, engine="xla")
    want = sorted(map(tuple, ref.detect_multi_scale(img, 1.2, 0)))
    assert got == want and len(got) > 0


def test_fused_overflow_falls_back_to_adaptive(haar8):
    """Forcing the static tail capacity to overflow on a dense-detection
    frame must transparently re-run the frame through the host-adaptive
    engine with IDENTICAL results (the OpenCV runtime has no capacity
    cliffs — reference tools/detection/Cpp/main.cpp:42-49)."""
    import dataclasses

    frames = [face_blob_image(200, 160, n=4, seed=s) for s in (1, 2)]

    fus = TPUDetector(haar8[0], exact=False, engine="fused")
    fus._fused.tail_n = 32  # guaranteed overflow on these frames
    got = fus.detect_multi_scale_batch(frames, 1.2, 0)
    assert fus._fallback is not None and fus._fallback.engine == "compact"

    ref = TPUDetector(haar8[0], exact=False, engine="xla")
    want = [ref.detect_multi_scale(f, 1.2, 0) for f in frames]
    assert sum(len(w) for w in want) > 32  # the overflow was real
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)

    # LBP cascades have no compact engine: fallback must route to xla
    m = read_cascade_xml(LBP_FRONTAL)
    m4 = dataclasses.replace(m, stages=list(m.stages[:4]))
    fusl = TPUDetector(m4, exact=False, engine="fused")
    fusl._fused.tail_n = 32
    gotl = fusl.detect_multi_scale_batch(frames[:1], 1.2, 0)
    assert fusl._fallback is not None and fusl._fallback.engine == "xla"
    refl = TPUDetector(m4, exact=False, engine="xla")
    np.testing.assert_array_equal(
        gotl[0], refl.detect_multi_scale(frames[0], 1.2, 0)
    )


def test_nonfused_batch_path_pipelines(haar8, face_img):
    """detect_multi_scale_batch on the xla engine (windowed submit/fetch)
    must reproduce the serial per-frame results in order."""
    det = TPUDetector(haar8[0], exact=False, engine="xla")
    frames = [face_blob_image(160, 140, n=3, seed=s) for s in range(7)]
    want = [det.detect_multi_scale(f, 1.2, 0) for f in frames]
    got = det.detect_multi_scale_batch(frames, 1.2, 0)
    assert len(got) == len(want) and sum(len(w) for w in want) > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
