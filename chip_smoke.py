"""Bring-up check on one NVIDIA GPU: detection and training through the
public entry points, each compared with the plain reference.

    python3 chip_smoke.py               # one card
    python3 chip_smoke.py --four-gpus   # the multi-card paths, four cards

Phases (any failure raises; the script then exits non-zero and never
prints the final "ok" line):

  device     the first JAX device must be a GPU; prints its kind, count,
             and nvidia-smi's name and power limit.
  detection  1080p seeded synthetic frame (cascadeclassifier_tpu/data/
             synth.py), frontal-face Haar and LBP cascades, every engine
             (xla is the reference), exact=True and exact=False, against
             the OpenCV C++ runtime's committed rects (tests/golden/
             detect/): exact=True must match exactly; an exact=False
             difference must sit on a window whose f64 stage margin is
             ≤ 1e-5. Prints compile seconds, steady ms/frame over 8
             frames and detection counts per engine.
  kernels    the fused engine's programs at 1080p one by one (canvas,
             prep, dense front, tail: ms each); bf16-limb matmuls on an
             all-255 frame against int64 numpy at the tail's widths.
  training   24x24 Haar BASIC, GAB, numPos 2000, numNeg 1000, numStages
             20 capped at 2 stages, through CascadeTrainer.train on
             generated data; cascade.xml read back and detected with;
             evaluator responses and stage 0's first split against the
             CPU backend of this process (computed in a thread while the
             card runs the phases above).

--four-gpus runs only: the feature-sharded StageTrainer on a 4-card mesh
against one card, and 4-card round-robin detection against one card.

The last line of stdout is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from cascadeclassifier_tpu.data import synth  # noqa: E402

MARGIN_TOL = 1e-5
FIDELITY_TOL = 6e-8  # README: Haar evaluator responses vs the reference


def log(msg):
    print(msg, flush=True)


def sorted_rects(r):
    return sorted(map(tuple, np.asarray(r, np.int64).reshape(-1, 4).tolist()))


# ---------------------------------------------------------------- device


def device_phase(n_cards):
    import jax

    devs = jax.devices()
    d = devs[0]
    if d.platform != "gpu":
        raise SystemExit(
            f"chip_smoke: needs a GPU; JAX's first device is {d.platform}"
        )
    if len(devs) < n_cards:
        raise SystemExit(f"chip_smoke: needs {n_cards} GPUs, found {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    log(f"device: {d.device_kind}, {len(devs)} visible, jax {jax.__version__}")
    for line in smi:
        log(f"nvidia-smi: {line}")
    return devs


# ---------------------------------------------------- host f64 reference


def _level_integrals(frame, plan, s):
    from cascadeclassifier_tpu.ops.resize import resize_linear_exact_np

    lv = resize_linear_exact_np(
        frame, int(plan.scaled_w[s]), int(plan.scaled_h[s])
    ).astype(np.int64)
    ii = np.zeros((lv.shape[0] + 1, lv.shape[1] + 1), np.int64)
    ii[1:, 1:] = lv.cumsum(0).cumsum(1)
    sq = np.zeros_like(ii)
    sq[1:, 1:] = (lv * lv).cumsum(0).cumsum(1)
    return ii, sq


def _windows_of_rect(plan, rect, img_w, img_h):
    """(level, y, x) windows whose output rect is `rect` (unclipped
    cvRound(pos·scale) with f32 scale, then clipped to the image)."""
    x, y, bw, bh = rect
    out = []
    for s in range(len(plan.scales)):
        f = np.float32(plan.scales[s])
        if min(int(plan.box_w[s]), img_w - x) != bw:
            continue
        if min(int(plan.box_h[s]), img_h - y) != bh:
            continue
        for c in range(int(x / f) - 2, int(x / f) + 3):
            for r in range(int(y / f) - 2, int(y / f) + 3):
                if (c >= 0 and r >= 0
                        and int(np.rint(np.float32(c) * f)) == x
                        and int(np.rint(np.float32(r) * f)) == y):
                    out.append((s, r, c))
    return out


def window_margin(packed, frame, plan, rect):
    """Smallest |f64 stage sum − stage threshold| over the stages the f64
    (OpenCV) walk evaluates for the window behind `rect`."""
    from cascadeclassifier_tpu.models.model import FEATURE_HAAR

    h, w = frame.shape
    best = np.inf
    for s, y, x in _windows_of_rect(plan, rect, w, h):
        ii, sq = _level_integrals(frame, plan, s)

        def rsum(a, rx, ry, rw, rh):
            return int(a[y + ry, x + rx] - a[y + ry, x + rx + rw]
                       - a[y + ry + rh, x + rx] + a[y + ry + rh, x + rx + rw])

        inv = np.float32(1.0)
        if packed.feature_type == FEATURE_HAAR:
            rw_, rh_ = packed.win_w - 2, packed.win_h - 2
            area = rw_ * rh_
            nf2 = area * rsum(sq, 1, 1, rw_, rh_) - rsum(ii, 1, 1, rw_, rh_) ** 2
            if nf2 <= 0:
                continue
            inv = np.float32(1.0 / np.sqrt(np.float64(nf2)))
        for st in packed.stages:
            ssum = 0.0
            for t in range(st.ntrees):
                if packed.feature_type == FEATURE_HAAR:
                    raw = None
                    for r in range(3):
                        wt = np.float32(st.weights[t, r])
                        if wt == 0.0:
                            continue
                        term = np.float32(rsum(ii, *st.feat_rects[t, r])) * wt
                        raw = term if raw is None else np.float32(raw + term)
                    go_left = np.float32(raw * inv) < np.float32(st.thr[t])
                else:
                    cx, cy, cw, ch = (int(v) for v in st.lbp_rects[t])
                    cs = [[rsum(ii, cx + c * cw, cy + r * ch, cw, ch)
                           for c in range(3)] for r in range(3)]
                    code = 0
                    for r, c, bit in ((0, 0, 128), (0, 1, 64), (0, 2, 32),
                                      (1, 2, 16), (2, 2, 8), (2, 1, 4),
                                      (2, 0, 2), (1, 0, 1)):
                        code |= bit if cs[r][c] >= cs[1][1] else 0
                    word = int(st.subsets[t, code >> 5])
                    go_left = (word >> (code & 31)) & 1 != 0
                ssum += float(st.left_leaf[t] if go_left
                              else st.right_leaf[t])
            m = ssum - float(st.threshold)
            best = min(best, abs(m))
            if m < 0:
                break
    return best


def compare_with_golden(name, got, want, exact, margin_of):
    """Raise unless `got` equals `want` (as sorted rect lists); in f32
    mode a difference is allowed where every differing window's stage
    margin is within MARGIN_TOL (margin_of(rect) → float, or None for
    grouped output)."""
    g, w = sorted_rects(got), sorted_rects(want)
    if g == w:
        return 0
    diff = sorted(set(g) ^ set(w))
    log(f"  {name}: {len(diff)} rects differ from the oracle "
        f"(ours {len(g)}, oracle {len(w)})")
    if exact:
        raise AssertionError(f"{name}: exact=True differs from the oracle")
    if margin_of is None:
        return len(diff)
    for r in diff:
        m = margin_of(r)
        side = "ours only" if r in set(g) else "oracle only"
        log(f"    {r} ({side}): stage margin {m:.3e}")
        if not m <= MARGIN_TOL:
            raise AssertionError(f"{name}: {r} differs with margin {m}")
    return len(diff)


def golden_frames(key, n):
    """n frames like the golden frame `key`, seeds following its own."""
    spec = synth.GOLDEN_FRAMES[key]
    return [synth.face_blob_image(**{**spec, "seed": spec["seed"] + k})
            for k in range(n)]


def detection_phase(key="1920x1080", n_timed=8):
    from cascadeclassifier_tpu.detect.detector import PackedCascade, TPUDetector
    from cascadeclassifier_tpu.detect.pyramid import build_plan
    from cascadeclassifier_tpu.models.xml_io import read_cascade_xml

    frame = synth.golden_frame(key)
    frames8 = golden_frames(key, n_timed)
    sf = synth.GOLDEN_SCALE
    h, w = frame.shape
    f32_diffs = {}
    for cascade, xml in synth.GOLDEN_CASCADES.items():
        model = read_cascade_xml(xml)
        packed = PackedCascade.from_model(model)
        plan = build_plan(w, h, packed.win_w, packed.win_h, sf)
        want = {mn: synth.read_golden(cascade, key, mn) for mn in (0, 3)}
        log(f"detection {cascade} {key}: oracle {len(want[0])} raw, "
            f"{len(want[3])} grouped")
        engines = ["xla", "fused"] + (["compact"] if cascade == "haar" else [])
        for engine in engines:
            for exact in (True, False):
                name = f"{cascade}/{engine}/{'f64' if exact else 'f32'}"
                det = TPUDetector(model, exact=exact, engine=engine)
                t0 = time.perf_counter()
                raw = det.detect_multi_scale(frame, sf, 0)
                compile_s = time.perf_counter() - t0
                grouped = det.detect_multi_scale(frame, sf, 3)
                nd = compare_with_golden(
                    name + "/mn0", raw, want[0], exact,
                    lambda r: window_margin(packed, frame, plan, r),
                )
                nd3 = compare_with_golden(
                    name + "/mn3", grouped, want[3], exact, None
                )
                if nd3 and not nd:
                    raise AssertionError(
                        f"{name}: grouped rects differ with no raw difference"
                    )
                f32_diffs[name] = nd
                det.detect_multi_scale_batch(frames8, sf, 3)  # warm
                t0 = time.perf_counter()
                # the rects come back as host arrays: every device
                # program of the batch has finished when this returns
                res = det.detect_multi_scale_batch(frames8, sf, 3)
                ms = (time.perf_counter() - t0) / len(frames8) * 1e3
                log(f"  {name}: engine={det.engine} compile+first "
                    f"{compile_s:.1f} s, steady {ms:.2f} ms/frame "
                    f"({len(frames8)} frames, mn=3), raw {len(raw)}, "
                    f"grouped {len(grouped)}, detections "
                    f"{sum(len(r) for r in res)} on {len(frames8)} frames")
    return f32_diffs


# ---------------------------------------------------------------- kernels


def kernel_phase(key="1920x1080"):
    import jax
    import jax.numpy as jnp

    from cascadeclassifier_tpu.detect.compact import (
        _exact_int_matmul,
        _limbs_rel,
        _matmul_limbs,
        _pack_tail,
    )
    from cascadeclassifier_tpu.detect.detector import PackedCascade, plan_tables
    from cascadeclassifier_tpu.detect.engine import FusedEngine
    from cascadeclassifier_tpu.detect.pyramid import build_plan
    from cascadeclassifier_tpu.models.xml_io import read_cascade_xml

    model = read_cascade_xml(synth.HAAR_FRONTALFACE_ALT)
    packed = PackedCascade.from_model(model)
    frame = synth.golden_frame(key)
    h, w = frame.shape
    plan = build_plan(w, h, packed.win_w, packed.win_h, synth.GOLDEN_SCALE)
    tab = plan_tables(plan)
    out_h, out_w = plan.canvas_h - packed.win_h, plan.canvas_w - packed.win_w

    # the fused engine's chained programs, each timed alone (n
    # dispatches ending in block_until_ready)
    eng = FusedEngine(packed, exact=False)
    max_det = 1 << 14
    (canvas, prep), fronts, tail, (R, Cs) = eng.program(plan, max_det)
    img = jnp.asarray(frame)
    n = 20

    def timed(name, f, *args):
        out = jax.block_until_ready(f(*args))  # compile + warm
        t0 = time.perf_counter()
        for _ in range(n):
            o = f(*args)
        jax.block_until_ready(o)
        log(f"  {name}: {(time.perf_counter() - t0) / n * 1e3:.3f} ms")
        return out

    log(f"kernels: fused engine programs, {plan.canvas_h}x{plan.canvas_w} "
        f"canvas, front stages 1..{eng.n_dense - 1} in {len(fronts)} "
        f"program(s)")
    sum2d, sq2d, tilt2d = timed("canvas", canvas, img, tab, R, Cs)
    inv_nf, alive = timed("prep", prep, sum2d, sq2d, tilt2d, tab)
    for i, f in enumerate(fronts):
        alive = timed(f"front[{i}]", f, sum2d, tilt2d, inv_nf, alive)
    out = timed("tail", tail, sum2d, tilt2d, inv_nf, alive)
    raw = eng.finish(out, max_det)
    log(f"  front survivors {int(np.asarray(out[2]))}, raw detections "
        f"{len(raw)} (oracle {len(synth.read_golden('haar', key, 0))})")

    # exact bf16-limb products: all-255 frame, tail widths, vs int64
    white = np.full((h, w), 255, np.uint8)
    s255 = np.asarray(canvas(jnp.asarray(white), tab, R, Cs)[0])
    rng = np.random.default_rng(0)
    n_win = eng.tail_n
    rr = rng.integers(0, out_h, n_win)
    cc = rng.integers(0, out_w, n_win)
    ph, pw = packed.win_h + 1, packed.win_w + 1
    dy, dx = np.meshgrid(np.arange(ph), np.arange(pw), indexing="ij")
    ps = s255[rr[:, None] + dy.reshape(-1), cc[:, None] + dx.reshape(-1)]
    # the widest tail stage: (3 * trees, P) corner matrix
    big = max(range(len(packed.stages)), key=lambda i: packed.stages[i].ntrees)
    a_sum = _pack_tail(packed.stages, [big], packed.win_w, packed.win_h)[0]
    # float64 products of these integers are exact (|sums| << 2^53)
    want = np.rint(a_sum.astype(np.float64) @ ps.astype(np.float64).T)
    a_bf = jnp.asarray(a_sum, jnp.bfloat16)
    got_rel = np.asarray(jax.jit(
        lambda a, p: _matmul_limbs(a, _limbs_rel(p)))(a_bf, jnp.asarray(ps)))
    got_abs = np.asarray(jax.jit(_exact_int_matmul)(a_bf, jnp.asarray(ps)))
    want32 = want.astype(np.int64).astype(np.int32)  # rect sums fit int32
    if not (np.array_equal(got_rel, want32) and np.array_equal(got_abs, want32)):
        raise AssertionError("bf16-limb products are not exact on this card")
    log(f"  bf16-limb products exact: ({a_sum.shape[0]}, {a_sum.shape[1]}) x "
        f"({n_win}, {ps.shape[1]}), all-255 frame, max |sum| "
        f"{int(np.abs(want32).max())}")

    # the evaluators' response division, on random operands against
    # numpy's IEEE float32 quotient
    from cascadeclassifier_tpu.ops.integral import normalized_response

    num = rng.integers(-6_000_000, 6_000_000, (1024, 4096)).astype(np.float32)
    den = np.sqrt(rng.integers(1, 1 << 30, 4096).astype(np.float64)).astype(
        np.float32
    )
    got = np.asarray(jax.jit(lambda a, b: normalized_response(a, b[None, :]))(
        num, den))
    bad = int((got != num / den[None, :]).sum())
    log(f"  response division: {bad} of {got.size} quotients differ from "
        f"numpy's float32 division")
    if bad:
        raise AssertionError("normalized_response is not correctly rounded")


# --------------------------------------------------------------- training


def make_training_set(td, n_pos, n_bg, seed=7):
    from cascadeclassifier_tpu.data.negreader import write_pgm
    from cascadeclassifier_tpu.data.vec import write_vec

    vec = os.path.join(td, "pos.vec")
    # headroom for positives the earlier stages reject (minHitRate 0.995)
    write_vec(vec, synth.face_samples(n_pos + n_pos // 10, seed))
    names = []
    for k in range(n_bg):
        p = os.path.join(td, f"bg{k}.pgm")
        write_pgm(p, synth.near_face_image(640, 480, seed + 1 + k))
        names.append(p)
    bg = os.path.join(td, "bg.txt")
    with open(bg, "w") as f:
        f.write("\n".join(names) + "\n")
    return vec, bg


def stage0_samples(vec, bg, n_pos, n_neg, win=24):
    """The sample set CascadeTrainer.train builds for stage 0 (every
    positive and every scheduled window passes an empty cascade)."""
    from cascadeclassifier_tpu.data.negreader import NegReader
    from cascadeclassifier_tpu.data.vec import PosReader

    pos = PosReader(vec, win, win).take(n_pos)
    neg = NegReader(bg, win, win).take_batch(n_neg)
    samples = np.concatenate([pos, neg])
    labels = np.r_[np.ones(len(pos), np.int32), np.zeros(len(neg), np.int32)]
    n_pad = max(256, -(-len(samples) // 256) * 256)
    valid = np.zeros(n_pad, bool)
    valid[:len(samples)] = True
    samples = np.concatenate(
        [samples, np.zeros((n_pad - len(samples), win, win), np.uint8)]
    )
    labels = np.r_[labels, np.zeros(n_pad - len(labels), np.int32)]
    return samples, labels, valid


def split_quality(ev, var_ids, labels, valid):
    """Best GAB root-split quality of each feature in var_ids (equal
    weights, responses ±1 — the first tree of a stage)."""
    import jax.numpy as jnp

    from cascadeclassifier_tpu.train.boost import _ordered_split_block, as_f64

    vals = ev.values_for_vars(var_ids)
    n = int(valid.sum())
    w = as_f64(np.where(valid, 1.0 / n, 0.0))
    resp = as_f64(np.where(labels > 0, 1.0, -1.0))
    q, _thr = _ordered_split_block(
        vals, jnp.argsort(vals, axis=1), w, resp, jnp.asarray(valid)
    )
    return np.asarray(q, np.float64)


def argmax_premise():
    """train/boost.py::_best_of_block avoids jnp.argmax inside x64 scopes;
    report whether argmax agrees on this backend, and require the
    workaround to give the first maximum."""
    import jax
    import jax.numpy as jnp

    from cascadeclassifier_tpu.train.boost import _best_of_block

    q = np.random.default_rng(1).integers(0, 50, 40000).astype(np.float64)
    with jax.enable_x64(True):
        qj = jnp.asarray(q)
        am = int(jax.jit(jnp.argmax)(qj))
        _qm, i = _best_of_block(qj)
    first = int(np.argmax(q))
    if int(i) != first:
        raise AssertionError("_best_of_block lost the first maximum")
    log(f"  x64 argmax premise: jnp.argmax {'agrees' if am == first else 'DIFFERS'}"
        f" with the first maximum on this backend")


def cpu_reference(samples, labels, valid):
    """The plain reference on the CPU backend of this process: evaluator
    block 0 and stage 0's first tree. main() runs it in a thread beside
    the GPU phases (it is the slowest part of the script)."""
    import jax

    from cascadeclassifier_tpu.ops.features import HAAR_BASIC, haar_catalog
    from cascadeclassifier_tpu.train.boost import BoostParams, StageTrainer
    from cascadeclassifier_tpu.train.evaluators import HaarTrainEvaluator

    with jax.default_device(jax.devices("cpu")[0]):
        ev = HaarTrainEvaluator(haar_catalog(24, 24, HAAR_BASIC))
        ev.set_samples(samples)
        vals = np.asarray(ev.values_block(0))
        t0 = time.perf_counter()
        stage, _ = StageTrainer(ev, BoostParams(weak_count=1)).train(
            labels, valid=valid, verbose=False
        )
        return ev, vals, stage, time.perf_counter() - t0


def training_phase(vec, bg, stage0, cpu_ref, n_pos=2000, n_neg=1000,
                   n_stages=2):
    """stage0: stage0_samples(vec, bg, ...); cpu_ref: a future of
    cpu_reference(*stage0)."""
    import jax

    from cascadeclassifier_tpu.detect.detector import TPUDetector
    from cascadeclassifier_tpu.models.xml_io import read_cascade_xml
    from cascadeclassifier_tpu.ops.features import HAAR_BASIC, haar_catalog
    from cascadeclassifier_tpu.train.boost import BoostParams, StageTrainer
    from cascadeclassifier_tpu.train.evaluators import HaarTrainEvaluator
    from cascadeclassifier_tpu.train.trainer import CascadeTrainer

    out = tempfile.mkdtemp(prefix="chip_smoke_train_")
    t0 = time.perf_counter()
    tr = CascadeTrainer(win_w=24, win_h=24, haar_mode="BASIC",
                        boost=BoostParams())
    # the reference's default job (numStages 20 and its stop rules),
    # capped at n_stages
    model = tr.train(out, vec, bg, n_pos, n_neg, num_stages=20,
                     max_stages=n_stages, verbose=False)
    train_s = time.perf_counter() - t0
    if model is None or len(model.stages) != n_stages:
        raise AssertionError(f"training stopped early: {model and len(model.stages)}")
    log(f"training: {len(model.stages)} stages "
        f"({[len(s.trees) for s in model.stages]} trees), "
        f"{train_s:.1f} s, {len(tr.evaluator.catalog)} features")

    back = read_cascade_xml(os.path.join(out, "cascade.xml"))
    scene = synth.clutter_image(320, 240, 99)
    tiles = synth.face_samples(8, 123)
    for k, t in enumerate(tiles):
        y, x = 40 + (k // 4) * 80, 20 + (k % 4) * 70
        scene[y:y + 24, x:x + 24] = t
    rects = TPUDetector(back).detect_multi_scale(scene, 1.1, 0)
    if len(rects) == 0:
        raise AssertionError("trained cascade.xml detects nothing")
    log(f"  cascade.xml reloaded: {len(back.stages)} stages, "
        f"{len(rects)} raw detections on a 320x240 scene with 8 placed "
        f"positives")

    samples, labels, valid = stage0
    ev = HaarTrainEvaluator(haar_catalog(24, 24, HAAR_BASIC))
    ev.set_samples(samples)
    vg = np.asarray(ev.values_block(0))
    sg, _ = StageTrainer(ev, BoostParams(weak_count=1)).train(
        labels, valid=valid, verbose=False
    )
    t0 = time.perf_counter()
    evc, vc, sc, cpu_s = cpu_ref.result()
    wait_s = time.perf_counter() - t0
    err = float(np.abs(vg - vc).max())
    log(f"  evaluator block 0 {vg.shape}: max |gpu - cpu| {err:.2e}, "
        f"{int((vg != vc).sum())} differ")
    if err > FIDELITY_TOL:
        raise AssertionError("evaluator responses differ from the CPU")
    tg, tc = sg.trees[0], sc.trees[0]
    fg, fc = int(tg.feature_idx[0]), int(tc.feature_idx[0])
    thg, thc = float(tg.threshold[0]), float(tc.threshold[0])
    log(f"  stage 0 first split: gpu var {fg} thr {thg!r}, cpu var {fc} "
        f"thr {thc!r} (cpu {cpu_s:.1f} s, {wait_s:.1f} s of it waited for)")
    if (fg, thg) != (fc, thc):
        # a tie may break differently: the two splits' qualities must
        # agree on both backends
        q = {"gpu": split_quality(ev, [fg, fc], labels, valid)}
        with jax.default_device(jax.devices("cpu")[0]):
            q["cpu"] = split_quality(evc, [fg, fc], labels, valid)
        log(f"  first split tie: qualities gpu {q['gpu']}, cpu {q['cpu']}")
        vals = np.concatenate([q["gpu"], q["cpu"]])
        if np.ptp(vals) > 1e-6 * np.abs(vals).max():
            raise AssertionError("stage 0 first split differs from the CPU")
    argmax_premise()
    return len(model.stages), train_s


# ------------------------------------------------------------- four cards


def four_gpu_phase(devs, n_pos=2000, n_neg=1000, key="1920x1080"):
    from jax.sharding import Mesh

    from cascadeclassifier_tpu.detect.detector import TPUDetector
    from cascadeclassifier_tpu.models.xml_io import read_cascade_xml
    from cascadeclassifier_tpu.ops.features import HAAR_BASIC, haar_catalog
    from cascadeclassifier_tpu.train.boost import BoostParams, StageTrainer
    from cascadeclassifier_tpu.train.evaluators import HaarTrainEvaluator

    td = tempfile.mkdtemp(prefix="chip_smoke_4gpu_")
    vec, bg = make_training_set(td, n_pos, 6)
    samples, labels, valid = stage0_samples(vec, bg, n_pos, n_neg)
    cat = haar_catalog(24, 24, HAAR_BASIC)
    mesh = Mesh(np.array(devs[:4]), ("feat",))
    stages = []
    for m in (mesh, None):
        ev = HaarTrainEvaluator(cat)
        ev.set_samples(samples)
        t0 = time.perf_counter()
        st, sums = StageTrainer(ev, BoostParams(), mesh=m).train(
            labels, valid=valid, verbose=False
        )
        stages.append((st, np.asarray(sums), time.perf_counter() - t0))
    (s4, sum4, t4), (s1, sum1, t1) = stages
    same = len(s4.trees) == len(s1.trees) and all(
        np.array_equal(a.feature_idx, b.feature_idx)
        and np.array_equal(a.threshold, b.threshold)
        and np.array_equal(a.leaf_values, b.leaf_values)
        for a, b in zip(s4.trees, s1.trees)
    ) and np.array_equal(sum4, sum1)
    log(f"four-gpus: feature-sharded stage on 4 cards {len(s4.trees)} trees "
        f"{t4:.1f} s, 1 card {len(s1.trees)} trees {t1:.1f} s, "
        f"identical={same}")
    if not same:
        raise AssertionError("sharded stage differs from the 1-card stage")

    det = TPUDetector(read_cascade_xml(synth.HAAR_FRONTALFACE_ALT),
                      exact=False, engine="fused")
    frames = golden_frames(key, 16)
    one = det.detect_multi_scale_batch(frames, 1.1, 3)
    four = det.detect_multi_scale_batch(frames, 1.1, 3, devices=devs[:4])
    ms = {}
    for name, dv in (("1 card", None), ("4 cards", devs[:4])):
        t0 = time.perf_counter()
        det.detect_multi_scale_batch(frames, 1.1, 3, devices=dv)
        ms[name] = (time.perf_counter() - t0) / len(frames) * 1e3
    same = all(np.array_equal(a, b) for a, b in zip(one, four))
    log(f"four-gpus: round-robin detection over 4 cards identical={same} "
        f"({sum(len(r) for r in one)} detections on {len(frames)} "
        f"{key} frames; steady ms/frame: "
        + ", ".join(f"{k} {v:.2f}" for k, v in ms.items()) + ")")
    if not same:
        raise AssertionError("4-card detection differs from 1-card")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the 4-card checks")
    args = ap.parse_args()
    t_all = time.perf_counter()
    devs = device_phase(4 if args.four_gpus else 1)
    if args.four_gpus:
        four_gpu_phase(devs)
        count = 4
    else:
        # the training set first: its CPU reference runs in a thread
        # while the card works through the other phases
        td = tempfile.mkdtemp(prefix="chip_smoke_data_")
        vec, bg = make_training_set(td, 2000, 24)
        stage0 = stage0_samples(vec, bg, 2000, 1000)
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            cpu_ref = pool.submit(cpu_reference, *stage0)
            detection_phase()
            kernel_phase()
            training_phase(vec, bg, stage0, cpu_ref)
        count = 1
    d = devs[0]
    log(f"all phases passed in {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": count,
    }}), flush=True)


if __name__ == "__main__":
    main()
