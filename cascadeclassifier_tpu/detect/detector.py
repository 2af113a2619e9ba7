"""Multi-scale cascade detector.

Re-design of the OpenCV ``cv::CascadeClassifier::detectMultiScale`` pipeline
(the runtime the reference delegates to — see reference
tools/detection/Cpp/main.cpp:42-49 and SURVEY §3.2) as a few chained XLA
programs per frame geometry:

  stage 0: bit-exact resize of every pyramid level into one integral canvas
           (detect/pyramid.py)
  stage 1: per-window variance gate + stage-by-stage masked evaluation over
           *all* windows of *all* levels at once, with survivor compaction
           between stages (replaces the branchy per-window early-exit loop)
  stage 2: OpenCV's sequential x-walk (ystep + skip-after-stage0-reject)
           replayed as a vectorized scan so the emitted window set matches
           the reference detector exactly
  host   : cvRound coordinate mapping + groupRectangles (detect/grouping.py)

Runtime semantics replicated (empirically validated against the C++ oracle):
  - variance gate: reject window unless nf² > 0 and area/nf < 0.1 (σ > 10)
  - Haar value = f32(Σ wᵢ·rectsumᵢ) · f32(1/√nf²); split: value < threshold
  - stage pass: Σ leaves ≥ f32(stageThreshold) − 1e-5
  - LBP: no gate; categorical split via subset bitmask (bit set → left)
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from cascadeclassifier_tpu.detect.dense import (
    canvas_tilted,
    dense_stage_deep,
    dense_stage_haar,
    dense_stage_lbp,
    dense_variance_gate,
    dense_walk_visited,
)
from cascadeclassifier_tpu.detect.grouping import clip_rects, group_rectangles
from cascadeclassifier_tpu.detect.pyramid import PyramidPlan, build_plan
from cascadeclassifier_tpu.models.model import (
    FEATURE_HAAR,
    FEATURE_LBP,
    CascadeModel,
)

THRESHOLD_EPS = np.float32(1e-5)


# ---------------------------------------------------------------------------
# model packing
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PackedStage:
    threshold: np.float32  # effective (xml − 1e-5)
    ntrees: int
    # stump fast path (max_nodes == 1)
    feat_rects: np.ndarray | None  # (T, 3, 4) int32 rect geometry (Haar)
    weights: np.ndarray | None  # (T, 3) float32
    tilted: np.ndarray | None  # (T,) bool
    thr: np.ndarray | None  # (T,) float32 (ordered)
    subsets: np.ndarray | None  # (T, 8) int32 (categorical stumps)
    left_leaf: np.ndarray | None  # (T,) float32
    right_leaf: np.ndarray | None
    lbp_rects: np.ndarray | None  # (T, 4) int32 (LBP)
    # deep-tree path (any tree with >1 internal node); when set, the stump
    # arrays above hold node 0 only and deep_trees drives evaluation
    deep_trees: list | None = None  # [(tree: WeakTree, node_feats: list)]


@dataclasses.dataclass
class PackedCascade:
    feature_type: int
    win_w: int
    win_h: int
    stages: list
    has_tilted: bool

    @classmethod
    def from_model(cls, m: CascadeModel) -> "PackedCascade":
        stages = []
        for s in m.stages:
            t = len(s.trees)
            fr = np.zeros((t, 3, 4), np.int32)
            w = np.zeros((t, 3), np.float32)
            tl = np.zeros(t, bool)
            thr = np.zeros(t, np.float32)
            subs = np.zeros((t, 8), np.int32)
            ll = np.zeros(t, np.float32)
            rl = np.zeros(t, np.float32)
            lbp = np.zeros((t, 4), np.int32)
            for i, tree in enumerate(s.trees):
                f = m.features[int(tree.feature_idx[0])]
                if tree.left[0] <= 0:
                    ll[i] = tree.leaf_values[-int(tree.left[0])]
                if tree.right[0] <= 0:
                    rl[i] = tree.leaf_values[-int(tree.right[0])]
                if m.feature_type == FEATURE_HAAR:
                    for ri, (x, y, rw, rh, wt) in enumerate(f.rects):
                        fr[i, ri] = (x, y, rw, rh)
                        w[i, ri] = wt
                    tl[i] = f.tilted
                    thr[i] = tree.threshold[0]
                elif m.feature_type == FEATURE_LBP:
                    lbp[i] = f.rect
                    subs[i] = tree.subsets[0]
                else:
                    raise NotImplementedError(
                        "HOG cascades are served by detect/hog_detector.py::"
                        "HOGDetector (the CLI routes them automatically)"
                    )
            deep = None
            if any(tr.num_nodes > 1 for tr in s.trees):
                deep = [
                    (tr, [m.features[int(v)] for v in tr.feature_idx])
                    for tr in s.trees
                ]
            stages.append(
                PackedStage(
                    threshold=np.float32(s.threshold) - THRESHOLD_EPS,
                    ntrees=t,
                    feat_rects=fr,
                    weights=w,
                    tilted=tl,
                    thr=thr,
                    subsets=subs,
                    left_leaf=ll,
                    right_leaf=rl,
                    lbp_rects=lbp,
                    deep_trees=deep,
                )
            )
        has_tilted = m.uses_tilted()
        return cls(
            feature_type=m.feature_type,
            win_w=m.width,
            win_h=m.height,
            stages=stages,
            has_tilted=has_tilted,
        )


def plan_tables(plan: PyramidPlan) -> dict:
    """Device-resident lookup tables for one pyramid plan (passed as jit
    arguments so XLA does not constant-fold multi-MB plan arrays)."""
    return dict(
        sx0=jnp.asarray(plan.sx0, jnp.int32),
        cx=jnp.asarray(plan.cx, jnp.uint32),
        sy0=jnp.asarray(plan.sy0),
        cy=jnp.asarray(plan.cy, jnp.uint32),
        row_w=jnp.asarray(plan.row_w),
        is_top=jnp.asarray(plan.is_top),
        top_of_row=jnp.asarray(plan.top_of_row),
        row_is_grid=jnp.asarray(plan.row_is_grid),
        row_step2=jnp.asarray(plan.row_step2),
        row_maxc=jnp.asarray(plan.row_maxc),
    )


def _resize_matrices(plan):
    """Banded INTER_LINEAR_EXACT resample matrices for the matmul resize.

    The row pass is one (canvas_h, img_h) matrix shared by every level;
    the column pass is one (img_w, w_s) matrix per level, whose result
    lands at the level's canvas rows. Coefficients are integers ≤ 256
    (exact in bfloat16), so the matmuls reproduce the fixed-point gather
    arithmetic bit-for-bit (see _build_canvas).

    Returns (R, [(t, t, 0, h_s, w_s, C_s)]): each level's row in the
    row-pass space, its canvas row and column (the same row; column 0),
    its size and column matrix."""
    from cascadeclassifier_tpu.ops.resize import _axis_tab

    R = np.zeros((plan.canvas_h, plan.img_h), np.float32)
    cols = []
    for s in range(len(plan.scales)):
        t = bt = int(plan.block_top[s])
        bl = 0
        h_s, w_s = int(plan.scaled_h[s]), int(plan.scaled_w[s])
        ys, cys = _axis_tab(plan.img_h, h_s)
        xs, cxs = _axis_tab(plan.img_w, w_s)
        rows = np.arange(t + 1, t + h_s + 1)
        np.add.at(R, (rows, ys), 256 - cys)
        np.add.at(R, (rows, np.minimum(ys + 1, plan.img_h - 1)), cys)
        C = np.zeros((plan.img_w, w_s), np.float32)
        np.add.at(C, (xs, np.arange(w_s)), 256 - cxs)
        np.add.at(C, (np.minimum(xs + 1, plan.img_w - 1), np.arange(w_s)), cxs)
        cols.append((t, bt, bl, h_s, w_s, jnp.asarray(C, jnp.bfloat16)))
    return jnp.asarray(R, jnp.bfloat16), cols


def _mm(a, b):
    return jax.lax.dot_general(
        a, b, (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )


def _build_canvas(img, tab, img_w: int, img_h: int, need_sq: bool,
                  need_tilted: bool = False, tilt_pad: int = 0,
                  resize_mats=None):
    """u8 frame → (sum int32, sq int32 | None, tilt int32 | None) canvas
    integrals.

    The resize runs as matmuls: H = R @ img blends rows (coeffs ≤ 256 and
    u8 pixels are bfloat16-exact; f32 accumulation exact up to 65280), then
    per-level column matmuls on H's 8-bit limbs recombine into the exact
    int32 fixed-point sum, and (v + 2^15) >> 16 rounds exactly as the
    per-pixel gather formulation did (bit-validated against
    INTER_LINEAR_EXACT).

    The integrals carry NO per-level top-row reset: every consumer (dense
    rect sums, the variance gates, the patchify + corner-incidence matmul
    tails) takes 4-corner differences whose corner rows all lie within
    one pyramid block, so the per-level row offset c[top] is a function
    of (row-block, column) that cancels identically under int32
    wrap-around. The classic ``c − c[top_of_row]`` pass (a canvas-sized
    read and write per integral) is therefore skipped entirely."""
    R, cols = resize_mats
    H = _mm(R, img.astype(jnp.bfloat16))  # (stack_h, img_w) ints ≤ 65280
    Hi = (H.astype(jnp.int32) >> 8).astype(jnp.bfloat16)
    Lo = (H.astype(jnp.int32) & 0xFF).astype(jnp.bfloat16)
    canvas_h = max(bt + h_s + 1 for (_t, bt, _bl, h_s, _w, _C) in cols)
    canvas_w = tab["sx0"].shape[1]
    px = jnp.zeros((canvas_h, canvas_w), jnp.int32)
    for (t, bt, bl, h_s, w_s, C) in cols:
        hi = jax.lax.slice(Hi, (t + 1, 0), (t + 1 + h_s, img_w))
        lo = jax.lax.slice(Lo, (t + 1, 0), (t + 1 + h_s, img_w))
        v = (
            jax.lax.shift_left(_mm(hi, C).astype(jnp.int32), jnp.int32(8))
            + _mm(lo, C).astype(jnp.int32)
        )
        lvl = jnp.minimum((v + (1 << 15)) >> 16, 255)
        px = jax.lax.dynamic_update_slice(px, lvl, (bt + 1, bl + 1))

    # inclusive 2D cumsum with int32 wrap-around (window rect sums fit
    # int32, so 4-corner differences recover true values exactly)
    sum2d = jnp.cumsum(
        jnp.cumsum(px, axis=1, dtype=jnp.int32), axis=0, dtype=jnp.int32,
    )
    sq2d = None
    if need_sq:
        sq = px * px
        sq2d = jnp.cumsum(
            jnp.cumsum(sq, axis=1, dtype=jnp.int32), axis=0,
            dtype=jnp.int32,
        )

    tilt2d = None
    if need_tilted:
        tilt2d = canvas_tilted(px, tab["is_top"], tilt_pad)
    return sum2d, sq2d, tilt2d


class TPUDetector:
    """detectMultiScale-compatible detector running each frame as a few
    chained device programs over all pyramid levels."""

    def __init__(self, model: CascadeModel, exact: bool = True,
                 engine: str = "auto"):
        """exact=True replicates the OpenCV runtime's float64 stage sums
        bit-for-bit; exact=False uses float32 (faster, same detections
        except knife-edge windows within ~1e-6 of a stage threshold).

        engine: 'fused' (the whole pipeline — canvas, gate, walk, dense
        front, survivor compaction, matmul tail, collection — as chained
        programs with no host round trip), 'xla' (dense slice programs
        at every stage; the plain reference), 'compact' (dense front +
        survivor compaction + matmul tail with host-adaptive
        triggering), or 'auto' (the platform's choice,
        detect/backend.py)."""
        self.model = model
        self.exact = exact
        self.packed = PackedCascade.from_model(model)
        self._compiled = {}
        # compaction: switch from dense to the gathered tail once the
        # survivor count drops to trigger_n, processed in batches of
        # compact_batch windows (fixed shapes to bound recompiles)
        self.trigger_n = 1 << 18
        self.compact_batch = 1 << 15
        all_stumps = all(st.deep_trees is None for st in self.packed.stages)
        can_stump_haar = (
            self.packed.feature_type == FEATURE_HAAR and all_stumps
        )
        can_fused = self.packed.feature_type in (FEATURE_HAAR, FEATURE_LBP)
        if engine == "auto":
            from cascadeclassifier_tpu.detect.backend import auto_engine

            self.engine = auto_engine(can_fused, can_stump_haar)
        else:
            if engine not in ("fused", "xla", "compact"):
                raise ValueError(f"unknown engine {engine!r}")
            if engine == "compact" and not can_stump_haar:
                raise ValueError(
                    "compact engine supports stump Haar cascades"
                )
            if engine == "fused" and not can_fused:
                raise ValueError(
                    "fused engine supports Haar/LBP cascades"
                )
            self.engine = engine
        self._fused = None
        if self.engine == "fused":
            from cascadeclassifier_tpu.detect.engine import FusedEngine

            self._fused = FusedEngine(self.packed, exact=exact)

    # -- program builders --------------------------------------------------
    #
    # The pipeline is split into small jitted programs (canvas+gate, stage
    # chunks, walk+collect) orchestrated from the host: one program with
    # every tree unrolled would keep many canvas-sized temporaries live at
    # 1080p, while chunked programs keep the live set to a few stages'
    # accumulator chains and bound each program's compile time.

    def _make_canvas_fn(self, plan: PyramidPlan):
        packed = self.packed
        is_haar = packed.feature_type == FEATURE_HAAR
        img_w, img_h = plan.img_w, plan.img_h
        out_h = plan.canvas_h - packed.win_h
        out_w = plan.canvas_w - packed.win_w

        need_tilted = packed.has_tilted
        tilt_pad = int(plan.scaled_h.max()) + 1
        resize_mats = _resize_matrices(plan)

        def canvas(img, tab):
            sum2d, sq2d, tilt2d = _build_canvas(
                img, tab, img_w, img_h, need_sq=is_haar,
                need_tilted=need_tilted, tilt_pad=tilt_pad,
                resize_mats=resize_mats,
            )
            if is_haar:
                gate, inv_nf = dense_variance_gate(
                    sum2d, sq2d, packed.win_w, packed.win_h, out_h, out_w
                )
            else:
                gate = jnp.ones((out_h, out_w), bool)
                inv_nf = jnp.zeros((out_h, out_w), jnp.float32)
            if tilt2d is None:
                tilt2d = sum2d
            return sum2d, tilt2d, gate, inv_nf

        return jax.jit(canvas)

    # Stages are grouped into chunks of ~CHUNK_TREES weak trees per jitted
    # program (see the note above).
    CHUNK_TREES = 150

    def _stage_chunks(self):
        chunks, cur, budget = [], [], 0
        for si in range(len(self.packed.stages)):
            cur.append(si)
            budget += self.packed.stages[si].ntrees
            if budget >= self.CHUNK_TREES:
                chunks.append(cur)
                cur, budget = [], 0
        if cur:
            chunks.append(cur)
        return chunks

    def _make_chunk_fn(self, plan: PyramidPlan, stage_ids):
        packed = self.packed
        is_haar = packed.feature_type == FEATURE_HAAR
        out_h = plan.canvas_h - packed.win_h
        out_w = plan.canvas_w - packed.win_w
        exact = self.exact

        def chunk(sum2d, tilt2d, inv_nf, alive):
            passed0 = None
            for si in stage_ids:
                st = packed.stages[si]
                if st.deep_trees is not None:
                    ssum = dense_stage_deep(
                        sum2d, tilt2d, st, out_h, out_w, inv_nf, is_haar,
                        exact=exact,
                    )
                elif is_haar:
                    ssum = dense_stage_haar(
                        sum2d, tilt2d, st, out_h, out_w, inv_nf, exact=exact
                    )
                else:
                    ssum = dense_stage_lbp(
                        sum2d, st, out_h, out_w, exact=exact
                    )
                if exact:
                    with jax.enable_x64(True):
                        passed = ssum >= jnp.float64(st.threshold)
                else:
                    passed = ssum >= jnp.float32(st.threshold)
                if si == 0:
                    passed0 = passed
                alive = alive & passed
                # force stage-sequential scheduling: without the barrier XLA
                # keeps many stages' canvas temps live at once and OOMs
                alive = jax.lax.optimization_barrier(alive)
            if passed0 is None:
                passed0 = alive
            return alive, passed0

        return jax.jit(chunk)

    def _make_collect_fn(self, plan: PyramidPlan, max_det: int):
        out_h = plan.canvas_h - self.packed.win_h

        def collect(alive, m0, tab):
            visited = dense_walk_visited(
                m0,
                tab["row_is_grid"][:out_h],
                tab["row_step2"][:out_h],
                tab["row_maxc"][:out_h],
            )
            flat = (alive & visited).reshape(-1)
            count = jnp.sum(flat)
            idx = jnp.nonzero(flat, size=max_det, fill_value=0)[0]
            ok = jnp.arange(max_det) < count
            return idx.astype(jnp.int32), ok, count

        return jax.jit(collect)

    def _get_fns(self, key, plan, max_det):
        if key not in self._compiled:
            chunks = self._stage_chunks()
            if self.engine == "compact":
                # per-stage dense fns / tail fns are built lazily per frame
                # content (survivor-count dependent) and cached in this dict
                stage_fns = ("compact", {})
            else:
                stage_fns = (
                    "xla",
                    [(ids, self._make_chunk_fn(plan, ids)) for ids in chunks],
                )
            self._compiled[key] = (
                self._make_canvas_fn(plan),
                stage_fns,
                self._make_collect_fn(plan, max_det),
                plan_tables(plan),
            )
        return self._compiled[key]

    # -- compact engine ----------------------------------------------------

    def _extract_patches(self, cache, sum2d, tilt2d, r, c):
        """Survivor patch extraction (vmapped dynamic_slice gather)."""
        from cascadeclassifier_tpu.detect.compact import make_patchify_fn

        packed = self.packed
        if "patchify" not in cache:
            cache["patchify"] = make_patchify_fn(
                packed.win_w, packed.win_h, packed.has_tilted
            )
        return cache["patchify"](sum2d, tilt2d, r, c)

    # tail start stages are quantized to these values so frames with
    # different survivor curves share compiled tail programs; the tail
    # re-evaluating an already-passed stage is redundant but harmless
    # (the same deterministic stage sum passes again)
    _TAIL_STARTS = (1, 2, 3, 4, 6, 8, 12, 16)

    def _run_compact(self, plan, cache, sum2d, tilt2d, gate, inv_nf):
        """Dense stages with host-side survivor counts, then the matmul
        tail (detect/compact.py) on the compacted survivor set."""
        from cascadeclassifier_tpu.detect.compact import (
            make_nonzero_fn,
            make_tail_fn,
        )

        packed = self.packed
        n_stages = len(packed.stages)
        out_w = plan.canvas_w - packed.win_w
        batch = self.compact_batch

        alive = gate
        m0 = None
        k = 0
        cnt = None
        while k < n_stages:
            cnt = int(jnp.sum(alive))
            if (k > 0 and cnt <= self.trigger_n) or cnt == 0:
                break
            if ("stage", k) not in cache:
                cache[("stage", k)] = self._make_chunk_fn(plan, [k])
            alive, passed0 = cache[("stage", k)](sum2d, tilt2d, inv_nf, alive)
            if k == 0:
                m0 = gate & (~passed0)
            k += 1

        if m0 is None:  # gate empty before stage 0 ever ran
            m0 = jnp.zeros_like(gate)
        if k >= n_stages or cnt == 0:
            return alive, m0

        kq = max(s for s in self._TAIL_STARTS if s <= k)
        if ("tail", kq) not in cache:
            cache[("tail", kq)] = make_tail_fn(packed, kq, self.exact)
        tail_fn = cache[("tail", kq)]

        nb = -(-cnt // batch)
        # quantize to powers of two: every distinct n compiles its own
        # nonzero/patchify/tail programs
        nb = 1 << (nb - 1).bit_length()
        n = nb * batch
        out_h = alive.shape[0]
        if ("nonzero", n) not in cache:
            cache[("nonzero", n)] = make_nonzero_fn(out_h, out_w, n)
        idx = cache[("nonzero", n)](alive)
        r = (idx // out_w).astype(jnp.int32)
        c = (idx % out_w).astype(jnp.int32)
        ps, pt = self._extract_patches(cache, sum2d, tilt2d, r, c)
        valid = jnp.arange(n) < cnt
        tail_alive = tail_fn(ps, pt, inv_nf.reshape(-1)[idx]) & valid
        # .max instead of .set: padded idx entries are 0 and must not
        # clobber a genuine survivor at flat index 0
        alive = (
            jnp.zeros(out_h * out_w, jnp.int8)
            .at[idx]
            .max(tail_alive.astype(jnp.int8))
            .reshape(alive.shape)
            != 0
        )
        return alive, m0

    # -- public API --------------------------------------------------------

    def detect_multi_scale(
        self,
        img: np.ndarray,
        scale_factor: float = 1.1,
        min_neighbors: int = 3,
        min_size=None,
        max_size=None,
        max_det: int = 1 << 16,
    ) -> np.ndarray:
        """Returns (N, 4) int32 rects (x, y, w, h) in original image coords,
        matching cv::CascadeClassifier::detectMultiScale semantics."""
        if self.engine == "fused":
            return self.detect_multi_scale_batch(
                [img], scale_factor, min_neighbors, min_size, max_size,
                max_det,
            )[0]
        plan, out = self._submit_one(
            img, scale_factor, min_size, max_size, max_det
        )
        return self._finish_one(
            plan, jax.device_get(out), max_det, min_neighbors
        )

    def _submit_one(self, img, scale_factor, min_size, max_size, max_det):
        """Non-fused engines: run one frame's program chain up to the
        collect program; returns (plan, device (idx, ok, count)) with no
        host sync (the compact engine syncs internally — host-adaptive)."""
        img = np.ascontiguousarray(img)
        assert img.ndim == 2 and img.dtype == np.uint8
        h, w = img.shape
        plan = build_plan(
            w,
            h,
            self.packed.win_w,
            self.packed.win_h,
            scale_factor,
            tuple(min_size) if min_size else None,
            tuple(max_size) if max_size else None,
        )
        key = (w, h, scale_factor, min_size and tuple(min_size),
               max_size and tuple(max_size), max_det, self.exact, self.engine)
        canvas_fn, stage_fns, collect_fn, tab = self._get_fns(key, plan, max_det)

        sum2d, tilt2d, gate, inv_nf = canvas_fn(jnp.asarray(img), tab)
        kind, chunks = stage_fns
        if kind == "compact":
            alive, m0 = self._run_compact(
                plan, chunks, sum2d, tilt2d, gate, inv_nf
            )
        else:
            alive = gate
            m0 = None
            for ids, cfn in chunks:
                alive, passed0 = cfn(sum2d, tilt2d, inv_nf, alive)
                if ids[0] == 0:
                    m0 = gate & (~passed0)
        return plan, collect_fn(alive, m0, tab)

    def _finish_one(self, plan, out_host, max_det, min_neighbors):
        idx, ok, count = out_host
        if int(count) > max_det:
            raise RuntimeError(
                f"{count} raw detections exceed max_det={max_det}; "
                "pass a larger max_det"
            )
        sel = idx[ok]
        rects = self._positions_to_rects(plan, sel)
        return clip_rects(
            group_rectangles(rects, min_neighbors), plan.img_w, plan.img_h
        )

    def detect_multi_scale_batch(
        self,
        frames,
        scale_factor: float = 1.1,
        min_neighbors: int = 3,
        min_size=None,
        max_size=None,
        max_det: int = 1 << 14,
        devices=None,
    ) -> list:
        """Detect over a list of same-geometry frames with one dispatch and
        one result fetch per frame, pipelined so the host↔device round trip
        amortizes across the batch (fused engine only). Returns a list of
        (N_i, 4) rect arrays.

        devices: optional list of jax devices — frames round-robin across
        them (data-parallel detection; identical per-frame results,
        ~linear throughput in chips)."""
        on_device = isinstance(frames, jnp.ndarray)
        if self.engine != "fused":
            if on_device:
                frames = list(np.asarray(frames))
            if self.engine == "compact":
                # host-adaptive: survivor counts steer the program chain,
                # so frames cannot be submitted ahead of their fetches
                return [
                    self.detect_multi_scale(
                        f, scale_factor, min_neighbors, min_size, max_size,
                        max_det=max(max_det, 1 << 16),
                    )
                    for f in frames
                ]
            # xla: submit a window of frames before fetching the oldest —
            # the chained per-frame programs overlap on device and the
            # per-frame fetch round trip amortizes
            md = max(max_det, 1 << 16)
            results, pend = [], []
            IN_FLIGHT = 4
            for f in frames:
                pend.append(
                    self._submit_one(f, scale_factor, min_size, max_size, md)
                )
                if len(pend) > IN_FLIGHT:
                    plan, out = pend.pop(0)
                    results.append(self._finish_one(
                        plan, jax.device_get(out), md, min_neighbors
                    ))
            for plan, out in pend:
                results.append(self._finish_one(
                    plan, jax.device_get(out), md, min_neighbors
                ))
            return results
        if on_device:
            # pre-staged device-resident stack (N, H, W) uint8: serving
            # pipelines keep frames in HBM; no host transfer in this path
            stack = frames
            n_frames, h, w = stack.shape
            assert stack.dtype == jnp.uint8
        else:
            frames = [np.ascontiguousarray(f) for f in frames]
            n_frames = len(frames)
            h, w = frames[0].shape
            for f in frames:
                assert f.shape == (h, w) and f.dtype == np.uint8
        plan = build_plan(
            w, h, self.packed.win_w, self.packed.win_h, scale_factor,
            tuple(min_size) if min_size else None,
            tuple(max_size) if max_size else None,
        )
        tkey = ("tab", plan.canvas_h, plan.canvas_w)
        if tkey not in self._compiled:
            self._compiled[tkey] = plan_tables(plan)
        tab = self._compiled[tkey]
        if not on_device:
            # ship the whole batch as ONE host→device transfer; frames are
            # then device-side slices
            stack = jnp.asarray(np.stack(frames))
        # multi-chip data parallelism (new capability vs the single-
        # process reference, SURVEY §2.6): frames round-robin across the
        # device list; the single-controller runtime keeps every chip's
        # dispatch queue full concurrently and jit auto-specializes the
        # per-frame programs per device. Near-linear throughput in
        # devices — per-frame latency is unchanged.
        if devices is not None and len(devices) > 1:
            frames_dev = [
                jax.device_put(stack[i], devices[i % len(devices)])
                for i in range(n_frames)
            ]
        else:
            frames_dev = [stack[i] for i in range(n_frames)]
        # Single-device batches go through the vmapped head programs in
        # groups of BATCH_F frames when BATCH_F > 1 (one dispatch runs F
        # canvases/fronts)
        BF = self._fused.BATCH_F
        # pack PACK frames into ONE device array and fetch it with a
        # single host round trip instead of one fetch per frame and array
        def _pack(outs_flat):
            rows = [
                jnp.concatenate([
                    fidx.astype(jnp.int32),
                    jnp.stack([
                        fcnt.astype(jnp.int32),
                        cnt.astype(jnp.int32),
                        oflow.astype(jnp.int32),
                    ]),
                ])
                for (fidx, fcnt, cnt, oflow) in outs_flat
            ]
            return jnp.stack(rows)

        # pack in fixed-size chunks so the pack program compiles once per
        # chunk size (a len(outs)-sized program would recompile for every
        # new batch size)
        PACK = 16
        ndev = len(devices) if devices is not None and len(devices) > 1 else 1

        def _pack_chunk(chunk):
            pkey = ("pack", max_det, len(chunk))
            if pkey not in self._compiled:
                self._compiled[pkey] = jax.jit(_pack)
            return self._compiled[pkey](chunk)

        if ndev > 1:
            # multi-chip: submit every frame before fetching — each
            # device's queue is only n/ndev deep; chunk within each
            # device's frame group (a cross-device concat would force
            # implicit transfers mid-pipeline)
            outs = [
                self._fused.detect_async(plan, tab, f, max_det)
                for f in frames_dev
            ]
            order, packed_chunks = [], []
            for d in range(ndev):
                didx = list(range(d, n_frames, ndev))
                for o0 in range(0, len(didx), PACK):
                    sel = didx[o0 : o0 + PACK]
                    order.extend(sel)
                    packed_chunks.append(
                        _pack_chunk([outs[i] for i in sel])
                    )
            packed_host = np.concatenate(
                [np.asarray(p) for p in packed_chunks]
            )
            host = np.empty_like(packed_host)
            host[np.asarray(order)] = packed_host
        else:
            # single chip: WINDOWED submission — keep at most IN_FLIGHT
            # packed chunks (and their enqueued frame programs)
            # outstanding before fetching the oldest. Unbounded
            # submission holds every enqueued frame's canvas-sized
            # buffers at once; per-chunk fetches overlap the next chunk's
            # device work.
            IN_FLIGHT = 2

            def frame_outs():
                i = 0
                while BF > 1 and i + BF <= n_frames:
                    yield from self._fused.detect_async_batch(
                        plan, tab, stack[i : i + BF], max_det
                    )
                    i += BF
                for j in range(i, n_frames):
                    yield self._fused.detect_async(
                        plan, tab, frames_dev[j], max_det
                    )

            host_parts, pend, chunk = [], [], []
            for o in frame_outs():
                chunk.append(o)
                if len(chunk) == PACK:
                    pend.append(_pack_chunk(chunk))
                    chunk = []
                    while len(pend) > IN_FLIGHT:
                        host_parts.append(np.asarray(pend.pop(0)))
            if chunk:
                pend.append(_pack_chunk(chunk))
            host_parts.extend(np.asarray(p) for p in pend)
            host = np.concatenate(host_parts)
        results = []
        for i in range(n_frames):
            fidx = host[i, :max_det]
            fcnt = int(host[i, max_det])
            cnt = int(host[i, max_det + 1])
            oflow = bool(host[i, max_det + 2])
            try:
                if oflow:
                    raise OverflowError(
                        f"{cnt} front survivors exceeded static tail "
                        "capacity"
                    )
                if fcnt > max_det:
                    raise RuntimeError(
                        f"{fcnt} raw detections exceed max_det={max_det}"
                    )
                sel = fidx[:fcnt]
            except OverflowError:
                # rare: front survivors exceeded the static tail capacity;
                # re-run this frame through the host-adaptive engine
                # (compact is stump-Haar-only — LBP cascades served by the
                # fused engine fall back to the dense XLA path)
                if not hasattr(self, "_fallback") or self._fallback is None:
                    fb = (
                        "compact"
                        if self.packed.feature_type == FEATURE_HAAR
                        else "xla"
                    )
                    self._fallback = TPUDetector(
                        self.model, exact=self.exact, engine=fb
                    )
                f = np.asarray(stack[i]) if on_device else frames[i]
                results.append(
                    self._fallback.detect_multi_scale(
                        f, scale_factor, min_neighbors, min_size, max_size,
                        max_det=1 << 16,
                    )
                )
                continue
            rects = self._positions_to_rects(plan, sel)
            results.append(
                clip_rects(
                    group_rectangles(rects, min_neighbors),
                    plan.img_w,
                    plan.img_h,
                )
            )
        return results

    def _positions_to_rects(self, plan: PyramidPlan, sel: np.ndarray):
        """Map flat dense-grid indices (r·out_w + c) to image-space rects."""
        if sel.size == 0:
            return np.zeros((0, 4), np.int32)
        out_w = plan.canvas_w - plan.win_w
        r = sel // out_w
        c = sel % out_w
        s = plan.row_scale[r]
        assert (s >= 0).all()
        y = r - plan.block_top[s]
        # the OpenCV invoker maps window coords with FLOAT32 arithmetic:
        # cvRound(x*scalingFactor) where scalingFactor is ScaleData::scale
        # (a float) — e.g. 50·1.21f is exactly 60.5f and rounds to even 60,
        # while the f64 product 60.500000000000014 rounds to 61
        f = plan.scales[s].astype(np.float32)
        x_img = np.rint(c.astype(np.float32) * f).astype(np.int32)
        y_img = np.rint(y.astype(np.float32) * f).astype(np.int32)
        # UNCLIPPED: candidates at the coarsest level can overhang the
        # image by a pixel (cvRound(pos·scale)); OpenCV groups the
        # unclipped list and clips only the grouped output (clipObjects
        # runs after groupRectangles) — clip_rects applies at the call
        # sites, after grouping
        return np.stack(
            [x_img, y_img, plan.box_w[s], plan.box_h[s]], axis=1
        )
