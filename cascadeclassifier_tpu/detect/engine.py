"""Fused detection engine: the whole pipeline with no host round trip.

The compact engine (detect/detector.py::_run_compact) is orchestrated from
the host: one program per dense stage plus a survivor-count fetch between
stages. This engine chains a fixed set of programs per frame geometry and
never reads a count back until the frame's result:

  canvas (matmul resize + integrals)
  → variance gate ∧ static visit grid (the ystep/row-bound superset of
    windows the OpenCV walk can ever visit)
  → dense stage 0 → closed-form visited mask (the serial x-walk
    skip-after-reject recurrence solved with prefix ops, see
    parity_visited) → dense front stages 1..K-1 (XLA shifted slices)
  → fixed-size survivor extraction → patch gather → limb-matmul tail over
    stages K.. → fixed-size detection extraction

Survivor and detection counts are bounded by static shapes (tail_n /
max_det) with device-computed overflow flags — the host re-runs the rare
overflow frame through the adaptive compact engine instead of paying a
mid-pipeline sync on every frame.

Replaces cv::CascadeClassifier::detectMultiScale (reference
tools/detection/Cpp/main.cpp:42-49); byte-parity with the C++ runtime is
asserted by tests/test_detector.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from cascadeclassifier_tpu.detect.compact import (
    _nonzero_1d,
    make_lbp_tail_compact_fn,
    make_nonzero_fn,
    make_patchify_fn,
    make_tail_compact_fn,
)
from cascadeclassifier_tpu.detect.dense import (
    dense_stage_deep,
    dense_stage_haar,
    dense_stage_lbp,
    dense_variance_gate,
)


def static_visit_grid(plan) -> np.ndarray:
    """(out_h, out_w) bool — the superset of window positions the OpenCV
    x-walk can visit: grid rows (ystep-aware), columns within the level
    bound, even columns where ystep == 2 (dense_walk_visited's `on`)."""
    out_h = plan.canvas_h - plan.win_h
    out_w = plan.canvas_w - plan.win_w
    cols = np.arange(out_w)
    on = (
        plan.row_is_grid[:out_h, None]
        & (cols[None, :] <= plan.row_maxc[:out_h, None])
        & (~plan.row_step2[:out_h, None] | ((cols[None, :] & 1) == 0))
    )
    return on


def parity_visited(m0, on, ordinal=None):
    """Closed-form dense_walk_visited (detect/dense.py).

    Per row, over its sequence of `on` columns c_1 < c_2 < …, the walk
    recurrence is v_k = ¬(v_{k−1} ∧ m0[c_{k−1}]), v_1 = True: inside a
    run of consecutive skip-triggering columns v alternates, and any
    non-triggering column resets it. Hence
        v_k = even(k − lastFalse_k − 1)
    with lastFalse_k the ordinal of the last on-column before k where the
    skip trigger (m0) was False. Both terms are prefix ops along the
    column axis — fully parallel, unlike the 1900-step lax.scan.

    ordinal: optional precomputed inclusive cumsum of `on`."""
    if ordinal is None:
        ordinal = jnp.cumsum(jnp.asarray(on).astype(jnp.int32), axis=1)
    marker = jnp.where(on & (~m0), ordinal, 0)
    # exclusive prefix max over columns (log-step scan)
    lastf = jax.lax.associative_scan(jnp.maximum, marker, axis=1)
    lastf = jnp.concatenate(
        [jnp.zeros((marker.shape[0], 1), marker.dtype), lastf[:, :-1]],
        axis=1,
    )
    return on & (((ordinal - lastf - 1) & 1) == 0)


class FusedEngine:
    """Builds the chained per-(plan, params) programs running the entire
    multiscale detection for Haar and LBP cascades (tilted and deep-tree
    included; deep cascades run every stage dense).

    n_front: number of stages evaluated densely before survivor
    compaction. tail_n: static survivor capacity of the matmul tail (the
    program reports overflow instead of dropping windows)."""

    # Trees per XLA dense-front program: bounds each program's size (and
    # so its compile time and live set of canvas-sized temporaries).
    FRONT_CHUNK = 80
    # frames per vmapped head dispatch (batch_program); 1 = per frame
    BATCH_F = 1

    def __init__(self, packed, exact: bool = False, n_front: int = 6,
                 tail_n: int = 1 << 17):
        from cascadeclassifier_tpu.models.model import (
            FEATURE_HAAR,
            FEATURE_LBP,
        )

        if packed.feature_type not in (FEATURE_HAAR, FEATURE_LBP):
            raise ValueError("fused engine supports Haar/LBP cascades")
        self.is_haar = packed.feature_type == FEATURE_HAAR
        self.packed = packed
        self.exact = exact
        self.n_front = min(n_front, len(packed.stages))
        self.tail_n = tail_n
        self._programs = {}

    def program(self, plan, max_det: int):
        key = (plan.canvas_h, plan.canvas_w, max_det)
        if key not in self._programs:
            progs, fronts, tail, (R, Cs) = self._build(plan, max_det)
            # resident on device once: numpy jit arguments would be
            # re-transferred on every frame
            consts = (jnp.asarray(R), [jnp.asarray(c) for c in Cs])
            self._programs[key] = (progs, fronts, tail, consts)
        return self._programs[key]

    def _build(self, plan, max_det: int):
        from cascadeclassifier_tpu.detect.detector import (
            _build_canvas,
            _resize_matrices,
        )

        packed = self.packed
        exact = self.exact
        out_h = plan.canvas_h - packed.win_h
        out_w = plan.canvas_w - packed.win_w
        img_w, img_h = plan.img_w, plan.img_h
        # resize matrices ride as ARGUMENTS (device_put once) rather than
        # literals baked into every program
        R_c, cols_c = _resize_matrices(plan)
        col_meta = tuple(
            (t, bt, bl, h, w) for (t, bt, bl, h, w, _c) in cols_c
        )
        consts = (R_c, [c for (*_m, c) in cols_c])
        n_stages = len(packed.stages)

        is_haar = self.is_haar
        tilted = is_haar and packed.has_tilted
        deep_any = any(st.deep_trees is not None for st in packed.stages)
        # survivors only ever sit on ystep grid rows — the per-row sorts
        # inside nonzero run on the compressed row set (~half the canvas)
        grid_rows = np.nonzero(plan.row_is_grid[:out_h])[0].astype(np.int32)
        # the matmul tail packs stumps only — deep-tree cascades run every
        # stage in the dense front (still zero host syncs)
        n_dense = n_stages if deep_any else self.n_front
        self.n_dense = n_dense
        tail_n = max(
            32,
            min(self.tail_n,
                1 << int(np.ceil(np.log2(max(out_h * out_w, 2))))),
        )
        nonzero_tail = nonzero_det = tail_fn = xpatch = None
        if n_dense < n_stages:
            nonzero_tail = make_nonzero_fn(out_h, out_w, tail_n, grid_rows)
            if is_haar:
                tail_fn = make_tail_compact_fn(packed, n_dense, exact, tail_n)
            else:
                tail_fn = make_lbp_tail_compact_fn(
                    packed, n_dense, exact, tail_n
                )
            xpatch = make_patchify_fn(packed.win_w, packed.win_h, tilted)
        else:
            nonzero_det = make_nonzero_fn(out_h, out_w, max_det, grid_rows)

        def stage_pass(sum2d, tilt2d, inv_nf, si):
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
                ssum = dense_stage_lbp(sum2d, st, out_h, out_w, exact=exact)
            if exact:
                with jax.enable_x64(True):
                    return ssum >= jnp.float64(st.threshold)
            return ssum >= jnp.float32(st.threshold)

        # canvas and prep are two programs so that the benchmark can time
        # each phase (bench_parts.py)
        def canvas(img, tab, R, Cs):
            resize_mats = (
                R, [(*m, c) for m, c in zip(col_meta, Cs)]
            )
            sum2d, sq2d, tilt2d = _build_canvas(
                img, tab, img_w, img_h, need_sq=is_haar,
                need_tilted=tilted, resize_mats=resize_mats,
            )
            if sq2d is None:
                sq2d = sum2d
            if tilt2d is None:
                # placeholder so the chained-program signatures stay
                # uniform; no stage reads it in untilted cascades
                tilt2d = sum2d
            return sum2d, sq2d, tilt2d

        def prep(sum2d, sq2d, tilt2d, tab):
            """Gate + stage 0 + the serial-walk visited mask."""
            if is_haar:
                gate, inv_nf = dense_variance_gate(
                    sum2d, sq2d, packed.win_w, packed.win_h, out_h, out_w
                )
            else:
                gate = jnp.ones((out_h, out_w), bool)
                inv_nf = jnp.zeros((out_h, out_w), jnp.float32)
            # visit grid + ordinal generated on device from tab's small
            # per-row vectors (a canvas-sized grid literal and its cumsum
            # constant otherwise dominate compile time)
            cols = jax.lax.broadcasted_iota(jnp.int32, (out_h, out_w), 1)
            grid = (
                tab["row_is_grid"][:out_h, None]
                & (cols <= tab["row_maxc"][:out_h, None])
                & (
                    (~tab["row_step2"][:out_h, None])
                    | ((cols & 1) == 0)
                )
            )
            ordinal = jnp.cumsum(grid.astype(jnp.int32), axis=1)
            passed0 = stage_pass(sum2d, tilt2d, inv_nf, 0)
            m0 = gate & (~passed0)
            visited = parity_visited(m0, grid, ordinal)
            alive = gate & grid & passed0 & visited
            return inv_nf, alive

        # dense front chunks of ≤ FRONT_CHUNK trees
        chunks, cur, budget = [], [], 0
        for si in range(1, n_dense):
            cur.append(si)
            budget += packed.stages[si].ntrees
            if budget >= self.FRONT_CHUNK:
                chunks.append(cur)
                cur, budget = [], 0
        if cur:
            chunks.append(cur)

        def make_front(stage_ids):
            def front(sum2d, tilt2d, inv_nf, alive):
                for si in stage_ids:
                    alive = alive & stage_pass(sum2d, tilt2d, inv_nf, si)
                    alive = jax.lax.optimization_barrier(alive)
                return alive

            return front

        fronts = [jax.jit(make_front(ids)) for ids in chunks]

        def compact_collect(sum2d, tilt2d, inv_nf, alive):
            """Survivor extraction, re-compacting matmul tail, collection."""
            cnt = jnp.sum(alive, dtype=jnp.int32)
            if n_dense >= n_stages:
                fidx = nonzero_det(alive)
                return fidx, cnt, cnt, cnt > tail_n
            idx = nonzero_tail(alive)
            r = (idx // out_w).astype(jnp.int32)
            c = (idx % out_w).astype(jnp.int32)
            oflow = cnt > tail_n
            ps, pt = xpatch(sum2d, tilt2d, r, c)
            widx, t_alive, t_oflow = tail_fn(
                ps, pt, inv_nf.reshape(-1)[idx], cnt
            )
            oflow = oflow | t_oflow
            # final detections come straight from the tail's survivor
            # slots; the only compaction left is a 1-D sort over the
            # final batch
            fcnt = jnp.sum(t_alive, dtype=jnp.int32)
            k = min(max_det, int(t_alive.shape[0]))
            sel = _nonzero_1d(t_alive.astype(jnp.int32), k)
            fidx = idx[widx[sel]]
            if k < max_det:
                fidx = jnp.pad(fidx, (0, max_det - k))
            fidx = jnp.where(
                jnp.arange(max_det, dtype=jnp.int32) < fcnt, fidx, 0
            )
            return fidx, fcnt, cnt, oflow

        return (
            (jax.jit(canvas), jax.jit(prep)),
            fronts,
            jax.jit(compact_collect),
            consts,
        )

    def batch_program(self, plan, max_det: int, F: int):
        """Vmapped-over-F variants of the head programs (canvas → front);
        the survivor tail stays per frame."""
        key = (plan.canvas_h, plan.canvas_w, max_det, "batch", F)
        if key not in self._programs:
            (canvas, prep), fronts, tail, consts = self.program(
                plan, max_det
            )

            def vm(f, ax):
                return jax.jit(jax.vmap(f, in_axes=ax))

            self._programs[key] = (
                (vm(canvas, (0, None, None, None)), vm(prep, (0, 0, 0, None))),
                [vm(f, (0, 0, 0, 0)) for f in fronts],
                tail,
                consts,
            )
        return self._programs[key]

    def detect_async_batch(self, plan, tab, imgs, max_det: int):
        """Submit F same-geometry frames ((F, H, W) device/host uint8)
        through the vmapped head programs; returns F per-frame device
        tuples (fidx, fcnt, tail_cnt, overflow)."""
        F = int(imgs.shape[0])
        (canvas, prep), fronts_b, tail, (R, Cs) = self.batch_program(
            plan, max_det, F
        )
        sum_b, sq_b, tilt_b = canvas(jnp.asarray(imgs), tab, R, Cs)
        inv_nf, alive_b = prep(sum_b, sq_b, tilt_b, tab)
        for f in fronts_b:
            alive_b = f(sum_b, tilt_b, inv_nf, alive_b)
        return [
            tail(sum_b[i], tilt_b[i], inv_nf[i], alive_b[i])
            for i in range(F)
        ]

    # -- host-side driver ---------------------------------------------------

    def detect_async(self, plan, tab, img, max_det: int):
        """Submit one frame (a few chained async dispatches, no syncs);
        returns device arrays (fidx, fcnt, tail_cnt, overflow)."""
        (canvas, prep), fronts, tail, (R, Cs) = self.program(plan, max_det)
        sum2d, sq2d, tilt2d = canvas(jnp.asarray(img), tab, R, Cs)
        inv_nf, alive = prep(sum2d, sq2d, tilt2d, tab)
        for f in fronts:
            alive = f(sum2d, tilt2d, inv_nf, alive)
        return tail(sum2d, tilt2d, inv_nf, alive)

    def finish(self, out, max_det: int):
        """(fidx, fcnt, tail_cnt, overflow) device tuple → flat window
        indices.

        Raises OverflowError when any static capacity (tail entry or a
        re-compaction step) was exceeded (caller should fall back to the
        adaptive compact engine)."""
        fidx, fcnt, cnt, oflow = (np.asarray(x) for x in out)
        if bool(oflow):
            raise OverflowError(
                f"a static capacity was exceeded: front survivors "
                f"({int(cnt)}) vs tail_n={self.tail_n}, a tail "
                f"re-compaction step, or raw detections vs max_det"
            )
        if int(fcnt) > max_det:
            raise RuntimeError(
                f"{int(fcnt)} raw detections exceed max_det={max_det}"
            )
        return fidx[: int(fcnt)]
