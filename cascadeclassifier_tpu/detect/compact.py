"""Survivor-compaction tail for the detector.

The dense engines evaluate every stage at every window position; on content
where the cascade rejects slowly that costs ~1.4 ms per weak tree at 1080p
regardless of how few windows remain alive. This module implements the
compaction strategy: once the dense front has thinned the survivor set,
the remaining windows are gathered into a compact batch and every remaining
stage is evaluated on just those windows.

Replaces the reference's per-window early-exit loop
(lib/src/cascadeclassifier.cpp predictOrderedStump / CascadeClassifierInvoker)
with three phases:

  1. dense stages 0..K-1 (detect/dense.py) with a host-side survivor count
     after each stage; K is chosen adaptively (first stage whose survivor
     count fits the compaction budget)
  2. patch extraction: each survivor's (win_h+1, win_w+1) integral patch is
     gathered into a (N, P) batch (vmap'd dynamic_slice)
  3. a matmul tail: per-rect corner-incidence matrices evaluate all
     remaining trees as matmuls. Raw int32 canvas values exceed float32's
     exact-int range, so patches are split into four 8-bit limbs — each
     limb matmul runs in bf16 with float32 accumulation (products are
     ±1 × [0,255], sums of ≤12 corners: all exact) and the limb results
     recombine into exact int32 rect sums with wrap-safe shifts, matching
     the dense engines' integer arithmetic bit-for-bit. Tilted rects use a
     second patch tensor from the tilted canvas.

Stage semantics match dense_stage_haar exactly: raw = Σ w_r·f32(rect_r) in
rect order, val = raw·inv_nf in f32, leaf by val < f32(node_thr), stage sum
accumulated in f64 (exact mode) or f32, passed = sum ≥ effective threshold.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from cascadeclassifier_tpu.ops.features import lbp_code_grid


def _pack_tail(stages, stage_ids, win_w, win_h):
    """Corner-incidence matrices + per-tree params for the matmul tail
    (patches flattened row-major with row stride win_w + 1)."""
    stride = win_w + 1
    P = (win_h + 1) * stride
    trees = []
    any_tilt = False
    for si in stage_ids:
        st = stages[si]
        for t in range(st.ntrees):
            trees.append((st, t))
            any_tilt |= bool(st.tilted[t])
    T = len(trees)
    a_sum = np.zeros((3 * T, P), np.float32)
    a_tilt = np.zeros((3 * T, P), np.float32) if any_tilt else None
    wts = np.zeros((T, 3), np.float32)
    thr = np.zeros(T, np.float32)
    ll = np.zeros(T, np.float32)
    rr = np.zeros(T, np.float32)
    for i, (st, t) in enumerate(trees):
        thr[i] = float(st.thr[t])
        ll[i] = float(st.left_leaf[t])
        rr[i] = float(st.right_leaf[t])
        tilted = bool(st.tilted[t])
        for r in range(3):
            w_t = float(st.weights[t, r])
            if w_t == 0.0:
                continue
            wts[i, r] = w_t
            x, y, w, h = (int(v) for v in st.feat_rects[t, r])
            row = 3 * i + r
            if tilted:
                # lib/src/haarfeatures.cpp tilted corner layout
                for (cy, cx, s) in (
                    (y, x, 1),
                    (y + h, x - h, -1),
                    (y + w, x + w, -1),
                    (y + w + h, x + w - h, 1),
                ):
                    a_tilt[row, cy * stride + cx] += s
            else:
                for (cy, cx, s) in (
                    (y, x, 1),
                    (y, x + w, -1),
                    (y + h, x, -1),
                    (y + h, x + w, 1),
                ):
                    a_sum[row, cy * stride + cx] += s
    bounds = [0]
    sthr = []
    for si in stage_ids:
        bounds.append(bounds[-1] + stages[si].ntrees)
        sthr.append(float(stages[si].threshold))
    return a_sum, a_tilt, wts, (thr, ll, rr), bounds, sthr


def _exact_int_matmul(a_bf16, patches):
    """Exact int32 (R, N) = a @ patches.T for ±1 a and int32 patches.

    Four 8-bit limb matmuls in bf16 (f32 accumulate): every product and
    partial sum is exact; the wrap-safe int32 recombination equals the
    true rect sum (which always fits int32)."""
    acc = None
    for l in range(4):
        limb = ((patches >> (8 * l)) & 0xFF).astype(jnp.bfloat16)  # (N, P)
        part = jax.lax.dot_general(
            a_bf16,
            limb,
            (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
        ).astype(jnp.int32)
        part = jax.lax.shift_left(part, jnp.int32(8 * l))
        acc = part if acc is None else acc + part
    return acc


def _limbs_rel(ps):
    """Hoisted 3-limb bf16 planes of (ps − ps[:, :1]).

    The per-stage matmuls previously re-derived (shift, mask,
    bf16-convert) the limbs from the i32 patches on EVERY tail stage —
    ~n·P·4B of HBM reads per limb per stage. The limb planes are
    stage-invariant, so the re-compacting tails extract them once per
    capacity level and gather the (half-sized) bf16 planes at each
    shrink."""
    rel = ps - ps[:, :1]
    return tuple(
        ((rel >> (8 * l)) & 0xFF).astype(jnp.bfloat16) for l in range(3)
    )


def _limbs_abs(p):
    """Hoisted 4-limb bf16 planes of absolute i32 patches."""
    return tuple(
        ((p >> (8 * l)) & 0xFF).astype(jnp.bfloat16) for l in range(4)
    )


def _matmul_limbs(a_bf16, limbs):
    """Exact int32 (R, N) = a @ patches.T over precomputed limb planes —
    same arithmetic (and exactness proofs) as _exact_int_matmul for
    4-limb absolute planes. 3-limb relative planes hold
    (patches − patches[:, :1]): rows of `a` sum to zero (every rect/cell
    row does), so subtracting each window's corner leaves the result
    unchanged, and a true result in (−2^23, 2^23) is recovered exactly
    from its value mod 2^24 by sign extension from bit 23 — rect/cell
    sums are in [0, 255·win²), far inside."""
    acc = None
    for l, limb in enumerate(limbs):
        part = jax.lax.dot_general(
            a_bf16, limb, (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
        ).astype(jnp.int32)
        part = jax.lax.shift_left(part, jnp.int32(8 * l))
        acc = part if acc is None else acc + part
    if len(limbs) == 3:  # relative 3-limb: sign-extend from bit 23
        acc = jax.lax.shift_right_arithmetic(
            jax.lax.shift_left(acc, jnp.int32(8)), jnp.int32(8)
        )
    return acc


def make_tail_fn(packed, start_stage, exact):
    """fn(patch_sum (N,P) i32, patch_tilt, inv (N,) f32) -> alive (N,) bool

    Evaluates stages start_stage.. on compacted windows. N is whatever
    batch size the caller jits with (keep it fixed to avoid recompiles).
    """
    stage_ids = list(range(start_stage, len(packed.stages)))
    per_stage = []
    for si in stage_ids:
        a_sum, a_tilt, wts, (thr, ll, rr), _, sthr = _pack_tail(
            packed.stages, [si], packed.win_w, packed.win_h
        )
        per_stage.append((
            jnp.asarray(a_sum, jnp.bfloat16),
            None if a_tilt is None else jnp.asarray(a_tilt, jnp.bfloat16),
            jnp.asarray(wts),
            jnp.asarray(thr),
            jnp.asarray(ll),
            jnp.asarray(rr),
            sthr[0],
        ))

    def tail(patch_sum, patch_tilt, inv):
        acc_dt = jnp.float64 if exact else jnp.float32
        # stage-by-stage so the live set stays ~(3·t_k, N) instead of the
        # whole cascade's (3T, N); dead windows keep being evaluated (they
        # are already masked out by `alive`) — survivors are so few past
        # the dense front that the matmuls, not the windows, dominate
        alive = jnp.ones(patch_sum.shape[0], bool)
        for (a_j, at_j, w_j, thr_j, ll_j, rr_j, sthr_k) in per_stage:
            rs = _exact_int_matmul(a_j, patch_sum)  # (3·t_k, N)
            if at_j is not None:
                rs = rs + _exact_int_matmul(at_j, patch_tilt)
            t_k = w_j.shape[0]
            rs = rs.reshape(t_k, 3, -1).astype(jnp.float32)
            # rect-ordered f32 accumulation, matching dense_stage_haar
            raw = rs[:, 0] * w_j[:, 0:1]
            raw = raw + rs[:, 1] * w_j[:, 1:2]
            raw = raw + rs[:, 2] * w_j[:, 2:3]
            val = raw * inv[None, :]
            leaf = jnp.where(
                val < thr_j[:, None], ll_j[:, None].astype(acc_dt),
                rr_j[:, None].astype(acc_dt),
            )
            ssum = jnp.sum(leaf, axis=0)
            alive = alive & (ssum >= acc_dt(sthr_k))
        return alive

    if exact:
        def tail_x64(patch_sum, patch_tilt, inv):
            with jax.enable_x64(True):
                return tail(patch_sum, patch_tilt, inv)

        return jax.jit(tail_x64)
    return jax.jit(tail)


def _pack_lbp_tail(stages, stage_ids, win_w, win_h):
    """Cell-corner incidence matrix + per-tree params for the LBP tail.

    Each stump reads 9 cell sums of its 3×3 grid (lbpfeatures.h:70-83);
    rows 9t..9t+8 of the returned (9T, P) matrix are the ±1 corner
    incidences of tree t's cells in row-major cell order."""
    stride = win_w + 1
    P = (win_h + 1) * stride
    trees = []
    for si in stage_ids:
        st = stages[si]
        for t in range(st.ntrees):
            trees.append((st, t))
    T = len(trees)
    a = np.zeros((9 * T, P), np.float32)
    subs = np.zeros((T, 8), np.int32)
    ll = np.zeros(T, np.float32)
    rr = np.zeros(T, np.float32)
    for i, (st, t) in enumerate(trees):
        x, y, w, h = (int(v) for v in st.lbp_rects[t])
        subs[i] = st.subsets[t]
        ll[i] = float(st.left_leaf[t])
        rr[i] = float(st.right_leaf[t])
        for ci, (cy, cx) in enumerate(
            (y + r * h, x + c * w) for r in range(3) for c in range(3)
        ):
            row = 9 * i + ci
            for (dy, dx, s) in (
                (0, 0, 1), (0, w, -1), (h, 0, -1), (h, w, 1),
            ):
                a[row, (cy + dy) * stride + (cx + dx)] += s
    bounds = [0]
    sthr = []
    for si in stage_ids:
        bounds.append(bounds[-1] + stages[si].ntrees)
        sthr.append(float(stages[si].threshold))
    return a, subs, ll, rr, bounds, sthr


def make_lbp_tail_compact_fn(packed, start_stage, exact, n0,
                             shrink_every: int = 2, n_floor: int = 4096):
    """Re-compacting matmul tail for LBP stump cascades: cell sums via the
    limb matmul, LBP codes via the 8 comparisons, categorical stumps via
    predicated subset-word selects (no gathers). Same contract as
    make_tail_compact_fn; `inv`/`pt` are accepted and ignored so the
    engines can treat the two tails uniformly."""
    stage_ids = list(range(start_stage, len(packed.stages)))
    per_stage = []
    for si in stage_ids:
        a, subs, ll, rr, _, sthr = _pack_lbp_tail(
            packed.stages, [si], packed.win_w, packed.win_h
        )
        per_stage.append((
            jnp.asarray(a, jnp.bfloat16),
            jnp.asarray(subs),
            jnp.asarray(ll),
            jnp.asarray(rr),
            sthr[0],
        ))

    def tail(ps, pt, inv, cnt):
        del pt, inv
        acc_dt = jnp.float64 if exact else jnp.float32
        n = n0
        alive = jnp.arange(n) < cnt
        widx = jnp.arange(n, dtype=jnp.int32)
        overflow = jnp.zeros((), bool)
        limbs = _limbs_rel(ps)
        for k, (a_j, subs_j, ll_j, rr_j, sthr_k) in enumerate(per_stage):
            cs = _matmul_limbs(a_j, limbs)  # (9T, N)
            t_k = subs_j.shape[0]
            cs = cs.reshape(t_k, 3, 3, -1)
            code = lbp_code_grid(
                [[cs[:, r, c] for c in range(3)] for r in range(3)]
            )
            word = jnp.zeros_like(code)
            wsel = code >> 5
            for wi in range(8):
                word = jnp.where(wsel == wi, subs_j[:, wi : wi + 1], word)
            bit = (word >> (code & 31)) & 1
            leaf = jnp.where(
                bit != 0, ll_j[:, None].astype(acc_dt),
                rr_j[:, None].astype(acc_dt),
            )
            ssum = jnp.sum(leaf, axis=0)
            alive = alive & (ssum >= acc_dt(sthr_k))
            last = k == len(per_stage) - 1
            if not last and (k + 1) % shrink_every == 0 and n // 2 >= n_floor:
                na = n // 2
                ai = alive.astype(jnp.int32)
                live = jnp.sum(ai)
                overflow = overflow | (live > na)
                idx2 = _nonzero_1d(ai, na)
                limbs = tuple(lb[idx2] for lb in limbs)
                widx = widx[idx2]
                alive = jnp.arange(na) < jnp.minimum(live, na)
                n = na
        return widx, alive, overflow

    if exact:
        def tail_x64(ps, pt, inv, cnt):
            with jax.enable_x64(True):
                return tail(ps, pt, inv, cnt)

        return jax.jit(tail_x64)
    return jax.jit(tail)


def _nonzero_1d(alive_i32, n_out):
    """First n_out set positions of a 1-D mask (ascending, clamped).

    Sort-based: `index if alive else N` sorted ascending left-packs the
    survivor positions."""
    n = alive_i32.shape[0]
    keys = jnp.where(
        alive_i32 != 0, jnp.arange(n, dtype=jnp.int32), jnp.int32(n)
    )
    packed = jax.lax.sort(keys)
    return jnp.minimum(packed[:n_out], n - 1)


def make_tail_compact_fn(packed, start_stage, exact, n0,
                         shrink_every: int = 2, n_floor: int = 4096):
    """Re-compacting matmul tail: like make_tail_fn, but every
    ``shrink_every`` stages the surviving patch rows are gathered into a
    half-sized batch, so late stages run on thousands of windows instead
    of the full tail capacity (a batched stand-in for the per-window
    early exit the reference's runtime loop gets for free).

    fn(ps (n0,P) i32, pt, inv (n0,), cnt) ->
        (widx (n_last,) i32  — original tail-row index per survivor slot,
         alive (n_last,) bool, overflow bool)
    Static shrink schedule; ``overflow`` reports any step where live
    windows exceeded the next capacity (caller falls back)."""
    stage_ids = list(range(start_stage, len(packed.stages)))
    per_stage = []
    for si in stage_ids:
        a_sum, a_tilt, wts, (thr, ll, rr), _, sthr = _pack_tail(
            packed.stages, [si], packed.win_w, packed.win_h
        )
        per_stage.append((
            jnp.asarray(a_sum, jnp.bfloat16),
            None if a_tilt is None else jnp.asarray(a_tilt, jnp.bfloat16),
            jnp.asarray(wts),
            jnp.asarray(thr),
            jnp.asarray(ll),
            jnp.asarray(rr),
            sthr[0],
        ))
    has_tilt = any(s[1] is not None for s in per_stage)

    def tail(ps, pt, inv, cnt):
        acc_dt = jnp.float64 if exact else jnp.float32
        n = n0
        alive = jnp.arange(n) < cnt
        widx = jnp.arange(n, dtype=jnp.int32)
        overflow = jnp.zeros((), bool)
        # the 4-limb absolute planes are exact for untilted stages too
        if has_tilt:
            limbs_s, limbs_t = _limbs_abs(ps), _limbs_abs(pt)
        else:
            limbs_s, limbs_t = _limbs_rel(ps), None
        for k, (a_j, at_j, w_j, thr_j, ll_j, rr_j, sthr_k) in enumerate(
            per_stage
        ):
            if at_j is None:
                # untilted stage: 3-limb relative planes (or, in a mixed
                # cascade, exact absolute 4-limb planes — same recombine)
                rs = _matmul_limbs(a_j, limbs_s)
            else:
                # tilted canvases are not monotone from the patch corner,
                # so the 2-limb relative trick does not apply
                rs = _matmul_limbs(a_j, limbs_s) + _matmul_limbs(
                    at_j, limbs_t
                )
            t_k = w_j.shape[0]
            rs = rs.reshape(t_k, 3, -1).astype(jnp.float32)
            raw = rs[:, 0] * w_j[:, 0:1]
            raw = raw + rs[:, 1] * w_j[:, 1:2]
            raw = raw + rs[:, 2] * w_j[:, 2:3]
            val = raw * inv[None, :]
            leaf = jnp.where(
                val < thr_j[:, None], ll_j[:, None].astype(acc_dt),
                rr_j[:, None].astype(acc_dt),
            )
            ssum = jnp.sum(leaf, axis=0)
            alive = alive & (ssum >= acc_dt(sthr_k))
            last = k == len(per_stage) - 1
            if not last and (k + 1) % shrink_every == 0 and n // 2 >= n_floor:
                na = n // 2
                ai = alive.astype(jnp.int32)
                live = jnp.sum(ai)
                overflow = overflow | (live > na)
                idx2 = _nonzero_1d(ai, na)
                limbs_s = tuple(lb[idx2] for lb in limbs_s)
                if has_tilt:
                    limbs_t = tuple(lb[idx2] for lb in limbs_t)
                inv = inv[idx2]
                widx = widx[idx2]
                alive = jnp.arange(na) < jnp.minimum(live, na)
                n = na
        return widx, alive, overflow

    if exact:
        def tail_x64(ps, pt, inv, cnt):
            with jax.enable_x64(True):
                return tail(ps, pt, inv, cnt)

        return jax.jit(tail_x64)
    return jax.jit(tail)


def make_nonzero_fn(out_h, out_w, n_max, grid_rows=None):
    """fn(mask (H,W) bool) -> idx (n_max,) i32 — ascending flat indices of
    set positions, zero-padded.

    Two-level design:
      1. per-row sort of `col if alive else BIG` left-packs each row's
         survivor columns (int16; one batched lax.sort)
      2. queries binary-search the per-row-count cumsum — an (out_h,)
         array that stays cache-resident — to find their row
      3. one monotone gather fetches each query's column

    grid_rows: optional static np.int32 array of the only rows that can
    contain survivors (the detector's ystep grid rows — roughly half the
    canvas); the sort then runs on the compressed row set."""
    assert out_w < 2**15
    if grid_rows is not None:
        gr = np.asarray(grid_rows, np.int32)
        n_rows = len(gr)
        gr_j = jnp.asarray(gr)
    else:
        n_rows = out_h

    def fn(mask):
        if grid_rows is not None:
            mask = jnp.take(mask, gr_j, axis=0)
        keys = jnp.where(
            mask,
            jax.lax.broadcasted_iota(jnp.int16, (n_rows, out_w), 1),
            jnp.int16(out_w),
        )
        packed = jax.lax.sort(keys, dimension=1)  # survivors first
        rcnt = jnp.sum(mask, axis=1, dtype=jnp.int32)
        rcum = jnp.cumsum(rcnt)  # inclusive
        q = jnp.arange(n_max, dtype=jnp.int32)
        rowq = jnp.searchsorted(rcum, q, side="right").astype(jnp.int32)
        rowq = jnp.minimum(rowq, n_rows - 1)
        jq = q - (jnp.take(rcum, rowq) - jnp.take(rcnt, rowq))
        colq = packed[rowq, jq].astype(jnp.int32)
        total = rcum[-1]
        out_row = jnp.take(gr_j, rowq) if grid_rows is not None else rowq
        idx = out_row * out_w + colq
        return jnp.where(q < total, idx, 0).astype(jnp.int32)

    return jax.jit(fn)


def make_patchify_fn(win_w, win_h, need_tilt):
    """fn(sum2d, tilt2d, r (N,), c (N,)) -> ((N,P) i32, (N,P) i32|None)

    Gathers each survivor's (win_h+1, win_w+1) integral patch (vmapped
    dynamic_slice)."""
    ph, pw = win_h + 1, win_w + 1

    def patchify(canvas, r, c):
        def one(ri, ci):
            return jax.lax.dynamic_slice(canvas, (ri, ci), (ph, pw))

        return jax.vmap(one)(r, c).reshape(-1, ph * pw)

    def run(sum2d, tilt2d, r, c):
        ps = patchify(sum2d, r, c)
        pt = patchify(tilt2d, r, c) if need_tilt else ps[:, :1]
        return ps, pt

    return jax.jit(run)
