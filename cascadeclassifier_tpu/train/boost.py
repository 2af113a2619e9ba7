"""Boosted cascade-stage trainer (DAB / RAB / LB / GAB).

Batched re-design of CvCascadeBoost (boost.cpp:166-518) + CvBoostTree split
search (o_cvboostree.cpp). The reference scans features one at a time over
per-feature presorted sample columns; here the whole feature axis is
processed at once:

  - per stage, feature values for all samples are evaluated block-wise
    as matmuls (train/evaluators.py) and argsorted once — the values (hence
    sort orders) are fixed within a stage, only boosting weights change
  - per weak learner, the exact weighted split objective
    (lsum²·R + rsum²·L)/(L·R) (find_split_ord_reg,
    o_cvboostree.cpp:361-426) is a cumulative sum over the sorted axis +
    argmax — vectorized over every feature simultaneously
  - the categorical (LBP) path reproduces find_split_cat_reg
    (o_cvboostree.cpp:428-516): 256-bin weighted sums, sort categories by
    mean response, greedy prefix scan, subset bitmask
  - boosting state (weights, trimming, stage threshold search) runs on the
    host in float64, mirroring update_weights (boost.cpp:168-407),
    trim_weights (o_cvboost.cpp:101-139) and isErrDesired
    (boost.cpp:479-518)

Weak trees support max_depth > 1 via recursive masked splits (node masks
replace the reference's index-partitioning split_node_data).
"""

from __future__ import annotations

import dataclasses
import functools
import math
import time

import numpy as np

import jax
import jax.numpy as jnp

from cascadeclassifier_tpu.models.model import (
    BOOST_DAB,
    BOOST_GAB,
    BOOST_LB,
    BOOST_RAB,
    Stage,
    WeakTree,
)

FLT_EPSILON = np.float32(1.1920929e-07)
DBL_EPSILON = 2.220446049250313e-16
CV_THRESHOLD_EPS = 1e-5
LB_Z_MAX = 10.0
LB_WEIGHT_THRESH = FLT_EPSILON


def as_f64(x):
    """Create a true float64 device array under JAX's 32-bit default mode
    (plain jnp.asarray would silently downcast outside an x64 scope)."""
    with jax.enable_x64(True):
        return jnp.asarray(np.asarray(x, np.float64))


def _log_ratio(p):
    eps = 1e-5
    p = min(max(p, eps), 1.0 - eps)
    return math.log(p / (1.0 - p))


# ---------------------------------------------------------------------------
# jitted split searches
# ---------------------------------------------------------------------------


@jax.jit
def _ordered_split_sorted(vs, ws, rs, kept, total_w, total_r):
    """Best weighted regression split per feature, sorted domain.

    vs  : (B, N) f32 feature responses, ascending per row
    ws  : (B, N) f64 masked weights in that order (0 where dropped)
    rs  : (B, N) f64 masked weight·response in that order
    kept: (B, N) bool subsample mask in that order
    total_w/total_r: f64 scalars summed in the ORIGINAL sample order (f64
    summation order is part of the reference arithmetic being replicated)
    returns (quality (B,) f64, thr (B,) f32) — quality −inf if no split.

    Replicates find_split_ord_reg (o_cvboostree.cpp:361-426): split allowed
    between adjacent in-subsample samples whose values differ by more than
    2·FLT_EPSILON; threshold is their midpoint. Inputs arrive pre-sorted:
    the (B, N) gathers along each feature's sample order are the expensive
    part, so the caller gathers the per-iteration
    weights once and derives everything else from per-stage caches.
    """
    with jax.enable_x64(True):
        lw = jnp.cumsum(ws, axis=1)
        lr = jnp.cumsum(rs, axis=1)
        rw = total_w - lw
        rr = total_r - lr

        # next in-subsample value after position i (suffix min of +inf-masked
        # values works because the array is sorted ascending)
        vk = jnp.where(kept, vs, jnp.inf)
        nxt = jnp.flip(
            jax.lax.cummin(jnp.flip(vk, axis=1), axis=1), axis=1
        )
        nxt = jnp.concatenate(
            [nxt[:, 1:], jnp.full((vs.shape[0], 1), jnp.inf)], axis=1
        )

        valid = kept & (vs + 2 * FLT_EPSILON < nxt) & jnp.isfinite(nxt)
        qual = (lr * lr * rw + rr * rr * lw) / (lw * rw)
        qual = jnp.where(valid & (lw > 0) & (rw > 0), qual, -jnp.inf)

        # first-max argmax without jnp.argmax (which mis-lowers inside a
        # trace-time x64 scope): min position where qual equals the row max
        bq = jnp.max(qual, axis=1)
        posn = jax.lax.broadcasted_iota(jnp.int32, qual.shape, 1)
        best = jnp.min(
            jnp.where(qual == bq[:, None], posn, qual.shape[1]), axis=1
        )
        best = jnp.minimum(best, qual.shape[1] - 1)
        bv = jnp.take_along_axis(vs, best[:, None], axis=1)[:, 0]
        bn = jnp.take_along_axis(nxt, best[:, None], axis=1)[:, 0]
        # reference computes the midpoint in float32
        thr = (
            bv.astype(jnp.float32) + bn.astype(jnp.float32)
        ) * np.float32(0.5)
        return bq, thr


def _ordered_split_block(values, sort_idx, w, resp, mask):
    """Unsorted-domain wrapper over _ordered_split_sorted (the dtree and
    sharded callers pass per-node weights where caching sorted views has
    no payoff)."""
    with jax.enable_x64(True):
        wm = jnp.where(mask, w, 0.0)
        rm = wm * resp
        vs = jnp.take_along_axis(values, sort_idx, axis=1)
        ws = wm[sort_idx]
        rs = rm[sort_idx]
        kept = mask[sort_idx]
        return _ordered_split_sorted(
            vs, ws, rs, kept, jnp.sum(wm), jnp.sum(rm)
        )


@jax.jit
def _categorical_split_block(codes, w, resp, mask):
    """Best weighted regression split over 256 categories per feature.

    codes: (B, N) int32 in [0, 256). Replicates find_split_cat_reg
    (o_cvboostree.cpp:428-516). Returns (quality (B,) f64, subset (B, 8) i32).
    """
    with jax.enable_x64(True):
        wm = jnp.where(mask, w, 0.0)
        rm = wm * resp
        b, n = codes.shape

        def per_cat(c, _):
            sel = codes == c
            cnt = jnp.sum(jnp.where(sel, wm[None, :], 0.0), axis=1)
            sm = jnp.sum(jnp.where(sel, rm[None, :], 0.0), axis=1)
            return c + 1, (cnt, sm)

        _, (cnts, sums) = jax.lax.scan(
            per_cat, 0, None, length=256
        )  # (256, B)
        cnts = cnts.T  # (B, 256)
        sums = sums.T

        means = jnp.where(jnp.abs(cnts) > DBL_EPSILON, sums / cnts, 0.0)
        order = jnp.argsort(means, axis=1, stable=True)  # (B, 256)
        cnt_s = jnp.take_along_axis(cnts, order, axis=1)
        sum_s = jnp.take_along_axis(means * cnts, order, axis=1)

        total_w = jnp.sum(cnts, axis=1, keepdims=True)
        total_r = jnp.sum(sums, axis=1, keepdims=True)
        lw = jnp.cumsum(cnt_s, axis=1)
        lr = jnp.cumsum(sum_s, axis=1)
        rw = total_w - lw
        rr = total_r - lr

        pos = jax.lax.broadcasted_iota(jnp.int32, (b, 256), 1)
        valid = (
            (cnt_s > FLT_EPSILON)
            & (lw > FLT_EPSILON)
            & (rw > FLT_EPSILON)
            & (pos < 255)  # loop runs subset_i < mi − 1
        )
        qual = (lr * lr * rw + rr * rr * lw) / (lw * rw)
        qual = jnp.where(valid, qual, -jnp.inf)

        bq = jnp.max(qual, axis=1)
        best = jnp.min(
            jnp.where(qual == bq[:, None], pos, 256), axis=1
        )
        best = jnp.minimum(best, 255)

        incl = pos <= best[:, None]  # categories (sorted order) in subset
        # scatter back to original category ids → 8×32-bit mask
        cat_in = jnp.zeros((b, 256), bool)
        cat_in = jnp.take_along_axis(
            incl, jnp.argsort(order, axis=1), axis=1
        )
        bits = cat_in.reshape(b, 8, 32)
        weights32 = (1 << jnp.arange(32, dtype=jnp.uint32)).astype(jnp.uint32)
        subset = jnp.sum(
            jnp.where(bits, weights32[None, None, :], 0).astype(jnp.uint32),
            axis=2,
            dtype=jnp.uint32,
        ).astype(jnp.int32)
        return bq, subset


@functools.partial(jax.jit, static_argnames=("use_gini",))
def _ordered_class_split_sorted(vs, ws, cls_s, kept, t0, t1, use_gini):
    """Sorted-domain two-class split (see _ordered_split_sorted for the
    caching rationale). cls_s: (B, N) int {0,1} in sorted order; t0/t1:
    f64 class weight totals summed in the original sample order."""
    with jax.enable_x64(True):
        w1s = jnp.where(cls_s == 1, ws, 0.0)
        w0s = ws - w1s
        c0 = jnp.cumsum(w0s, axis=1)
        c1 = jnp.cumsum(w1s, axis=1)
        r0 = t0 - c0
        r1 = t1 - c1

        vk = jnp.where(kept, vs, jnp.inf)
        nxt = jnp.flip(jax.lax.cummin(jnp.flip(vk, axis=1), axis=1), axis=1)
        nxt = jnp.concatenate(
            [nxt[:, 1:], jnp.full((vs.shape[0], 1), jnp.inf)], axis=1
        )
        valid = kept & (vs + 2 * FLT_EPSILON < nxt) & jnp.isfinite(nxt)

        if use_gini:
            lw = c0 + c1
            rw = r0 + r1
            qual = ((c0 * c0 + c1 * c1) * rw + (r0 * r0 + r1 * r1) * lw) / (
                lw * rw
            )
            qual = jnp.where(valid & (lw > 0) & (rw > 0), qual, -jnp.inf)
        else:
            qual = jnp.maximum(c0 + r1, c1 + r0)
            qual = jnp.where(valid, qual, -jnp.inf)

        bq = jnp.max(qual, axis=1)
        posn = jax.lax.broadcasted_iota(jnp.int32, qual.shape, 1)
        best = jnp.min(
            jnp.where(qual == bq[:, None], posn, qual.shape[1]), axis=1
        )
        best = jnp.minimum(best, qual.shape[1] - 1)
        bv = jnp.take_along_axis(vs, best[:, None], axis=1)[:, 0]
        bn = jnp.take_along_axis(nxt, best[:, None], axis=1)[:, 0]
        thr = (
            bv.astype(jnp.float32) + bn.astype(jnp.float32)
        ) * np.float32(0.5)
        return bq, thr


def _ordered_class_split_block(values, sort_idx, w, cls, mask, use_gini):
    """Unsorted-domain wrapper over _ordered_class_split_sorted (dtree /
    sharded callers)."""
    with jax.enable_x64(True):
        wm = jnp.where(mask, w, 0.0)
        vs = jnp.take_along_axis(values, sort_idx, axis=1)
        ws = wm[sort_idx]
        cls_s = cls[sort_idx]
        kept = mask[sort_idx]
        t0 = jnp.sum(jnp.where(cls == 0, wm, 0.0))
        t1 = jnp.sum(wm) - t0
        return _ordered_class_split_sorted(vs, ws, cls_s, kept, t0, t1,
                                           use_gini)


@functools.partial(jax.jit, static_argnames=("use_gini",))
def _categorical_class_split_block(codes, w, cls, mask, use_gini):
    """Two-class categorical split (find_split_cat_class,
    o_cvboostree.cpp:249-359): per-category class-weight pairs sorted by
    the class-1 weight, greedy prefix scan, subset bitmask."""
    with jax.enable_x64(True):
        wm = jnp.where(mask, w, 0.0)
        w1 = jnp.where(cls == 1, wm, 0.0)
        w0 = wm - w1
        b, n = codes.shape

        def per_cat(c, _):
            sel = codes == c
            cw0 = jnp.sum(jnp.where(sel, w0[None, :], 0.0), axis=1)
            cw1 = jnp.sum(jnp.where(sel, w1[None, :], 0.0), axis=1)
            return c + 1, (cw0, cw1)

        _, (cw0, cw1) = jax.lax.scan(per_cat, 0, None, length=256)
        cw0 = cw0.T  # (B, 256)
        cw1 = cw1.T

        order = jnp.argsort(cw1, axis=1, stable=True)
        s0 = jnp.take_along_axis(cw0, order, axis=1)
        s1 = jnp.take_along_axis(cw1, order, axis=1)
        weight = s0 + s1
        skip = weight < FLT_EPSILON
        # skipped categories move no mass (their weight ≈ 0 numerically)
        lc0 = jnp.cumsum(jnp.where(skip, 0.0, s0), axis=1)
        lc1 = jnp.cumsum(jnp.where(skip, 0.0, s1), axis=1)
        t0 = jnp.sum(cw0, axis=1, keepdims=True)
        t1 = jnp.sum(cw1, axis=1, keepdims=True)
        rc0 = t0 - lc0
        rc1 = t1 - lc1

        posi = jax.lax.broadcasted_iota(jnp.int32, (b, 256), 1)
        valid = (~skip) & (posi < 255)
        if use_gini:
            lw = lc0 + lc1
            rw = rc0 + rc1
            qual = (
                (lc0 * lc0 + lc1 * lc1) * rw + (rc0 * rc0 + rc1 * rc1) * lw
            ) / (lw * rw)
            valid = valid & (lw > FLT_EPSILON) & (rw > FLT_EPSILON)
        else:
            qual = jnp.maximum(lc0 + rc1, lc1 + rc0)
        qual = jnp.where(valid, qual, -jnp.inf)

        bq = jnp.max(qual, axis=1)
        best = jnp.min(
            jnp.where(qual == bq[:, None], posi, 256), axis=1
        )
        best = jnp.minimum(best, 255)

        incl = posi <= best[:, None]
        cat_in = jnp.take_along_axis(incl, jnp.argsort(order, axis=1), axis=1)
        bits = cat_in.reshape(b, 8, 32)
        weights32 = (1 << jnp.arange(32, dtype=jnp.uint32)).astype(jnp.uint32)
        subset = jnp.sum(
            jnp.where(bits, weights32[None, None, :], 0).astype(jnp.uint32),
            axis=2,
            dtype=jnp.uint32,
        ).astype(jnp.int32)
        return bq, subset


@jax.jit
def _node_value(w, resp, mask):
    """Weighted mean response over the node (calc_node_value regression
    branch, o_cvboostree.cpp:699-727)."""
    with jax.enable_x64(True):
        wm = jnp.where(mask, w, 0.0)
        sw = jnp.sum(wm)
        return jnp.sum(wm * resp) / sw


def _node_value_class(w, cls, mask, boost_type):
    """Classification leaf (calc_node_value, o_cvboostree.cpp:669-698):
    DAB leaf = ±1 majority class; RAB leaf = ½·log-odds of class 1."""
    wm = np.where(mask, w, 0.0)
    rcw1 = float(wm[cls == 1].sum())
    rcw0 = float(wm.sum()) - rcw1
    if boost_type == BOOST_DAB:
        return 1.0 if rcw1 > rcw0 else -1.0
    p = rcw1 / (rcw0 + rcw1) if (rcw0 + rcw1) > 0 else 0.5
    return 0.5 * _log_ratio(p)


# ---------------------------------------------------------------------------
# stage trainer
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BoostParams:
    boost_type: int = BOOST_GAB
    min_hit_rate: float = 0.995
    max_false_alarm: float = 0.5
    weight_trim_rate: float = 0.95
    max_depth: int = 1
    weak_count: int = 100
    min_sample_count: int = 10


class FeatureCache:
    """Per-stage cache of feature values (+ sort orders for ordered
    families) over the current sample set — the device analogue of the
    reference's valCache / sorted-index buf
    (o_cvcascadeboosttraindata.cpp:246-273).

    Memory budget (o_cvcascadeboosttraindata.cpp:250-264 semantics):
    ``val_buf_mb`` caps resident raw feature values; ``idx_buf_mb`` caps
    the resident sort-order machinery (sort_idx + sorted values + the
    per-stage sorted views). Blocks beyond the value budget recompute
    their values from the evaluator on every access; blocks beyond the
    index budget re-sort on every access — exactly the reference's
    cache-or-evaluate / sort-on-demand fallbacks, at block granularity.

    ``mesh``: when given, every resident block is placed feature-sharded
    (NamedSharding(mesh, P(axis, None))) so the jitted split kernels
    auto-partition over devices via GSPMD — the per-feature arithmetic is
    row-independent, so per-feature qualities are bitwise identical to the
    single-device run and the global first-argmax reduction (XLA inserts
    the collectives) picks the identical split."""

    def __init__(self, evaluator, categorical: bool,
                 val_buf_mb: float | None = None,
                 idx_buf_mb: float | None = None,
                 mesh=None, mesh_axis: str = "feat"):
        self.ev = evaluator
        self.categorical = categorical
        self.mesh = mesh
        self._shard = None
        self._n_shards = 1
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec

            self._shard = NamedSharding(mesh, PartitionSpec(mesh_axis, None))
            self._n_shards = int(mesh.shape[mesh_axis])
        nb = evaluator.num_blocks()
        n = evaluator.n
        blk = evaluator.block_size
        # numPrecalcVal/numPrecalcIdx analogue, at block granularity:
        # bytes per resident value block = blk·n·4; per index block ≈
        # blk·n·(4 idx + 4 sorted vals + 1 valid + 8 aux) = blk·n·17
        if val_buf_mb is None:
            self.n_val = nb
        else:
            self.n_val = min(nb, int(val_buf_mb * 2**20 // (4 * n * blk)))
        if idx_buf_mb is None:
            self.n_idx = nb
        else:
            self.n_idx = min(nb, int(idx_buf_mb * 2**20 // (17 * n * blk)))
        if categorical:
            self.n_idx = 0  # no sort machinery for categorical families
        self.n_idx = min(self.n_idx, self.n_val)

        self.values = [None] * nb
        self.vs = [None] * nb  # values in sorted order (weak-loop invariant)
        self._si = [None] * nb  # lazy argsort (generic/deep-node path only)
        for b in range(nb):
            if b < self.n_val:
                self.values[b] = self._place(evaluator.values_block(b))
            if not categorical and b < self.n_idx:
                # sorted values via one lax.sort; the explicit argsort is
                # computed lazily (only the rare generic path needs it —
                # keeping (B, N) int32 indices resident costs ~2 GB at
                # production scale)
                self.vs[b] = jax.lax.sort(self.values[b], dimension=1)
        self.num_blocks = nb
        self.valid_sorted = None
        self.aux_sorted = None  # resp (regression) or cls (classification)

    def _place(self, arr):
        if self._shard is None:
            return arr
        r = arr.shape[0] % self._n_shards
        if r:
            # pad to shardable rows with all-zero (constant) features:
            # constant rows admit no valid split, so their quality is
            # -inf and they can never win the first-argmax
            arr = jnp.concatenate(
                [
                    arr,
                    jnp.zeros(
                        (self._n_shards - r, arr.shape[1]), arr.dtype
                    ),
                ],
                axis=0,
            )
        return jax.device_put(arr, self._shard)

    def block_values(self, b):
        """Raw (B, N) values of block b — resident or recomputed
        (getVarValue cache-or-evaluator, o_cvcascadeboosttraindata.cpp:484)."""
        if self.values[b] is not None:
            return self.values[b]
        return self._place(self.ev.values_block(b))

    def block_sorted(self, b, values=None):
        """(sort_idx, sorted values) of block b — computed lazily and
        memoized (get_ord_var_data on-demand sort,
        o_cvcascadeboosttraindata.cpp:403); only the generic split path
        (deep tree nodes, budget-evicted blocks) needs explicit indices."""
        if self._si[b] is not None and self.vs[b] is not None:
            return self._si[b], self.vs[b]
        v = values if values is not None else self.block_values(b)
        iota = jax.lax.broadcasted_iota(jnp.int32, v.shape, 1)
        vs, si = jax.lax.sort((v, iota), dimension=1, num_keys=1)
        if b < self.n_idx:
            self._si[b] = si
        return si, vs

    def set_stage(self, valid, aux):
        """Cache per-stage sorted views via stable payload sorts (values
        as keys): everything constant across weak iterations is reordered
        exactly once, without (B, N) gathers."""
        if self.categorical:
            return
        # narrow payload dtypes: validity as int8; responses as f32
        # (GAB/DAB/RAB targets are exactly ±1 — f32-exact; the LB path,
        # whose responses are not, re-sorts them per iteration instead of
        # using this cache) and class labels as int8
        vj = jnp.asarray(valid, jnp.int8)
        aux_np = np.asarray(aux)
        if aux_np.dtype.kind == "f":
            aj = jnp.asarray(aux_np.astype(np.float32))
        else:
            aj = jnp.asarray(aux_np.astype(np.int8))
        self.valid_sorted = [None] * self.num_blocks
        self.aux_sorted = [None] * self.num_blocks
        for b in range(self.num_blocks):
            if self.vs[b] is None:
                continue
            v = self.values[b]
            with jax.enable_x64(True):
                _, vs_s, as_s = jax.lax.sort(
                    (
                        v,
                        jnp.broadcast_to(vj, v.shape),
                        jnp.broadcast_to(aj, v.shape),
                    ),
                    dimension=1,
                    num_keys=1,
                )
            self.valid_sorted[b] = vs_s != 0
            self.aux_sorted[b] = as_s

    def var_base(self, b):
        return self.ev.block_slice(b)[0]


@functools.partial(
    jax.jit, static_argnames=("classifier", "use_gini", "resp_static")
)
def _block_split_fast(values, vs, valid_s, aux_s, w64, resp64, cls, valid,
                      wthr, classifier, use_gini, resp_static):
    """One block's split search with a single per-iteration payload sort.

    The per-iteration boosting weights are carried into each feature's
    sample order by a stable variadic sort keyed on the (static) feature
    values — identical ordering to the cached argsort, but
    bandwidth-bound instead of the ~20 ns/element XLA gather. The
    weight-trimming subsample is a pure weight threshold (trim_weights,
    o_cvboost.cpp:101-139), so the sorted mask derives from the sorted
    weights; sorted values / validity / targets come from the per-stage
    cache. Class/response totals are summed in the original sample order
    (f64 summation order is replicated reference arithmetic)."""
    with jax.enable_x64(True):
        wb = jnp.broadcast_to(w64, values.shape)
        if resp_static:
            _, ws_raw = jax.lax.sort(
                (values, wb), dimension=1, num_keys=1
            )
            rs_raw = None
        else:
            rb = jnp.broadcast_to(resp64, values.shape)
            _, ws_raw, rs_raw = jax.lax.sort(
                (values, wb, rb), dimension=1, num_keys=1
            )
        kept = valid_s & (ws_raw >= wthr)
        ws = jnp.where(kept, ws_raw, 0.0)
        mask = valid & (w64 >= wthr)
        wm = jnp.where(mask, w64, 0.0)
        if classifier:
            t0 = jnp.sum(jnp.where(cls == 0, wm, 0.0))
            t1 = jnp.sum(wm) - t0
            q, thr = _ordered_class_split_sorted(
                vs, ws, aux_s, kept, t0, t1, use_gini
            )
        else:
            if resp_static:
                rs = ws * aux_s
            else:
                rs = jnp.where(kept, ws_raw * rs_raw, 0.0)
            rm = wm * resp64
            q, thr = _ordered_split_sorted(
                vs, ws, rs, kept, jnp.sum(wm), jnp.sum(rm)
            )
        qm, i = _best_of_block(q)
        return qm, i, thr[i]


def _best_of_block(q):
    """Device (max, first-argmax) as a min-index-of-max reduction, which
    pins the first maximum on every backend (chip_smoke.py reports
    whether jnp.argmax inside an x64 scope agrees on the card). Runs
    under its own x64 scope: outside one, JAX truncates f64 operands to
    f32 and the cross-block quality ranking loses reference precision."""
    with jax.enable_x64(True):
        qm = jnp.max(q)
        n = q.shape[0]
        i = jnp.min(
            jnp.where(q == qm, jnp.arange(n, dtype=jnp.int32), jnp.int32(n))
        )
        # int32 result: callers index f32 arrays with it OUTSIDE any x64
        # scope, where an int64 index triggers a mixed-dtype lax.select
        return qm, jnp.minimum(i, n - 1).astype(jnp.int32)


class StageTrainer:
    """Trains one boosted stage; mirrors CvCascadeBoost::train
    (boost.cpp:409-459).

    mesh: optional jax.sharding.Mesh — feature blocks are placed sharded
    over its first axis and the split search runs SPMD across devices
    (identical stages to the single-device run; see FeatureCache).
    val_buf_mb / idx_buf_mb: precalc buffer budgets (-precalcValBufSize /
    -precalcIdxBufSize analogues)."""

    def __init__(self, evaluator, params: BoostParams, mesh=None,
                 val_buf_mb: float | None = None,
                 idx_buf_mb: float | None = None):
        self.ev = evaluator
        self.params = params
        self.mesh = mesh
        self.val_buf_mb = val_buf_mb
        self.idx_buf_mb = idx_buf_mb
        self.categorical = evaluator.maxCatCount > 0

    # -- weak-tree construction --------------------------------------------

    def _find_best_split(self, cache, w, resp, mask, wthr=None):
        """Global best split across every feature. Returns
        (var_idx, thr_or_subset) or None.

        GAB/LB grow regression trees (find_split_*_reg); DAB/RAB grow
        two-class classification trees with MISCLASS/GINI criteria
        (set_params mapping, o_cvboost.cpp:67-99).

        wthr: when the subsample mask equals valid & (w >= wthr) — i.e. at
        a tree root where the mask comes purely from weight trimming — the
        fast sorted path runs with a single (B, N) gather per block.
        Deeper tree nodes pass arbitrary node masks (wthr=None) through
        the generic wrappers."""
        wj = as_f64(w)
        mj = jnp.asarray(mask)
        classifier = self._is_classifier
        use_gini = self.params.boost_type == BOOST_RAB
        if classifier:
            cj = jnp.asarray(self._cls)
        else:
            rj = as_f64(resp)
        resp_static = self.params.boost_type != BOOST_LB
        # per-block device reductions, ONE host fetch at the end instead
        # of a host round trip per block
        qs, ids, payloads = [], [], []
        for b in range(cache.num_blocks):
            # fast path needs the resident sorted machinery AND a pure
            # weight-threshold mask (tree roots); budget-evicted blocks and
            # deep nodes take the generic on-demand path
            fast = (
                wthr is not None
                and not self.categorical
                and cache.vs[b] is not None
            )
            if self.categorical:
                vals = cache.block_values(b)
                if classifier:
                    q, subset = _categorical_class_split_block(
                        vals, wj, cj, mj, use_gini
                    )
                else:
                    q, subset = _categorical_split_block(vals, wj, rj, mj)
                qm, i = _best_of_block(q)
                payloads.append(subset[i])
            elif fast:
                qm, i, thr_i = _block_split_fast(
                    cache.values[b], cache.vs[b],
                    cache.valid_sorted[b], cache.aux_sorted[b],
                    wj, wj if classifier else rj, cj if classifier else mj,
                    jnp.asarray(self._valid), as_f64(wthr),
                    classifier, use_gini, resp_static,
                )
                payloads.append(thr_i)
            else:
                vals = cache.block_values(b)
                si, _ = cache.block_sorted(b, vals)
                if classifier:
                    q, thr = _ordered_class_split_block(
                        vals, si, wj, cj, mj, use_gini
                    )
                else:
                    q, thr = _ordered_split_block(vals, si, wj, rj, mj)
                qm, i = _best_of_block(q)
                payloads.append(thr[i])
            qs.append(qm)
            ids.append(i)
        qs = np.asarray(jnp.stack(qs))
        ids = np.asarray(jnp.stack(ids))
        pay = np.asarray(jnp.stack(payloads))
        best_q = -np.inf
        best = None
        for b in range(cache.num_blocks):
            # strict >: earlier blocks win ties, matching the old
            # host-side scan (and the reference's ascending feature scan)
            if np.isfinite(qs[b]) and qs[b] > best_q:
                best_q = float(qs[b])
                var = cache.var_base(b) + int(ids[b])
                if self.categorical:
                    best = (var, pay[b])
                else:
                    best = (var, np.float32(pay[b]))
        return best

    def _values_of_var(self, cache, var_idx: int):
        b = var_idx // self.ev.block_size
        off = var_idx - cache.var_base(b)
        return np.asarray(cache.block_values(b)[off])

    def _train_tree(self, cache, w, resp, mask, wthr=None):
        """Grow one weak tree (depth-limited recursive masked splits).

        Returns (WeakTree, per-sample predictions over ALL samples).
        wthr: trim threshold for the root split's fast path (the root mask
        is exactly valid & (w >= wthr); deeper node masks are not)."""
        n = w.shape[0]
        p = self.params

        nodes = []  # (left, right, var, thr_or_subset)
        leaves = []

        def leaf_value(node_mask):
            if self._is_classifier:
                v = _node_value_class(
                    w, self._cls, node_mask, self.params.boost_type
                )
            else:
                v = float(
                    _node_value(as_f64(w), as_f64(resp), jnp.asarray(node_mask))
                )
            leaves.append(np.float32(v))
            return -(len(leaves) - 1)

        def grow(node_mask, depth):
            count = int(node_mask.sum())
            if depth >= p.max_depth or count <= p.min_sample_count:
                return leaf_value(node_mask)
            split = self._find_best_split(
                cache, w, resp, node_mask, wthr if depth == 0 else None
            )
            if split is None:
                return leaf_value(node_mask)
            var_idx, thr = split
            vals = self._values_of_var(cache, var_idx)
            if self.categorical:
                code = vals.astype(np.int64)
                bit = (
                    np.asarray(thr, np.uint32)[code >> 5] >> (code & 31)
                ) & 1
                go_left = bit != 0
            else:
                go_left = vals <= thr
            lmask = node_mask & go_left
            rmask = node_mask & ~go_left
            if lmask.sum() == 0 or rmask.sum() == 0:
                return leaf_value(node_mask)
            me = len(nodes)
            nodes.append([0, 0, var_idx, thr])
            nodes[me][0] = grow(lmask, depth + 1)
            nodes[me][1] = grow(rmask, depth + 1)
            return me

        root = grow(mask.copy(), 0)
        if root < 0:
            # degenerate: single leaf — encode as a stump that always routes
            # to the same value (reference fails tree training instead;
            # callers treat quality None upstream)
            return None, None

        k = len(nodes)
        tree = WeakTree(
            left=np.array([nd[0] for nd in nodes], np.int32),
            right=np.array([nd[1] for nd in nodes], np.int32),
            feature_idx=np.array([nd[2] for nd in nodes], np.int32),
            threshold=(
                None
                if self.categorical
                else np.array([nd[3] for nd in nodes], np.float32)
            ),
            subsets=(
                np.stack([np.asarray(nd[3], np.int32) for nd in nodes])
                if self.categorical
                else None
            ),
            leaf_values=np.array(leaves, np.float32),
        )
        preds = self._predict_tree(tree, cache, n)
        return tree, preds

    def _predict_tree(self, tree, cache, n):
        """Leaf value of every sample (predict semantics of
        o_cvcascadeboosttree.cpp:16-39)."""
        out = np.zeros(n, np.float64)
        node = np.zeros(n, np.int32)
        active = np.ones(n, bool)
        # iterative walk: at most num_nodes levels
        for _ in range(tree.num_nodes + 1):
            if not active.any():
                break
            for ni in np.unique(node[active]):
                sel = active & (node == ni)
                var = int(tree.feature_idx[ni])
                vals = self._values_of_var(cache, var)[sel]
                if self.categorical:
                    code = vals.astype(np.int64)
                    bit = (
                        tree.subsets[ni].astype(np.uint32)[code >> 5]
                        >> (code & 31)
                    ) & 1
                    go_left = bit != 0
                else:
                    go_left = vals <= tree.threshold[ni]
                child = np.where(go_left, tree.left[ni], tree.right[ni])
                idx = np.nonzero(sel)[0]
                is_leaf = child <= 0
                out[idx[is_leaf]] = tree.leaf_values[-child[is_leaf]]
                active[idx[is_leaf]] = False
                node[idx[~is_leaf]] = child[~is_leaf]
        return out

    # -- boosting loop ------------------------------------------------------

    def train(self, labels: np.ndarray, valid: np.ndarray | None = None,
              verbose=True):
        """labels: (N,) {0,1}. The evaluator must already hold the samples.
        ``valid`` marks real samples when the batch is padded to a bucketed
        shape (padding gets zero weight and never enters any statistic).
        Returns (Stage, per-sample raw sums) or None if no tree trained."""
        p = self.params
        n = labels.shape[0]
        if valid is None:
            valid = np.ones(n, bool)
        n_real = int(valid.sum())
        self._is_classifier = p.boost_type in (BOOST_DAB, BOOST_RAB)
        self._cls = labels.astype(np.int32)
        self._valid = valid
        t0 = time.time()
        cache = FeatureCache(
            self.ev, self.categorical,
            val_buf_mb=self.val_buf_mb, idx_buf_mb=self.idx_buf_mb,
            mesh=self.mesh,
        )
        if verbose:
            print(f"Precalculation time: {int(time.time() - t0)}")

        orig = labels.astype(np.int32) * 2 - 1  # {−1, +1}
        w = np.where(valid, 1.0 / n_real, 0.0)
        mask = valid.copy()
        if p.boost_type == BOOST_LB:
            sum_response = np.zeros(n, np.float64)
            resp = np.where(orig > 0, 2.0, -2.0)
        elif p.boost_type == BOOST_GAB:
            resp = orig.astype(np.float64)
        else:
            resp = orig.astype(np.float64)  # ±1 targets for DAB/RAB too

        if self._is_classifier:
            cache.set_stage(valid, self._cls)
        else:
            cache.set_stage(valid, resp)
        wthr = -np.inf  # trim threshold: initial subsample is all of valid

        trees = []
        stage_sums = np.zeros(n, np.float64)
        threshold = 0.0
        num_pos = int(((labels == 1) & valid).sum())
        num_neg = n_real - num_pos

        if verbose:
            print("+----+---------+---------+")
            print("|  N |    HR   |    FA   |")
            print("+----+---------+---------+")

        while True:
            tree, preds = self._train_tree(cache, w, resp, mask, wthr)
            if tree is None:
                break

            # update_weights(tree) — boost.cpp:267-407
            if p.boost_type == BOOST_DAB:
                # boost.cpp:284-317: err = Σw·(f≠y)/Σw, C = −logRatio(err),
                # w *= exp(C) where wrong, then the tree is scaled by C
                sw = w.sum()
                wrong = preds != orig
                err = float(np.sum(w * wrong)) / max(sw, 1e-300)
                c = -_log_ratio(err)
                w = w * np.where(wrong, math.exp(c), 1.0)
                tree.leaf_values = (tree.leaf_values * np.float32(c)).astype(
                    np.float32
                )
                preds = preds * c
            elif p.boost_type == BOOST_RAB:
                w = w * np.exp(-orig * preds)
            elif p.boost_type == BOOST_LB:
                sum_response = sum_response + 0.5 * preds
                prob = 1.0 / (1.0 + np.exp(-2.0 * sum_response))
                w = np.maximum(prob * (1.0 - prob), float(LB_WEIGHT_THRESH))
                z = np.where(
                    orig > 0,
                    np.minimum(1.0 / np.maximum(prob, 1e-300), LB_Z_MAX),
                    -np.minimum(1.0 / np.maximum(1.0 - prob, 1e-300), LB_Z_MAX),
                )
                resp = z
            else:  # GENTLE
                w = w * np.exp(-orig * preds)

            sw = w.sum()
            if sw > float(FLT_EPSILON):
                w = w / sw

            # trim_weights (o_cvboost.cpp:101-139); the reference sorts all
            # sample weights — padding has weight 0 and sits at the front of
            # the sorted array without consuming trim budget
            if 0.0 < p.weight_trim_rate < 1.0:
                ws = np.sort(w[valid])
                csum = np.concatenate([[0.0], np.cumsum(ws)])
                i = int(np.searchsorted(csum[1:], 1.0 - p.weight_trim_rate))
                thr_w = ws[i] if i < n_real else np.inf
                mask = valid & (w >= thr_w)
                wthr = thr_w
            trees.append(tree)
            stage_sums = stage_sums + preds

            # isErrDesired (boost.cpp:479-518)
            pos_sums = np.sort(stage_sums[(labels == 1) & valid])
            t_idx = int((1.0 - p.min_hit_rate) * num_pos)
            threshold = float(pos_sums[t_idx])
            num_pos_true = num_pos - t_idx
            for i in range(t_idx - 1, -1, -1):
                if abs(pos_sums[i] - threshold) < float(FLT_EPSILON):
                    num_pos_true += 1
            hit_rate = num_pos_true / max(num_pos, 1)
            neg_sums = stage_sums[(labels == 0) & valid]
            accepted = neg_sums >= threshold - CV_THRESHOLD_EPS
            false_alarm = (
                float(accepted.sum()) / num_neg if num_neg else 0.0
            )
            if verbose:
                print(
                    f"|{len(trees):>4}|{hit_rate:>9.6g}|{false_alarm:>9.6g}|"
                )
                print("+----+---------+---------+")

            if not mask.any():
                break
            if false_alarm <= p.max_false_alarm:
                break
            if len(trees) >= p.weak_count:
                break

        if not trees:
            return None, None
        return Stage(threshold=threshold, trees=trees), stage_sums
