"""Dense (gather-free) cascade evaluation over the pyramid canvas.

Every rectangle sum is computed for *all* window positions at once as a
combination of four statically-shifted 2D slices of the canvas integral
image — plain elementwise arithmetic that XLA fuses into one pass per
stage. A window at scaled coords (x, y) of level s lives at canvas
position (block_top[s] + y, x), so one shifted slice serves every pyramid
level simultaneously.

This is the dense replacement for the reference's per-window early-exit
loop (SURVEY §3.2): stages are evaluated densely under a survivor mask;
the mask does not reduce dense work (the survivor tail of
detect/compact.py does), but it keeps the math identical to the OpenCV
runtime.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from cascadeclassifier_tpu.ops.features import lbp_code_grid


def dense_rect_sum(c2d, rx, ry, w, h, out_h, out_w):
    """Rect sum at every canvas position: 4 shifted slices (CV_SUM_OFFSETS)."""
    return (
        c2d[ry : ry + out_h, rx : rx + out_w]
        - c2d[ry : ry + out_h, rx + w : rx + w + out_w]
        - c2d[ry + h : ry + h + out_h, rx : rx + out_w]
        + c2d[ry + h : ry + h + out_h, rx + w : rx + w + out_w]
    )


def dense_tilted_rect_sum(t2d, rx, ry, w, h, out_h, out_w):
    """Tilted rect sum (CV_TILTED_OFFSETS corner geometry) at every position.

    Corners: p0=(x, y), p1=(x−h, y+h), p2=(x+w, y+w), p3=(x+w−h, y+w+h);
    rectsum = p0 − p1 − p2 + p3. The Haar generator's constraints
    (haarfeatures.cpp:204-244: x−dy ≥ 0 etc.) guarantee every corner stays
    inside the window, so all slice offsets are non-negative and in range."""
    assert rx - h >= 0, "tilted rect escapes window"

    def sl(dy, dx):
        return t2d[dy : dy + out_h, dx : dx + out_w]

    return (
        sl(ry, rx)
        - sl(ry + h, rx - h)
        - sl(ry + w, rx + w)
        + sl(ry + w + h, rx + w - h)
    )


def dense_variance_gate(sum2d, sq2d, win_w, win_h, out_h, out_w):
    """OpenCV HaarEvaluator::setWindow gate at every position.

    Returns (gate_ok bool, inv_nf f32), both (out_h, out_w)."""
    rw, rh = win_w - 2, win_h - 2
    area = rw * rh
    with jax.enable_x64(True):
        vs = dense_rect_sum(sum2d, 1, 1, rw, rh, out_h, out_w).astype(jnp.int64)
        vq = dense_rect_sum(sq2d, 1, 1, rw, rh, out_h, out_w)
        nf2 = jnp.int64(area) * vq - vs * vs
        pos = nf2 > 0
        nf = jnp.sqrt(jnp.where(pos, nf2, 1).astype(jnp.float64))
        inv_nf = (1.0 / nf).astype(jnp.float32)
        ok = pos & ((float(area) * inv_nf.astype(jnp.float64)) < 1e-1)
    return ok, jnp.where(ok, inv_nf, jnp.float32(1.0))


def dense_stage_haar(sum2d, tilt2d, stage, out_h, out_w, inv_nf, exact=True):
    """Σ leaves over one stage's stump trees at every position.

    exact=True accumulates the stage sum in float64 like the OpenCV runtime
    (bit-level parity); exact=False accumulates in float32 (identical
    results except windows within ~1e-6 of a stage threshold)."""
    acc_dt = jnp.float64 if exact else jnp.float32

    def body():
        acc = jnp.zeros((out_h, out_w), acc_dt)
        for i in range(stage.ntrees):
            raw = None
            for r in range(3):
                wt = float(stage.weights[i, r])
                if wt == 0.0:
                    continue
                rx, ry, w, h = (int(v) for v in stage.feat_rects[i, r])
                if stage.tilted[i]:
                    term = dense_tilted_rect_sum(
                        tilt2d, rx, ry, w, h, out_h, out_w
                    ).astype(jnp.float32) * np.float32(wt)
                else:
                    term = dense_rect_sum(
                        sum2d, rx, ry, w, h, out_h, out_w
                    ).astype(jnp.float32) * np.float32(wt)
                raw = term if raw is None else raw + term
            val = raw * inv_nf
            leaf = jnp.where(
                val < np.float32(stage.thr[i]),
                acc_dt(stage.left_leaf[i]),
                acc_dt(stage.right_leaf[i]),
            )
            acc = acc + leaf
        return acc

    if exact:
        with jax.enable_x64(True):
            return body()
    return body()


def dense_stage_lbp(sum2d, stage, out_h, out_w, exact=True):
    """Σ leaves over one stage's categorical (LBP) stumps."""
    acc_dt = jnp.float64 if exact else jnp.float32

    def body():
        acc = jnp.zeros((out_h, out_w), acc_dt)
        for i in range(stage.ntrees):
            x, y, w, h = (int(v) for v in stage.lbp_rects[i])

            def cs(cx, cy):
                return dense_rect_sum(sum2d, cx, cy, w, h, out_h, out_w)

            code = lbp_code_grid(
                [
                    [cs(x + c * w, y + r * h) for c in range(3)]
                    for r in range(3)
                ]
            )
            # subset bit test without gathers: 8 predicated word selects
            word = jnp.zeros_like(code)
            wsel = code >> 5
            for wi in range(8):
                word = jnp.where(wsel == wi, int(stage.subsets[i, wi]), word)
            bit = (word >> (code & 31)) & 1
            acc = acc + jnp.where(
                bit != 0,
                acc_dt(stage.left_leaf[i]),
                acc_dt(stage.right_leaf[i]),
            )
        return acc

    if exact:
        with jax.enable_x64(True):
            return body()
    return body()


def dense_walk_visited(m0, row_is_grid, row_step2, row_maxc):
    """OpenCV's serial x-walk on the dense canvas grid.

    m0          : (H, W) bool — gate-passed & stage0-failed (skip triggers)
    row_is_grid : (H,) bool — canvas rows that are window grid rows
    row_step2   : (H,) bool — rows whose level has ystep == 2
    row_maxc    : (H,) int32 — last valid window column of the row's level
    returns visited (H, W) bool."""
    h, w = m0.shape
    col_ids = jnp.arange(w, dtype=jnp.int32)

    def step(skip, c):
        on = (
            row_is_grid
            & (c <= row_maxc)
            & ((~row_step2) | ((c & 1) == 0))
        )
        visited_c = on & (~skip)
        new_skip = jnp.where(on, visited_c & m0[:, c], skip)
        return new_skip, visited_c

    _, cols = jax.lax.scan(step, jnp.zeros(h, bool), col_ids)
    return cols.T


def _dense_node_value_haar(sum2d, tilt2d, feat, out_h, out_w, inv_nf):
    """Normalized Haar response of one feature at every position → f32."""
    raw = None
    for (rx, ry, w, h, wt) in feat.rects:
        if feat.tilted:
            term = dense_tilted_rect_sum(
                tilt2d, rx, ry, w, h, out_h, out_w
            ).astype(jnp.float32) * np.float32(wt)
        else:
            term = dense_rect_sum(
                sum2d, rx, ry, w, h, out_h, out_w
            ).astype(jnp.float32) * np.float32(wt)
        raw = term if raw is None else raw + term
    return raw * inv_nf


def _dense_lbp_code(sum2d, rect, out_h, out_w):
    """LBP code of one feature at every position → int32."""
    x, y, w, h = rect

    def cs(cx, cy):
        return dense_rect_sum(sum2d, cx, cy, w, h, out_h, out_w)

    return lbp_code_grid(
        [[cs(x + c * w, y + r * h) for c in range(3)] for r in range(3)]
    )


def dense_stage_deep(
    sum2d, tilt2d, stage, out_h, out_w, inv_nf, is_haar, exact=True
):
    """Stage sum for trees with >1 internal node: each position walks its
    own path, realized as dense per-node evaluations combined with masked
    selects (predictOrdered / predictCategorical semantics)."""
    acc_dt = jnp.float64 if exact else jnp.float32

    def subset_bit(code, subsets):
        word = jnp.zeros_like(code)
        wsel = code >> 5
        for wi in range(8):
            word = jnp.where(wsel == wi, int(subsets[wi]), word)
        return ((word >> (code & 31)) & 1) != 0

    def body():
        acc = jnp.zeros((out_h, out_w), acc_dt)
        for tree, feats in stage.deep_trees:

            def eval_node(ni):
                f = feats[ni]
                if is_haar:
                    val = _dense_node_value_haar(
                        sum2d, tilt2d, f, out_h, out_w, inv_nf
                    )
                    go_left = val < np.float32(tree.threshold[ni])
                else:
                    code = _dense_lbp_code(sum2d, f.rect, out_h, out_w)
                    go_left = subset_bit(code, tree.subsets[ni])

                def child(c):
                    if c <= 0:
                        return jnp.full(
                            (out_h, out_w), acc_dt(tree.leaf_values[-c])
                        )
                    return eval_node(int(c))

                return jnp.where(
                    go_left, child(int(tree.left[ni])),
                    child(int(tree.right[ni])),
                )

            acc = acc + eval_node(0)
        return acc

    if exact:
        with jax.enable_x64(True):
            return body()
    return body()


def canvas_tilted(px, is_top, pad):
    """Tilted (45°) integral of every pyramid block in the pixel canvas.

    px     : (H, W) int32 canvas pixels (zero rows at block tops, zero
             first column, zeros right of each block's width)
    is_top : (H,) bool block zero rows
    pad    : int ≥ max block height + 1 — boundary errors of the interior
             recurrence propagate inward one column per row, so padding
             by the block height keeps the cropped region exact (the same
             argument as ops/integral._tilted_2d, validated vs cv2)

    Returns (H, W) int32 — per block, the same layout as cv2.integral3's
    tilted output with row stride W. The recurrence carries reset at block
    tops so levels never leak into each other."""
    h, w = px.shape
    img = px[:, 1:]  # drop the leading zero column; pixel j at col j
    imgp = jnp.pad(img, ((0, 0), (pad, pad)))
    wp = (w - 1) + 2 * pad
    # rows shifted right by one (the img[Y-1, X-1] term)
    rows = jnp.pad(imgp, ((0, 0), (1, 0)))[:, : wp + 1]
    zero_row = jnp.zeros((wp + 1,), jnp.int32)
    prev_rows = jnp.concatenate([zero_row[None], rows[:-1]], axis=0)
    # img[Y-2, X-1] must not leak across blocks: zero it when row Y-1 is a
    # block top (the only case where Y-2 belongs to the previous block and
    # is nonzero)
    m2 = jnp.concatenate(
        [jnp.zeros((1,), bool), is_top[:-1]], axis=0
    )  # True where row Y-1 is a top row

    def step(carry, xs):
        t1, t2 = carry
        r1, r2, top, mask2 = xs
        left = jnp.pad(t1[:-1], (1, 0))
        right = jnp.pad(t1[1:], (0, 1))
        t = left + right - t2 + r1 + jnp.where(mask2, 0, r2)
        t = jnp.where(top, 0, t)
        t1n = t
        t2n = jnp.where(top, 0, t1)
        return (t1n, t2n), t

    (_, _), body = jax.lax.scan(
        step, (zero_row, zero_row), (rows, prev_rows, is_top, m2)
    )
    return body[:, pad : pad + w]
