"""Feature catalogs (Haar / LBP / HOG) and vectorized batch evaluators.

Catalogs are generated as numpy structure-of-arrays in **exactly the
enumeration order of the reference generators** (variable indices stored in
cascade XML index into this order):

  - Haar : reference traincascade/lib/src/haarfeatures.cpp:127-251
  - LBP  : reference traincascade/lib/src/lbpfeatures.cpp:35-45
  - HOG  : reference traincascade/lib/src/HOGfeatures.cpp:67-106

Evaluators are pure JAX functions over batches of flattened per-sample
integral images — the batched replacement for the reference's
one-(feature, sample)-at-a-time ``CvFeatureEvaluator::operator()``
(traincascade_features.h:155-188). A feature response for a whole batch is a
handful of gathers along the flat pixel axis plus elementwise math, so the
trainer evaluates *all samples × a block of features* per XLA op.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from cascadeclassifier_tpu.ops.integral import normalized_response

HAAR_BASIC, HAAR_CORE, HAAR_ALL = 0, 1, 2
_HAAR_MODE_NAMES = {"BASIC": HAAR_BASIC, "CORE": HAAR_CORE, "ALL": HAAR_ALL}


def haar_mode_id(mode) -> int:
    if isinstance(mode, str):
        return _HAAR_MODE_NAMES[mode.upper()]
    return int(mode)


def sum_offsets(x, y, w, h, stride):
    """Corner offsets of an upright rect in a flattened integral image.

    Mirrors CV_SUM_OFFSETS (traincascade_features.h:41-50):
      p0=(x,y) p1=(x+w,y) p2=(x,y+h) p3=(x+w,y+h); rectsum = S[p0]-S[p1]-S[p2]+S[p3].
    """
    p0 = x + stride * y
    p1 = x + w + stride * y
    p2 = x + stride * (y + h)
    p3 = x + w + stride * (y + h)
    return p0, p1, p2, p3


def tilted_offsets(x, y, w, h, stride):
    """Corner offsets of a 45°-tilted rect in a flattened tilted integral.

    Mirrors CV_TILTED_OFFSETS (traincascade_features.h:54-63).
    """
    p0 = x + stride * y
    p1 = x - h + stride * (y + h)
    p2 = x + w + stride * (y + w)
    p3 = x + w - h + stride * (y + w + h)
    return p0, p1, p2, p3


# --------------------------------------------------------------------------
# Haar
# --------------------------------------------------------------------------


@dataclasses.dataclass
class HaarCatalog:
    """All Haar features for a window, in reference enumeration order.

    rects   : (F, 3, 4) int32 — (x, y, w, h); zero-size for unused slots
    weights : (F, 3) float32  — 0.0 for unused slots
    tilted  : (F,) bool
    win_w, win_h : window size the catalog was generated for
    mode    : HAAR_BASIC / HAAR_CORE / HAAR_ALL
    """

    rects: np.ndarray
    weights: np.ndarray
    tilted: np.ndarray
    win_w: int
    win_h: int
    mode: int

    def __len__(self):
        return self.rects.shape[0]

    def corner_offsets(self) -> np.ndarray:
        """(F, 3, 4) int32 flat offsets into (win_h+1)*(win_w+1) rows."""
        stride = self.win_w + 1
        x, y = self.rects[:, :, 0], self.rects[:, :, 1]
        w, h = self.rects[:, :, 2], self.rects[:, :, 3]
        up = np.stack(sum_offsets(x, y, w, h, stride), axis=-1)
        ti = np.stack(tilted_offsets(x, y, w, h, stride), axis=-1)
        out = np.where(self.tilted[:, None, None], ti, up).astype(np.int32)
        # unused slots (w==0) could produce negative offsets for tilted rects;
        # clamp to 0 — their weight is 0 so the gathered value is ignored.
        return np.clip(out, 0, None)


def haar_catalog(win_w: int, win_h: int, mode=HAAR_BASIC) -> HaarCatalog:
    """Enumerate Haar features exactly as haarfeatures.cpp:127-251.

    Loop order is x, y, dx, dy (dx/dy from 1), and for each combination the
    applicable templates are appended in the fixed order
    x2, y2, x3, y3, [x4, y4], x2_y2, [center3x3], [6 tilted kinds].
    The implementation is vectorized: each template contributes the set of
    valid (x, y, dx, dy) tuples; a lexicographic (x, y, dx, dy, template)
    sort key then reproduces the exact append order.
    """
    mode = haar_mode_id(mode)
    W, H = win_w, win_h
    x = np.arange(W, dtype=np.int64)[:, None, None, None]
    y = np.arange(H, dtype=np.int64)[None, :, None, None]
    dx = np.arange(1, W + 1, dtype=np.int64)[None, None, :, None]
    dy = np.arange(1, H + 1, dtype=np.int64)[None, None, None, :]

    # template table: (rank, condition, tilted, rect-builder)
    # each builder returns (rects(3,4), weights(3)) as numpy expressions over
    # the selected x/y/dx/dy vectors.
    entries = []  # (key, rects(n,3,4), weights(3), tilted)

    def emit(rank, cond, tilted_flag, build):
        idx = np.nonzero(np.broadcast_to(cond, (W, H, W, H)))
        if idx[0].size == 0:
            return
        xs, ys = x.ravel()[idx[0]], y.ravel()[idx[1]]
        dxs, dys = dx.ravel()[idx[2]], dy.ravel()[idx[3]]
        rects, weights = build(xs, ys, dxs, dys)
        key = (((xs * H + ys) * W + (dxs - 1)) * H + (dys - 1)) * 32 + rank
        entries.append((key, rects, weights, tilted_flag))

    def R(*rect_weight_pairs):
        """Build (n,3,4) rects + (3,) weights from up to 3 (x,y,w,h,wt)."""

        def build(n, pairs):
            rects = np.zeros((n, 3, 4), np.int32)
            weights = np.zeros((3,), np.float32)
            for i, (rx, ry, rw, rh, wt) in enumerate(pairs):
                rects[:, i, 0] = rx
                rects[:, i, 1] = ry
                rects[:, i, 2] = rw
                rects[:, i, 3] = rh
                weights[i] = wt
            return rects, weights

        return build, rect_weight_pairs

    rank = 0

    def add(cond, tilted_flag, make_pairs):
        nonlocal rank
        r = rank
        rank += 1

        def build(xs, ys, dxs, dys):
            pairs = make_pairs(xs, ys, dxs, dys)
            n = xs.shape[0]
            rects = np.zeros((n, 3, 4), np.int32)
            weights = np.zeros((3,), np.float32)
            for i, (rx, ry, rw, rh, wt) in enumerate(pairs):
                rects[:, i, 0] = rx
                rects[:, i, 1] = ry
                rects[:, i, 2] = rw
                rects[:, i, 3] = rh
                weights[i] = wt
            return rects, weights

        emit(r, cond, tilted_flag, build)

    # haar_x2
    add(
        (x + dx * 2 <= W) & (y + dy <= H),
        False,
        lambda xs, ys, dxs, dys: [
            (xs, ys, dxs * 2, dys, -1.0),
            (xs + dxs, ys, dxs, dys, +2.0),
        ],
    )
    # haar_y2
    add(
        (x + dx <= W) & (y + dy * 2 <= H),
        False,
        lambda xs, ys, dxs, dys: [
            (xs, ys, dxs, dys * 2, -1.0),
            (xs, ys + dys, dxs, dys, +2.0),
        ],
    )
    # haar_x3
    add(
        (x + dx * 3 <= W) & (y + dy <= H),
        False,
        lambda xs, ys, dxs, dys: [
            (xs, ys, dxs * 3, dys, -1.0),
            (xs + dxs, ys, dxs, dys, +2.0),
        ],
    )
    # haar_y3
    add(
        (x + dx <= W) & (y + dy * 3 <= H),
        False,
        lambda xs, ys, dxs, dys: [
            (xs, ys, dxs, dys * 3, -1.0),
            (xs, ys + dys, dxs, dys, +2.0),
        ],
    )
    if mode != HAAR_BASIC:
        # haar_x4
        add(
            (x + dx * 4 <= W) & (y + dy <= H),
            False,
            lambda xs, ys, dxs, dys: [
                (xs, ys, dxs * 4, dys, -1.0),
                (xs + dxs, ys, dxs * 2, dys, +2.0),
            ],
        )
        # haar_y4
        add(
            (x + dx <= W) & (y + dy * 4 <= H),
            False,
            lambda xs, ys, dxs, dys: [
                (xs, ys, dxs, dys * 4, -1.0),
                (xs, ys + dys, dxs, dys * 2, +2.0),
            ],
        )
    # x2_y2 (checkerboard)
    add(
        (x + dx * 2 <= W) & (y + dy * 2 <= H),
        False,
        lambda xs, ys, dxs, dys: [
            (xs, ys, dxs * 2, dys * 2, -1.0),
            (xs, ys, dxs, dys, +2.0),
            (xs + dxs, ys + dys, dxs, dys, +2.0),
        ],
    )
    if mode != HAAR_BASIC:
        # 3x3 center-surround
        add(
            (x + dx * 3 <= W) & (y + dy * 3 <= H),
            False,
            lambda xs, ys, dxs, dys: [
                (xs, ys, dxs * 3, dys * 3, -1.0),
                (xs + dxs, ys + dys, dxs, dys, +9.0),
            ],
        )
    if mode == HAAR_ALL:
        # tilted haar_x2
        add(
            (x + 2 * dx <= W) & (y + 2 * dx + dy <= H) & (x - dy >= 0),
            True,
            lambda xs, ys, dxs, dys: [
                (xs, ys, dxs * 2, dys, -1.0),
                (xs, ys, dxs, dys, +2.0),
            ],
        )
        # tilted haar_y2
        add(
            (x + dx <= W) & (y + dx + 2 * dy <= H) & (x - 2 * dy >= 0),
            True,
            lambda xs, ys, dxs, dys: [
                (xs, ys, dxs, 2 * dys, -1.0),
                (xs, ys, dxs, dys, +2.0),
            ],
        )
        # tilted haar_x3
        add(
            (x + 3 * dx <= W) & (y + 3 * dx + dy <= H) & (x - dy >= 0),
            True,
            lambda xs, ys, dxs, dys: [
                (xs, ys, dxs * 3, dys, -1.0),
                (xs + dxs, ys + dxs, dxs, dys, +3.0),
            ],
        )
        # tilted haar_y3
        add(
            (x + dx <= W) & (y + dx + 3 * dy <= H) & (x - 3 * dy >= 0),
            True,
            lambda xs, ys, dxs, dys: [
                (xs, ys, dxs, 3 * dys, -1.0),
                (xs - dys, ys + dys, dxs, dys, +3.0),
            ],
        )
        # tilted haar_x4
        add(
            (x + 4 * dx <= W) & (y + 4 * dx + dy <= H) & (x - dy >= 0),
            True,
            lambda xs, ys, dxs, dys: [
                (xs, ys, dxs * 4, dys, -1.0),
                (xs + dxs, ys + dxs, dxs * 2, dys, +2.0),
            ],
        )
        # tilted haar_y4
        add(
            (x + dx <= W) & (y + dx + 4 * dy <= H) & (x - 4 * dy >= 0),
            True,
            lambda xs, ys, dxs, dys: [
                (xs, ys, dxs, 4 * dys, -1.0),
                (xs - dys, ys + dys, dxs, 2 * dys, +2.0),
            ],
        )

    keys = np.concatenate([e[0] for e in entries])
    rects = np.concatenate(
        [e[1] for e in entries], axis=0, dtype=np.int32, casting="unsafe"
    )
    weights = np.concatenate(
        [np.broadcast_to(e[2], (e[1].shape[0], 3)) for e in entries], axis=0
    ).astype(np.float32)
    tilted = np.concatenate(
        [np.full((e[1].shape[0],), e[3], bool) for e in entries]
    )
    order = np.argsort(keys, kind="stable")
    return HaarCatalog(
        rects=rects[order],
        weights=weights[order],
        tilted=tilted[order],
        win_w=win_w,
        win_h=win_h,
        mode=mode,
    )


def eval_haar(
    sum_flat: jax.Array,
    tilted_flat: jax.Array | None,
    normfactor: jax.Array,
    offsets: jax.Array,
    weights: jax.Array,
    tilted_mask: jax.Array | None,
) -> jax.Array:
    """Haar responses for a batch of samples × a block of features.

    sum_flat    : (N, P) int32 flattened integral rows (P=(h+1)*(w+1))
    tilted_flat : (N, P) int32 or None when the block has no tilted features
    normfactor  : (N,) float32 per-sample normalization
    offsets     : (F, 3, 4) int32 corner offsets
    weights     : (F, 3) float32
    tilted_mask : (F,) bool or None
    returns     : (N, F) float32 — matches CvHaarEvaluator::operator()
                  (haarfeatures.h:108-122): Σ w_r·rectsum_r / nf, 0 if nf==0.
    """
    flat_idx = offsets.reshape(-1)  # (F*12,)

    def rectsums(img_flat):
        g = jnp.take(img_flat, flat_idx, axis=1)  # (N, F*12)
        g = g.reshape(img_flat.shape[0], offsets.shape[0], 3, 4)
        return (
            g[..., 0] - g[..., 1] - g[..., 2] + g[..., 3]
        )  # (N, F, 3) int32

    if tilted_flat is None or tilted_mask is None:
        rs = rectsums(sum_flat)
    else:
        rs_up = rectsums(sum_flat)
        rs_ti = rectsums(tilted_flat)
        rs = jnp.where(tilted_mask[None, :, None], rs_ti, rs_up)

    # HIGHEST: a default-precision f32 contraction may run in TF32 (or
    # bf16 passes) on an accelerator, which drops rect-sum bits
    resp = jnp.einsum(
        "nfr,fr->nf", rs.astype(jnp.float32), weights,
        precision=jax.lax.Precision.HIGHEST,
    )
    return normalized_response(resp, normfactor[:, None])


# --------------------------------------------------------------------------
# LBP
# --------------------------------------------------------------------------


@dataclasses.dataclass
class LBPCatalog:
    """LBP features: rect (x, y, cell_w, cell_h) of the top-left cell of a
    3×3 grid, in reference order (lbpfeatures.cpp:35-45)."""

    rects: np.ndarray  # (F, 4) int32
    win_w: int
    win_h: int

    def __len__(self):
        return self.rects.shape[0]

    def cell_offsets(self) -> np.ndarray:
        """(F, 16) int32 — the 16 grid-corner offsets p[0..15], matching the
        layout of CvLBPEvaluator::Feature (lbpfeatures.cpp:53-63): a 4×4 grid
        of integral-image corners at x + {0,w,2w,3w}, y + {0,h,2h,3h},
        flattened row-major."""
        stride = self.win_w + 1
        x, y = self.rects[:, 0], self.rects[:, 1]
        w, h = self.rects[:, 2], self.rects[:, 3]
        cols = np.stack([x, x + w, x + 2 * w, x + 3 * w], axis=1)  # (F,4)
        rows = np.stack([y, y + h, y + 2 * h, y + 3 * h], axis=1)  # (F,4)
        return (
            cols[:, None, :] + stride * rows[:, :, None]
        ).reshape(-1, 16).astype(np.int32)


def lbp_catalog(win_w: int, win_h: int) -> LBPCatalog:
    """Enumerate LBP features exactly as lbpfeatures.cpp:35-45."""
    W, H = win_w, win_h
    x = np.arange(W, dtype=np.int64)[:, None, None, None]
    y = np.arange(H, dtype=np.int64)[None, :, None, None]
    w = np.arange(1, W // 3 + 1, dtype=np.int64)[None, None, :, None]
    h = np.arange(1, H // 3 + 1, dtype=np.int64)[None, None, None, :]
    cond = (x + 3 * w <= W) & (y + 3 * h <= H)
    idx = np.nonzero(cond)  # C-order = loop order x, y, w, h ✓
    rects = np.stack(
        [
            x.ravel()[idx[0]],
            y.ravel()[idx[1]],
            w.ravel()[idx[2]],
            h.ravel()[idx[3]],
        ],
        axis=1,
    ).astype(np.int32)
    return LBPCatalog(rects=rects, win_w=win_w, win_h=win_h)


def lbp_code_grid(cs):
    """3×3 grid of cell-sum arrays (row-major, any uniform shape) → LBP
    code array. Bit layout matches CvLBPEvaluator::Feature::calc
    (lbpfeatures.h:70-83): 128=TL, then clockwise around the center.

    cs: indexable as cs[r][c] — nested sequences or an array whose first
    two axes are (row, col)."""
    cval = cs[1][1]
    code = None
    for r, c, bit in (
        (0, 0, 128), (0, 1, 64), (0, 2, 32), (1, 2, 16),
        (2, 2, 8), (2, 1, 4), (2, 0, 2), (1, 0, 1),
    ):
        t = jnp.where(cs[r][c] >= cval, bit, 0)
        code = t if code is None else code | t
    return code


def eval_lbp(sum_flat: jax.Array, p: jax.Array) -> jax.Array:
    """LBP codes for a batch of samples × a block of features.

    sum_flat : (N, P) int32 flattened integral rows
    p        : (F, 16) int32 grid corner offsets
    returns  : (N, F) int32 codes in [0, 255] — bit layout matches
               CvLBPEvaluator::Feature::calc (lbpfeatures.h:70-83).
    """
    g = jnp.take(sum_flat, p.reshape(-1), axis=1).reshape(
        sum_flat.shape[0], p.shape[0], 16
    )

    def cell(i0, i1, i2, i3):
        return g[..., i0] - g[..., i1] - g[..., i2] + g[..., i3]

    cval = cell(5, 6, 9, 10)
    bits = (
        jnp.where(cell(0, 1, 4, 5) >= cval, 128, 0)
        | jnp.where(cell(1, 2, 5, 6) >= cval, 64, 0)
        | jnp.where(cell(2, 3, 6, 7) >= cval, 32, 0)
        | jnp.where(cell(6, 7, 10, 11) >= cval, 16, 0)
        | jnp.where(cell(10, 11, 14, 15) >= cval, 8, 0)
        | jnp.where(cell(9, 10, 13, 14) >= cval, 4, 0)
        | jnp.where(cell(8, 9, 12, 13) >= cval, 2, 0)
        | jnp.where(cell(4, 5, 8, 9) >= cval, 1, 0)
    )
    return bits.astype(jnp.int32)


# --------------------------------------------------------------------------
# HOG
# --------------------------------------------------------------------------

N_BINS = 9
N_CELLS = 4
HOG_FEAT_SIZE = N_BINS * N_CELLS  # 36


@dataclasses.dataclass
class HOGCatalog:
    """HOG block features: 2×2 cell grids (HOGfeatures.cpp:67-106).

    rects holds (x, y, cell_w, cell_h) of cell 0; the full block is
    (x, y, 2·cell_w, 2·cell_h). Each feature contributes 36 boosting
    variables (var = featureIdx·36 + cellIdx·9 + binIdx)."""

    rects: np.ndarray  # (F, 4) int32
    win_w: int
    win_h: int

    def __len__(self):
        return self.rects.shape[0]

    @property
    def var_count(self):
        return self.rects.shape[0] * HOG_FEAT_SIZE

    def cell_corner_offsets(self) -> np.ndarray:
        """(F, 4cells, 4corners) int32 offsets into flattened (h+1)(w+1)."""
        stride = self.win_w + 1
        x, y = self.rects[:, 0], self.rects[:, 1]
        w, h = self.rects[:, 2], self.rects[:, 3]
        cells = [
            (x, y),
            (x + w, y),
            (x, y + h),
            (x + w, y + h),
        ]
        out = np.stack(
            [
                np.stack(sum_offsets(cx, cy, w, h, stride), axis=-1)
                for (cx, cy) in cells
            ],
            axis=1,
        )
        return out.astype(np.int32)


def hog_catalog(win_w: int, win_h: int) -> HOGCatalog:
    """Enumerate HOG features exactly as HOGfeatures.cpp:67-106."""
    W, H = win_w, win_h
    rects = []
    t = 8
    while t <= W // 2:  # cell size
        for bw, bh, cw, ch in (
            (2 * t, 2 * t, t, t),
            (2 * t, 4 * t, t, 2 * t),
            (4 * t, 2 * t, 2 * t, t),
        ):
            for xx in range(0, W - bw + 1, 4):
                for yy in range(0, H - bh + 1, 4):
                    rects.append((xx, yy, cw, ch))
        t += 8
    arr = (
        np.array(rects, np.int32).reshape(-1, 4)
        if rects
        else np.zeros((0, 4), np.int32)
    )
    return HOGCatalog(rects=arr, win_w=win_w, win_h=win_h)


def hog_integral_histogram(img: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Per-sample HOG integral histograms + norm integral.

    Mirrors CvHOGEvaluator::integralHistogram (HOGfeatures.cpp:163-256):
    central-difference gradients with replicated borders, full-range
    atan2 orientation hard-assigned to ``floor(angle·9/π − 0.5) mod 9``,
    per-bin integral images of gradient magnitude, plus an integral image
    of total magnitude for block L1 normalization.

    img : (N, H, W) uint8
    returns (hist, norm): hist (N, 9, H+1, W+1) f32, norm (N, H+1, W+1) f32
    """
    x = img.astype(jnp.float32)
    # BORDER_REPLICATE central differences
    dx = jnp.pad(x, ((0, 0), (0, 0), (1, 1)), mode="edge")
    dy = jnp.pad(x, ((0, 0), (1, 1), (0, 0)), mode="edge")
    gx = dx[:, :, 2:] - dx[:, :, :-2]
    gy = dy[:, 2:, :] - dy[:, :-2, :]
    mag = jnp.sqrt(gx * gx + gy * gy)
    ang = jnp.arctan2(gy, gx)  # (-π, π]
    ang = jnp.where(ang < 0, ang + 2 * np.pi, ang)  # [0, 2π) like cartToPolar
    a = ang * (N_BINS / np.pi) - 0.5
    bidx = jnp.floor(a).astype(jnp.int32)
    bidx = jnp.where(bidx < 0, bidx + N_BINS, bidx)
    bidx = jnp.where(bidx >= N_BINS, bidx - N_BINS, bidx)

    onehot = (
        bidx[:, None, :, :] == jnp.arange(N_BINS)[None, :, None, None]
    ).astype(jnp.float32)
    per_bin = onehot * mag[:, None, :, :]  # (N, 9, H, W)

    def ii_f32(v):
        s = jnp.cumsum(jnp.cumsum(v, axis=-1), axis=-2)
        pad = [(0, 0)] * (v.ndim - 2) + [(1, 0), (1, 0)]
        return jnp.pad(s, pad)

    hist = ii_f32(per_bin)
    norm = ii_f32(mag)
    return hist, norm


def eval_hog(
    hist_flat: jax.Array, norm_flat: jax.Array, cell_offsets: jax.Array
) -> jax.Array:
    """HOG responses for a batch × block of features (all 36 components).

    hist_flat    : (N, 9, P) f32 flattened per-bin integral histograms
    norm_flat    : (N, P) f32 flattened norm integral
    cell_offsets : (F, 4, 4) int32
    returns      : (N, F*36) f32 in var order (cell-major then bin), i.e.
                   var = f*36 + cell*9 + bin — matches
                   CvHOGEvaluator::operator() (HOGfeatures.h:84-108).
    """
    n, _, _ = hist_flat.shape
    f = cell_offsets.shape[0]
    flat = cell_offsets.reshape(-1)  # (F*16,)
    g = jnp.take(hist_flat, flat, axis=2).reshape(n, N_BINS, f, 4, 4)
    cellsum = g[..., 0] - g[..., 1] - g[..., 2] + g[..., 3]  # (N, 9, F, 4)

    gn = jnp.take(norm_flat, flat, axis=1).reshape(n, f, 4, 4)
    # reference norm uses p0 of cell0, p1 of cell1, p2 of cell2, p3 of cell3
    # (HOGfeatures.h:104) = the corner offsets of the whole 2×2 block.
    normf = (
        gn[:, :, 0, 0] - gn[:, :, 1, 1] - gn[:, :, 2, 2] + gn[:, :, 3, 3]
    )  # (N, F)

    res = cellsum / (normf[:, None, :, None] + 1e-3)
    res = jnp.where(cellsum > 1e-3, res, 0.0)
    # reorder (N, bin, F, cell) -> (N, F, cell, bin) -> (N, F*36)
    res = jnp.transpose(res, (0, 2, 3, 1))
    return res.reshape(n, f * HOG_FEAT_SIZE)
