"""Training-side feature evaluation: all samples × all features, as matmuls.

The reference evaluates one (feature, sample) pair at a time through
``CvFeatureEvaluator::operator()`` with a budgeted value cache
(o_cvcascadeboosttraindata.cpp:484-596). This re-design evaluates a whole
feature block × sample batch in one op:

  - each Haar/LBP/HOG rectangle sum is a ±1 4-corner linear functional of
    the flattened integral image, so a block of features is a **corner
    incidence matrix** (B, P) and evaluation is a single (B, P) × (P, N)
    matmul — integral values < 2²⁴ make float32 HIGHEST-precision
    matmuls exact
  - per-feature sorted sample orders (the reference's per-feature sorted
    index columns) are computed once per stage with one batched argsort

Feature blocks bound peak memory and give the natural multi-chip sharding
axis (features across devices).
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from cascadeclassifier_tpu.ops.features import (
    HaarCatalog,
    HOGCatalog,
    LBPCatalog,
    hog_integral_histogram,
    lbp_code_grid,
)
from cascadeclassifier_tpu.ops.integral import (
    integral_image,
    integral_sq,
    integral_tilted,
    normalized_response,
    window_norm_factor,
)

_MM_PREC = jax.lax.Precision.HIGHEST


@functools.partial(jax.jit, static_argnames=("p",))
def _haar_eval_program(rows, cols, vals, sum_rows, nf, p):
    """One fused program: scatter-build corner matrix → matmul →
    normalize; one compile per block shape."""
    m = (
        jnp.zeros((rows.shape[0] // 12, p), jnp.float32)
        .at[rows, cols]
        .add(vals)
    )
    raw = jnp.dot(m, sum_rows.T, precision=_MM_PREC)
    return normalized_response(raw, nf[None, :])


def _haar_scatter_args(offsets, weights):
    b = offsets.shape[0]
    sign = np.array([1.0, -1.0, -1.0, 1.0], np.float32)
    rows = np.repeat(np.arange(b), 12)
    cols = offsets.reshape(b, 12).ravel()
    vals = (weights[:, :, None] * sign[None, None, :]).reshape(-1)
    return (
        jnp.asarray(rows),
        jnp.asarray(cols.astype(np.int32)),
        jnp.asarray(vals.astype(np.float32)),
    )


def _rect_corner_matrix(rect_offsets: np.ndarray, p: int):
    """(R, P) ±1 incidence matrix for plain rect sums, device-built."""
    r = rect_offsets.shape[0]
    sign = np.array([1.0, -1.0, -1.0, 1.0], np.float32)
    rows = np.repeat(np.arange(r), 4)
    return (
        jnp.zeros((r, p), jnp.float32)
        .at[jnp.asarray(rows), jnp.asarray(rect_offsets.ravel())]
        .add(jnp.asarray(np.tile(sign, r)))
    )


@functools.partial(jax.jit, static_argnames=("need_tilted",))
def _haar_sample_state(x, need_tilted):
    """ONE program for the whole per-batch sample state (integral rows,
    int rows, norm factors, tilted rows) instead of dozens of eager
    per-op dispatches per mining chunk."""
    s = integral_image(x)
    sq = integral_sq(x, dtype=jnp.int32)
    flat = s.reshape(s.shape[0], -1)
    tilt = None
    if need_tilted:
        t = integral_tilted(x)
        tilt = t.reshape(t.shape[0], -1).astype(jnp.float32)
    return flat.astype(jnp.float32), flat, window_norm_factor(s, sq), tilt


class HaarTrainEvaluator:
    """Evaluates Haar responses for sample batches, block by block.

    Response semantics identical to CvHaarEvaluator (haarfeatures.h:108-122):
    Σ wᵢ·rectsumᵢ / normfactor, 0 when normfactor == 0.
    """

    maxCatCount = 0
    featSize = 1

    def __init__(self, catalog: HaarCatalog, block_size: int = 32768):
        self.catalog = catalog
        self.block_size = block_size
        self.win_w, self.win_h = catalog.win_w, catalog.win_h
        self.p = (catalog.win_w + 1) * (catalog.win_h + 1)
        self.need_tilted = bool(catalog.tilted.any())
        self._offsets = catalog.corner_offsets()
        self._weights = catalog.weights
        self._tilted = catalog.tilted
        self.num_features = len(catalog)
        self.var_count = self.num_features

    def set_samples(self, samples: np.ndarray):
        """samples: (N, h, w) uint8 → caches integral rows + norm factors."""
        x = jnp.asarray(samples)
        self.sum_rows, self.sum_rows_i, self.nf, tilt = _haar_sample_state(
            x, self.need_tilted
        )
        if self.need_tilted:
            self.tilt_rows = tilt
        self.n = int(x.shape[0])

    def num_blocks(self):
        return (self.num_features + self.block_size - 1) // self.block_size

    def block_slice(self, b):
        lo = b * self.block_size
        return lo, min(lo + self.block_size, self.num_features)

    def _eval_features(self, ids_or_slice):
        off = self._offsets[ids_or_slice]
        w = self._weights[ids_or_slice]
        til = self._tilted[ids_or_slice]
        if til.any():
            r1, c1, v1 = _haar_scatter_args(
                off * (~til[:, None, None]), w * (~til[:, None])
            )
            up = _haar_eval_program(r1, c1, v1, self.sum_rows,
                                    jnp.ones_like(self.nf), self.p)
            r2, c2, v2 = _haar_scatter_args(
                off * til[:, None, None], w * til[:, None]
            )
            ti = _haar_eval_program(r2, c2, v2, self.tilt_rows,
                                    jnp.ones_like(self.nf), self.p)
            return normalized_response(up + ti, self.nf[None, :])
        rows, cols, vals = _haar_scatter_args(off, w)
        return _haar_eval_program(
            rows, cols, vals, self.sum_rows, self.nf, self.p
        )

    def values_block(self, b: int) -> jax.Array:
        """(B, N) f32 responses of feature block b on the cached samples."""
        lo, hi = self.block_slice(b)
        return self._eval_features(slice(lo, hi))

    def values_for_vars(self, var_ids) -> jax.Array:
        """(K, N) responses for an explicit list of feature indices —
        used by the cascade predictor during sample mining."""
        return self._eval_features(np.asarray(var_ids, np.int64))


@jax.jit
def _lbp_sample_state(x):
    s = integral_image(x)
    return s.reshape(s.shape[0], -1).astype(jnp.float32)


class LBPTrainEvaluator:
    """Evaluates LBP codes (0..255) for sample batches, block by block.

    Cell sums via one (9·B, P) × (P, N) matmul, then the 8 comparisons of
    lbpfeatures.h:70-83."""

    maxCatCount = 256
    featSize = 1

    def __init__(self, catalog: LBPCatalog, block_size: int = 16384):
        self.catalog = catalog
        self.block_size = block_size
        self.win_w, self.win_h = catalog.win_w, catalog.win_h
        self.p = (catalog.win_w + 1) * (catalog.win_h + 1)
        self.num_features = len(catalog)
        self.var_count = self.num_features
        # 9 cell rects per feature from the 16 grid corners
        po = catalog.cell_offsets()  # (F, 16) in 4x4 grid order
        g = po.reshape(-1, 4, 4)

        def rect(r0, c0):
            return np.stack(
                [g[:, r0, c0], g[:, r0, c0 + 1], g[:, r0 + 1, c0], g[:, r0 + 1, c0 + 1]],
                axis=1,
            )

        # cell grid (row-major 3x3): offsets p are row-major corner grid
        cells = [rect(r, c) for r in range(3) for c in range(3)]
        self._cell_rects = np.stack(cells, axis=1)  # (F, 9, 4)

    def set_samples(self, samples: np.ndarray):
        x = jnp.asarray(samples)
        self.sum_rows = _lbp_sample_state(x)
        self.n = int(x.shape[0])

    def num_blocks(self):
        return (self.num_features + self.block_size - 1) // self.block_size

    def block_slice(self, b):
        lo = b * self.block_size
        return lo, min(lo + self.block_size, self.num_features)

    def _codes(self, rects) -> jax.Array:
        """(B, 9, 4) cell rect offsets → (B, N) int32 LBP codes."""
        bsz = rects.shape[0]
        m = _rect_corner_matrix(rects.reshape(-1, 4), self.p)  # (B*9, P)
        cs = jnp.dot(jnp.asarray(m), self.sum_rows.T, precision=_MM_PREC)
        cs = cs.reshape(bsz, 3, 3, -1)  # (B, 3row, 3col, N)
        code = lbp_code_grid(
            [[cs[:, r, c] for c in range(3)] for r in range(3)]
        )
        return code.astype(jnp.int32)

    def values_block(self, b: int) -> jax.Array:
        """(B, N) int32 LBP codes for feature block b."""
        lo, hi = self.block_slice(b)
        return self._codes(self._cell_rects[lo:hi])

    def values_for_vars(self, var_ids) -> jax.Array:
        ids = np.asarray(var_ids, np.int64)
        return self._codes(self._cell_rects[ids])


@jax.jit
def _hog_sample_state(x):
    return hog_integral_histogram(x)


class HOGTrainEvaluator:
    """Evaluates HOG descriptor components (36 vars/feature) block by block.

    Mirrors CvHOGEvaluator (HOGfeatures.h:84-108): per-cell histogram sums
    over 9 integral orientation channels, L1-normalized by the block sum.
    Variable blocks are aligned to whole features (block_size % 36 == 0)."""

    maxCatCount = 0
    featSize = 36

    def __init__(self, catalog: HOGCatalog, block_size: int = 36 * 1024):
        assert block_size % 36 == 0
        self.catalog = catalog
        self.block_size = block_size
        self.win_w, self.win_h = catalog.win_w, catalog.win_h
        self.p = (catalog.win_w + 1) * (catalog.win_h + 1)
        self.num_features = len(catalog)
        self.var_count = catalog.var_count
        self._cells = catalog.cell_corner_offsets()  # (F, 4, 4)

    def set_samples(self, samples: np.ndarray):
        x = jnp.asarray(samples)
        hist, norm = _hog_sample_state(x)
        n = x.shape[0]
        self.hist_rows = hist.reshape(n, 9, -1)
        self.norm_rows = norm.reshape(n, -1)
        self.n = n

    def num_blocks(self):
        return (self.var_count + self.block_size - 1) // self.block_size

    def block_slice(self, b):
        lo = b * self.block_size
        return lo, min(lo + self.block_size, self.var_count)

    def values_block(self, b: int) -> jax.Array:
        """(B, N) f32 responses for variable block b (whole features)."""
        lo, hi = self.block_slice(b)
        flo, fhi = lo // 36, (hi + 35) // 36
        cells = self._cells[flo:fhi]  # (Fb, 4, 4)
        fb = cells.shape[0]
        m = _rect_corner_matrix(cells.reshape(-1, 4), self.p)  # (Fb*4, P)
        mj = jnp.asarray(m)
        # cell sums per orientation bin: (Fb*4, N, 9)
        cs = jnp.einsum(
            "rp,nbp->rnb", mj, self.hist_rows, precision=_MM_PREC
        ).reshape(fb, 4, -1, 9)  # (Fb, cell, N, bin)

        # block L1 norm: p0 of cell0 − p1 of cell1 − p2 of cell2 + p3 of cell3
        # (HOGfeatures.h:104) = the 2×2 block's own corner offsets
        nm = np.zeros((fb, self.p), np.float32)
        rows = np.arange(fb)
        np.add.at(nm, (rows, cells[:, 0, 0]), 1.0)
        np.add.at(nm, (rows, cells[:, 1, 1]), -1.0)
        np.add.at(nm, (rows, cells[:, 2, 2]), -1.0)
        np.add.at(nm, (rows, cells[:, 3, 3]), 1.0)
        norm = jnp.dot(
            jnp.asarray(nm), self.norm_rows.T, precision=_MM_PREC
        )  # (Fb, N)

        res = normalized_response(cs, norm[:, None, :, None] + 1e-3)
        res = jnp.where(cs > 1e-3, res, 0.0)
        # (Fb, cell, N, bin) -> (Fb, cell, bin, N) -> (Fb*36, N)
        res = jnp.transpose(res, (0, 1, 3, 2)).reshape(fb * 36, -1)
        return res[lo - flo * 36 : hi - flo * 36]

    def values_for_vars(self, var_ids) -> jax.Array:
        ids = np.asarray(var_ids, np.int64)
        feats = np.unique(ids // 36)
        fmap = {int(f): i for i, f in enumerate(feats)}
        cells = self._cells[feats]
        fb = cells.shape[0]
        m = _rect_corner_matrix(cells.reshape(-1, 4), self.p)
        cs = jnp.einsum(
            "rp,nbp->rnb", jnp.asarray(m), self.hist_rows, precision=_MM_PREC
        ).reshape(fb, 4, -1, 9)
        nm = np.zeros((fb, self.p), np.float32)
        rows = np.arange(fb)
        np.add.at(nm, (rows, cells[:, 0, 0]), 1.0)
        np.add.at(nm, (rows, cells[:, 1, 1]), -1.0)
        np.add.at(nm, (rows, cells[:, 2, 2]), -1.0)
        np.add.at(nm, (rows, cells[:, 3, 3]), 1.0)
        norm = jnp.dot(jnp.asarray(nm), self.norm_rows.T, precision=_MM_PREC)
        res = normalized_response(cs, norm[:, None, :, None] + 1e-3)
        res = jnp.where(cs > 1e-3, res, 0.0)
        res = jnp.transpose(res, (0, 1, 3, 2)).reshape(fb * 36, -1)
        sel = np.array([fmap[int(v // 36)] * 36 + int(v % 36) for v in ids])
        return res[jnp.asarray(sel)]
