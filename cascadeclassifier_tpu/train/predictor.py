"""Training-side cascade predictor for sample filtering.

Mirrors CvCascadeClassifier::predict → CvCascadeBoost::predict
(cascadeclassifier.cpp:297-306, boost.cpp:461-477): training-evaluator
feature semantics, tree walk with ``val <= c`` (ordered) or subset-bit
(categorical), stage rejection at ``sum < threshold − 1e-5``.

Evaluates whole window batches at once: the features used by the trained
stages (a few hundred) are computed for the entire batch via one
matmul, then the small trees are walked vectorized in numpy.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

CV_THRESHOLD_EPS = 1e-5


@functools.partial(jax.jit, static_argnames=("wh", "ww"))
def _extract_windows(img_pad, pxs, pys, wh, ww):
    """(n_pad,) grid positions → (n_pad, wh, ww) uint8 windows, on device.

    Device-side replacement for NegReader's host crop loop: one small
    image upload serves a whole (image, scale) mining level. Positions
    are bucket-padded; the caller tracks true counts."""
    rows = pys[:, None] + jnp.arange(wh, dtype=jnp.int32)
    cols = pxs[:, None] + jnp.arange(ww, dtype=jnp.int32)
    return img_pad[rows[:, :, None], cols[:, None, :]]


def _pow2(n: int, lo: int = 1) -> int:
    return max(lo, 1 << int(np.ceil(np.log2(max(n, 1)))))


def _ladder(v: int, base: int, ratio: float = 1.3) -> int:
    """Smallest base-multiple ≥ v on a ~ratio geometric ladder.

    Quantizes mining-level padded extents so the ~12 pyramid level
    shapes of a background corpus collapse into O(log) compiled dense
    programs instead of one compile per (level, stage snapshot).
    Worst-case padded-area waste ≈ ratio²."""
    b = base
    while b < v:
        b = -(-int(b * ratio) // base) * base
    return b


@functools.partial(
    jax.jit, static_argnames=("sy", "sx", "wh", "ww", "ny", "nx")
)
def _grid_windows(stack_u8, sy, sx, wh, ww, ny, nx):
    """Dense mining window extraction: (L, Hp, Wp) uint8 level stack →
    (L·ny·nx, wh, ww) uint8 windows of the full stride-(sy, sx) schedule
    grid — ZERO gathers: block reshapes replace a per-window stack
    gather and strided slices.

    The schedule stride is the half-window (imagestorage.cpp:105-124),
    so windows start on (sy, sx) block boundaries and each window is an
    aligned ky×kx block neighborhood: the whole grid is a reshape into
    blocks, ky·kx shifted block VIEWS, and one regular transpose — all
    layout ops XLA moves at full HBM rate. Window CONTENT is byte-
    identical to the host crops, so the rest of the per-window predict
    pipeline (set_samples → values_for_vars → stump walk) is untouched
    and selection equivalence is inherited."""
    L, hp, wp = stack_u8.shape
    ky = -(-wh // sy)
    kx = -(-ww // sx)
    nyb, nxb = hp // sy, wp // sx
    x = stack_u8.reshape(L, nyb, sy, nxb, sx)
    v = jnp.stack(
        [
            jnp.stack(
                [x[:, a : a + ny, :, b : b + nx, :] for b in range(kx)],
                axis=0,
            )
            for a in range(ky)
        ],
        axis=0,
    )  # (ky, kx, L, ny, sy, nx, sx)
    v = jnp.transpose(v, (2, 3, 5, 0, 4, 1, 6))  # (L,ny,nx,ky,sy,kx,sx)
    v = v.reshape(L * ny * nx, ky * sy, kx * sx)
    return v[:, :wh, :ww]


def _stump_walk(vals, ti, tt, tl, tr_, ts, bs, be, sthr_d):
    """Traced all-stump cascade walk body (boost.cpp:461-477 semantics):
    leaves in f64, stage sums via ONE f64 cumsum over the tree axis +
    dynamic stage-boundary row gathers — shape-stable as stages are
    added, where a segment_sum would lower to a scatter-add."""
    with jax.enable_x64(True):
        tv = vals[ti]  # (T, m) gather over small K axis
        if ts is not None:
            code = tv.astype(jnp.int32)
            word = jnp.zeros_like(code)
            wsel = code >> 5
            for wi in range(8):
                word = jnp.where(wsel == wi, ts[:, wi : wi + 1], word)
            bit = (word >> (code & 31)) & 1
            leaf = jnp.where(
                bit != 0, tl[:, None], tr_[:, None]
            ).astype(jnp.float64)
        else:
            leaf = jnp.where(
                tv <= tt[:, None], tl[:, None], tr_[:, None]
            ).astype(jnp.float64)
        pref = jnp.cumsum(leaf, axis=0)  # (T, m) f64
        ends = pref[jnp.maximum(be - 1, 0)]  # (S, m) row gathers
        starts = jnp.where((bs > 0)[:, None], pref[jnp.maximum(bs - 1, 0)], 0.0)
        ssum = jnp.where((be > 0)[:, None], ends - starts, 0.0)
        rej = ssum < sthr_d[:, None] - CV_THRESHOLD_EPS
        return ~jnp.any(rej, axis=0)


@functools.partial(jax.jit, static_argnames=("wh", "ww"))
def _extract_windows_multi(img_stack, ids, pxs, pys, wh, ww):
    """Multi-level window gather: (L, H, W) stacked level images +
    per-window level ids → (n_pad, wh, ww) uint8 windows."""
    rows = pys[:, None] + jnp.arange(wh, dtype=jnp.int32)
    cols = pxs[:, None] + jnp.arange(ww, dtype=jnp.int32)
    return img_stack[ids[:, None, None], rows[:, :, None], cols[:, None, :]]


class CascadePredictor:
    """Predicts accept/reject of the current (partial) cascade on batches."""

    # device image-cache entries (levels + stacks) before a full evict
    IMG_CACHE_CAP = 2048

    def __init__(self, evaluator_factory, stages=None):
        """evaluator_factory: () → fresh train evaluator over the full
        catalog (set_samples + values_for the used variables)."""
        self._make_ev = evaluator_factory
        self.stages = list(stages or [])

    def add_stage(self, stage):
        self.stages.append(stage)

    def _used_vars(self):
        used = set()
        for s in self.stages:
            for t in s.trees:
                used.update(int(v) for v in t.feature_idx)
        return sorted(used)

    def _stump_tables(self, var_pos, categorical):
        """Flattened per-tree arrays for the device walk (stump-only
        cascades — the trained default); None when any tree is deep."""
        idxs, thrs, lls, rrs, subs, bounds, sthr = [], [], [], [], [], [0], []
        for stage in self.stages:
            for tree in stage.trees:
                if tree.num_nodes != 1:
                    return None
                idxs.append(var_pos[int(tree.feature_idx[0])])
                if categorical:
                    subs.append(np.asarray(tree.subsets[0], np.int32))
                    thrs.append(0.0)
                else:
                    thrs.append(float(tree.threshold[0]))
                ll = (
                    tree.leaf_values[-int(tree.left[0])]
                    if tree.left[0] <= 0 else 0.0
                )
                rr = (
                    tree.leaf_values[-int(tree.right[0])]
                    if tree.right[0] <= 0 else 0.0
                )
                lls.append(float(ll))
                rrs.append(float(rr))
            bounds.append(len(idxs))
            sthr.append(float(stage.threshold))
        return (
            np.asarray(idxs, np.int32), np.asarray(thrs, np.float32),
            np.asarray(lls, np.float32), np.asarray(rrs, np.float32),
            np.stack(subs) if subs else None, bounds, sthr,
        )

    def _device_predict(self, vals_dev, tables, m_pad):
        """All-stump cascade walk on device: one fetch per batch instead
        of fetching the (K, m) value matrix (the mining hot path —
        late-stage hard-negative mining pushes 10^8 windows).

        Shape-stable across stages: trees/stages are padded to pow2
        buckets and stage membership rides as a device segment-id array,
        so adding a stage reuses the compiled program (the per-stage
        walk recompile was a visible share of late-stage mining wall)."""
        import jax

        t_pad, s_pad, tabs = self._walk_tables(tables)
        cat = tabs[4] is not None
        key = ("stumpwalk", s_pad, t_pad, m_pad, cat)
        if key not in self._jit_cache:
            def run(vals, ti, tt, tl, tr_, ts, bs, be, sthr_d):
                return _stump_walk(
                    vals, ti, tt, tl, tr_, ts, bs, be, sthr_d
                )

            self._jit_cache[key] = jax.jit(run)
        return self._jit_cache[key](vals_dev, *tabs)

    def _walk_tables(self, tables):
        """Pad the stump tables to pow2 tree/stage buckets and cache them
        on device; stage membership rides as dynamic boundary arrays so
        the compiled walk is reused as stages are added."""
        idxs, thrs, lls, rrs, subs, bounds, sthr = tables
        t_n = len(idxs)
        s_n = len(bounds) - 1
        t_pad = _pow2(t_n, 16)
        s_pad = _pow2(s_n, 8)
        tkey = ("tables", len(self.stages), t_n, t_pad, s_pad)
        if tkey not in self._jit_cache:
            pt = t_pad - t_n
            bs = np.zeros(s_pad, np.int32)
            be = np.zeros(s_pad, np.int32)
            bs[:s_n] = bounds[:-1]
            be[:s_n] = bounds[1:]
            sthr_p = np.full(s_pad, -1e30, np.float64)
            sthr_p[:s_n] = np.asarray(sthr, np.float64)
            with jax.enable_x64(True):  # keep f64 thresholds f64
                sthr_dev = jax.device_put(sthr_p)
            self._jit_cache[tkey] = (
                jnp.asarray(np.pad(idxs, (0, pt))),
                jnp.asarray(np.pad(thrs, (0, pt))),
                jnp.asarray(np.pad(lls, (0, pt))),
                jnp.asarray(np.pad(rrs, (0, pt))),
                None
                if subs is None
                else jnp.asarray(np.pad(subs, ((0, pt), (0, 0)))),
                jnp.asarray(bs),
                jnp.asarray(be),
                sthr_dev,
            )
        return t_pad, s_pad, self._jit_cache[tkey]

    def extract_level(self, img: np.ndarray, positions: np.ndarray,
                      ww: int, wh: int, cache_key=None):
        """One mining level: upload the scaled background once, gather
        its (bucket-padded) window grid on device. Async dispatch — no
        sync; pair with predict_parts.

        cache_key: optional hashable identity of the scaled background
        (e.g. (bg index, scale)): the mining schedule revisits the same
        (image, scale) levels every round-robin pass, so the device
        upload is cached — late-stage mining otherwise re-ships the
        same few MB thousands of times through the host link."""
        H, W = img.shape
        if not hasattr(self, "_img_cache"):
            self._img_cache = {}
        img_dev = (
            self._img_cache.get(cache_key) if cache_key is not None else None
        )
        if img_dev is None:
            img_pad = img
            Hp, Wp = -(-H // 128) * 128, -(-W // 128) * 128
            if (Hp, Wp) != (H, W):
                img_pad = np.zeros((Hp, Wp), np.uint8)
                img_pad[:H, :W] = img
            img_dev = jnp.asarray(img_pad)
            if cache_key is not None:
                if len(self._img_cache) > 512:
                    self._img_cache.clear()
                self._img_cache[cache_key] = img_dev
        n = len(positions)
        # power-of-2 buckets bound the number of compiled gather
        # programs to ~log2(max level size) per canvas bucket
        n_pad = max(256, 1 << int(np.ceil(np.log2(max(n, 2)))))
        pxs = np.zeros(n_pad, np.int32)
        pys = np.zeros(n_pad, np.int32)
        pxs[:n] = positions[:, 0]
        pys[:n] = positions[:, 1]
        return _extract_windows(
            img_dev, jnp.asarray(pxs), jnp.asarray(pys), wh, ww
        )

    # levels per dense-mining stack program (fixed so program shapes are
    # bucketed by level geometry only, not by superbatch composition)
    L_CHUNK = 8

    def predict_levels(self, levels, ww: int, wh: int):
        """Mining predict over whole (image, scale) levels.

        levels: list of (img, positions, cache_key) mining levels.
        Returns per-level (len(positions),) bool accept masks.

        Stump HAAR/LBP cascades (the trained default) take the dense
        integral-domain path: every level's full window grid is
        evaluated from ONE per-level integral via strided slices —
        no per-window patch gathers, no per-window integrals
        (fillPassedSamples, cascadeclassifier.cpp:329-357; a per-window
        gather formulation bounds late-stage mining). Deep-tree and HOG cascades keep the
        per-window gather path."""
        if not self.stages:
            return [np.ones(len(lv[1]), bool) for lv in levels]
        ev = self._make_ev()
        used = self._used_vars()
        var_pos = {v: i for i, v in enumerate(used)}
        if not hasattr(self, "_jit_cache"):
            self._jit_cache = {}
        tables = self._stump_tables(var_pos, ev.maxCatCount > 0)
        if tables is None or getattr(ev, "featSize", 1) != 1:
            # deep-tree / HOG cascades: per-window gather path
            return self._predict_levels_gather(levels, ww, wh)
        return self._predict_levels_dense(levels, ww, wh, ev, used, tables)

    def _predict_levels_dense(self, levels, ww, wh, ev, used, tables):
        """Dense grid mining: levels are origin-shifted into geometry-
        bucketed uint8 stacks (device-built for lazy levels, cached per
        (key, origin) otherwise); each L_CHUNK stack runs ONE fused
        program (_dense_chunk_fn) extracting its FULL schedule window
        grid via reshapes and evaluating the standard per-window
        predict semantics. Window bytes are identical to host crops, so
        selection is equivalent window-for-window."""
        if not hasattr(self, "_img_cache"):
            self._img_cache = {}
        if len(self._img_cache) > self.IMG_CACHE_CAP:
            self._img_cache.clear()
        sy, sx = wh // 2, ww // 2
        ky, kx = -(-wh // sy), -(-ww // sx)
        bh, bw = 8 * sy, 8 * sx  # slot geometry buckets (block-aligned)
        k = len(used)
        # pow2 with a 256 floor: the used-var count grows every stage,
        # and a fresh k_pad re-specializes every geometry's program —
        # the floor makes k_pad change at most twice across a 20-stage
        # run (early stages waste matmul width on tiny superbatches)
        k_pad = _pow2(k, 256)
        used_padded = used + [used[0]] * (k_pad - k)
        cat = ev.maxCatCount > 0
        _tp, _sp, tabs = self._walk_tables(tables)
        m_up, m_tilt, need_tilt = self._corner_matrices(
            ev, used_padded, k_pad
        )

        from cascadeclassifier_tpu.data.negreader import LazyLevel

        # per-level grid plans; identical (key, origin, geometry) levels
        # share one evaluated copy (the round-robin schedule revisits
        # the same levels every pass)
        plans = []
        uniq = {}
        for img, pos, key in levels:
            if len(pos) == 0:
                plans.append((None, None, None))
                continue
            ox = int(pos[:, 0].min())
            oy = int(pos[:, 1].min())
            eh, ew = img.shape[0] - oy, img.shape[1] - ox
            need_h = sy * ((eh - wh) // sy) + ky * sy
            need_w = sx * ((ew - ww) // sx) + kx * sx
            hp = _ladder(need_h, bh)
            wp = _ladder(need_w, bw)
            ukey = (key, ox, oy, hp, wp)
            if ukey not in uniq:
                uniq[ukey] = (img, oy, ox, hp, wp)
            plans.append(
                (ukey, (pos[:, 1] - oy) // sy, (pos[:, 0] - ox) // sx)
            )

        from collections import defaultdict

        # group by slot geometry; LAZY levels (device-built from the
        # uploaded source — the host never resizes) additionally group
        # by padded source geometry so chunks stack uniformly
        groups = defaultdict(list)
        for ukey, (img, _oy, _ox, hp, wp) in uniq.items():
            if isinstance(img, LazyLevel):
                shp, swp = (
                    _ladder(img.src.shape[0], 128),
                    _ladder(img.src.shape[1], 128),
                )
                groups[(hp, wp, shp, swp)].append(ukey)
            else:
                groups[(hp, wp, 0, 0)].append(ukey)

        from cascadeclassifier_tpu.utils.profiling import timed

        pend = []
        with timed("mine_values"):
            for (hp, wp, shp, swp), ukeys in sorted(groups.items()):
                ny = hp // sy - ky + 1
                nx = wp // sx - kx + 1
                lazy = shp > 0
                zkey = ("gz", hp, wp) if not lazy else ("gzs", shp, swp)
                if zkey not in self._img_cache:
                    z = (hp, wp) if not lazy else (shp, swp)
                    self._img_cache[zkey] = jnp.zeros(z, np.uint8)
                dummy_params = None
                for c0 in range(0, len(ukeys), self.L_CHUNK):
                    chunk = ukeys[c0 : c0 + self.L_CHUNK]
                    if lazy:
                        src_stack, params = self._lazy_stack_args(
                            chunk, uniq, shp, swp
                        )
                    else:
                        parts = []
                        for ukey in chunk:
                            dev = self._img_cache.get(("g",) + ukey)
                            if dev is None:
                                img, oy, ox, _hp, _wp = uniq[ukey]
                                pad = np.zeros((hp, wp), np.uint8)
                                ch = min(img.shape[0] - oy, hp)
                                cw = min(img.shape[1] - ox, wp)
                                pad[:ch, :cw] = img[
                                    oy : oy + ch, ox : ox + cw
                                ]
                                dev = jnp.asarray(pad)
                                self._img_cache[("g",) + ukey] = dev
                            parts.append(dev)
                        parts += [self._img_cache[zkey]] * (
                            self.L_CHUNK - len(chunk)
                        )
                        src_stack = jnp.stack(parts)
                        if dummy_params is None:
                            dummy_params = jnp.zeros(
                                (6, self.L_CHUNK), jnp.int32
                            )
                        params = dummy_params
                    fn = self._dense_chunk_fn(
                        (lazy, hp, wp, sy, sx, wh, ww, ny, nx,
                         k_pad, cat, need_tilt, ev.p)
                    )
                    ok = fn(src_stack, params, m_up, m_tilt, *tabs)
                    for slot, ukey in enumerate(chunk):
                        pend.append((ukey, ok, slot, ny, nx))

        # ONE packed fetch for the whole superbatch instead of a host
        # round trip per chunk
        with timed("mine_fetch"):
            seen = {}
            order = []
            for _ukey, ok, _slot, _ny, _nx in pend:
                if id(ok) not in seen:
                    seen[id(ok)] = len(order)
                    order.append(ok.reshape(-1))
            packed = (
                np.asarray(jnp.concatenate(order))
                if len(order) > 1
                else np.asarray(order[0])
            )
            offs = np.cumsum([0] + [o.shape[0] for o in order])
            ok_maps = {}
            for ukey, ok, slot, ny, nx in pend:
                i = seen[id(ok)]
                m = packed[offs[i] : offs[i + 1]].reshape(
                    self.L_CHUNK, ny, nx
                )
                ok_maps[ukey] = m[slot]

        out = []
        for ukey, iy, ix in plans:
            if ukey is None:
                out.append(np.zeros(0, bool))
                continue
            out.append(ok_maps[ukey][iy, ix])
        return out

    def _corner_matrices(self, ev, used_padded, k_pad):
        """Dense (K_pad, P) corner-incidence matrices for the fused chunk
        program (device-cached per cascade snapshot): HAAR upright +
        tilted, or the LBP (K_pad·9, P) cell matrix. Identical scatter
        construction to the per-window programs, so contractions stay
        exact-integer-equal."""
        from cascadeclassifier_tpu.train.evaluators import (
            _haar_scatter_args,
            _rect_corner_matrix,
        )

        key = ("cm", len(self.stages), k_pad)
        out = self._jit_cache.get(key)
        if out is not None:
            return out
        dummy = jnp.zeros((1, 1), jnp.float32)
        if ev.maxCatCount > 0:  # LBP cell rects
            rects = ev._cell_rects[np.asarray(used_padded, np.int64)]
            m = _rect_corner_matrix(rects.reshape(-1, 4), ev.p)
            out = (m, dummy, False)
        else:
            ids = np.asarray(used_padded, np.int64)
            off = ev._offsets[ids]
            w = ev._weights[ids]
            til = ev._tilted[ids]
            if til.any():
                r1, c1, v1 = _haar_scatter_args(
                    off * (~til[:, None, None]), w * (~til[:, None])
                )
                m_up = (
                    jnp.zeros((k_pad, ev.p), jnp.float32).at[r1, c1].add(v1)
                )
                r2, c2, v2 = _haar_scatter_args(
                    off * til[:, None, None], w * til[:, None]
                )
                m_t = (
                    jnp.zeros((k_pad, ev.p), jnp.float32).at[r2, c2].add(v2)
                )
                out = (m_up, m_t, True)
            else:
                rows, cols, vals = _haar_scatter_args(off, w)
                m_up = (
                    jnp.zeros((k_pad, ev.p), jnp.float32)
                    .at[rows, cols]
                    .add(vals)
                )
                out = (m_up, dummy, False)
        self._jit_cache[key] = out
        return out

    def _dense_chunk_fn(self, cfg):
        """ONE jitted program per chunk geometry running the whole dense
        pipeline: (lazy: on-device level build) → grid window extraction
        → integrals → corner matmul → stump walk: one dispatch per
        chunk instead of ~8 chained per-piece dispatches."""
        key = ("chunkfn",) + cfg
        fn = self._jit_cache.get(key)
        if fn is not None:
            return fn
        (lazy, hp, wp, sy, sx, wh, ww, ny, nx,
         k_pad, cat, need_tilt, p) = cfg
        from cascadeclassifier_tpu.ops.features import lbp_code_grid
        from cascadeclassifier_tpu.ops.integral import (
            integral_image,
            integral_sq,
            integral_tilted,
            normalized_response,
            window_norm_factor,
        )
        from cascadeclassifier_tpu.ops.resize import build_level_stack

        prec = jax.lax.Precision.HIGHEST

        def run(src_stack, params, m_up, m_tilt,
                ti, tt, tl, tr_, ts, bs, be, sthr_d):
            if lazy:
                stack = build_level_stack(src_stack, params, hp=hp, wp=wp)
            else:
                stack = src_stack
            win = _grid_windows(stack, sy, sx, wh, ww, ny, nx)
            s = integral_image(win)
            flat = s.reshape(s.shape[0], -1).astype(jnp.float32)  # (n, P)
            if cat:
                cs = jnp.dot(m_up, flat.T, precision=prec)
                cs = cs.reshape(k_pad, 3, 3, -1)
                vals = lbp_code_grid(
                    [[cs[:, r, c] for c in range(3)] for r in range(3)]
                ).astype(jnp.int32)
            else:
                sq = integral_sq(win, dtype=jnp.int32)
                nf = window_norm_factor(s, sq)
                raw = jnp.dot(m_up, flat.T, precision=prec)
                if need_tilt:
                    t = integral_tilted(win)
                    tf = t.reshape(t.shape[0], -1).astype(jnp.float32)
                    raw = raw + jnp.dot(m_tilt, tf.T, precision=prec)
                vals = normalized_response(raw, nf[None, :])
            return _stump_walk(vals, ti, tt, tl, tr_, ts, bs, be, sthr_d)

        fn = jax.jit(run)
        self._jit_cache[key] = fn
        return fn

    def _lazy_stack_args(self, chunk, uniq, shp, swp):
        """Source stack + (6, L_CHUNK) resize params for a lazy chunk:
        the fused chunk program builds the level slots ON DEVICE from
        the uploaded full-res sources (ops.resize.build_level_stack —
        bit-exact INTER_LINEAR_EXACT twin). Each source uploads once;
        per level the host ships six scalars. Kills the per-level host
        resize_linear_exact_np wall for big background corpora (the
        host materializes a level only when one of its windows is
        ACCEPTED, for the crop)."""
        params = np.zeros((6, self.L_CHUNK), np.int32)
        parts = []
        for i, ukey in enumerate(chunk):
            lvl, oy, ox, _hp, _wp = uniq[ukey]
            src = lvl.src
            skey = ("src", lvl.src_id, shp, swp)
            dev = self._img_cache.get(skey)
            if dev is None:
                pad = np.zeros((shp, swp), np.uint8)
                pad[: src.shape[0], : src.shape[1]] = src
                dev = jnp.asarray(pad)
                self._img_cache[skey] = dev
            parts.append(dev)
            params[:, i] = (
                src.shape[0], src.shape[1], lvl.h, lvl.w, oy, ox
            )
        parts += [self._img_cache[("gzs", shp, swp)]] * (
            self.L_CHUNK - len(chunk)
        )
        # pad slots resize a zero source to a degenerate 2x2 level
        params[0:4, len(chunk):] = 2
        return jnp.stack(parts), jnp.asarray(params)

    def _predict_levels_gather(self, levels, ww: int, wh: int):
        """Per-window gather mining predict (deep-tree / HOG cascades):
        ONE image stack, ONE window gather, ONE predict chain, ONE
        fetch per superbatch.

        levels: list of (img, positions, cache_key) mining levels.
        Returns per-level (len(positions),) bool accept masks."""
        if not hasattr(self, "_img_cache"):
            self._img_cache = {}
        # evict BEFORE populating: clearing inside the populate loop
        # would drop this superbatch's own earlier entries
        if len(self._img_cache) > self.IMG_CACHE_CAP:
            self._img_cache.clear()
        # common padded geometry (levels are ≤ the source image)
        Hp = max(-(-lv[0].shape[0] // 128) * 128 for lv in levels)
        Wp = max(-(-lv[0].shape[1] // 128) * 128 for lv in levels)
        # deduplicate: the round-robin schedule revisits the same few
        # dozen (bg, scale) levels every pass, so a superbatch of 1000+
        # levels holds ~72 DISTINCT images — stacking per level would
        # ship a 1000-operand stack program every superbatch. Window ids
        # index the unique stack, and the stacked device array itself is
        # cached on its key tuple (stable after the first full pass).
        first = {}
        for img, _pos, key in levels:
            if key not in first:
                first[key] = img
        uniq = sorted(first.items())  # key order → stable stack cache key
        uniq = [(img, key) for key, img in uniq]
        uid = {key: i for i, (_img, key) in enumerate(uniq)}
        for img, key in uniq:
            ck = (key, Hp, Wp)
            if ck not in self._img_cache:
                pad = np.zeros((Hp, Wp), np.uint8)
                pad[: img.shape[0], : img.shape[1]] = img
                self._img_cache[ck] = jnp.asarray(pad)
        L = len(uniq)
        L_pad = 1 << int(np.ceil(np.log2(max(L, 1))))
        zk = ("zero", Hp, Wp)
        if L_pad != L and zk not in self._img_cache:
            self._img_cache[zk] = jnp.zeros((Hp, Wp), np.uint8)
        skey = ("stack", tuple(k for _i, k in uniq), Hp, Wp)
        stack = self._img_cache.get(skey)
        if stack is None:
            # NB: build the pad list lazily — `[cache[zk]] * 0` would
            # still evaluate the lookup, and zk is only inserted when
            # L_pad != L (a power-of-two unique count has no pad)
            pad_imgs = (
                [self._img_cache[zk]] * (L_pad - L) if L_pad != L else []
            )
            stack = jnp.stack(
                [self._img_cache[(k, Hp, Wp)] for _i, k in uniq]
                + pad_imgs
            )
            self._img_cache[skey] = stack
        counts = [len(lv[1]) for lv in levels]
        n = int(np.sum(counts))
        n_pad = max(256, 1 << int(np.ceil(np.log2(max(n, 2)))))
        pxs = np.zeros(n_pad, np.int32)
        pys = np.zeros(n_pad, np.int32)
        ids = np.zeros(n_pad, np.int32)
        off = 0
        for li, (_img, pos, key) in enumerate(levels):
            c = len(pos)
            pxs[off : off + c] = pos[:, 0]
            pys[off : off + c] = pos[:, 1]
            ids[off : off + c] = uid[key]
            off += c
        from cascadeclassifier_tpu.utils.profiling import timed

        with timed("mine_extract"):
            win = _extract_windows_multi(
                stack, jnp.asarray(ids), jnp.asarray(pxs), jnp.asarray(pys),
                wh, ww,
            )
        if not self.stages:
            return [np.ones(c, bool) for c in counts]
        with timed("mine_values"):
            ok_dev = self._predict_device(win)
        with timed("mine_fetch"):
            ok = np.asarray(ok_dev)  # one fetch
        out, off = [], 0
        for c in counts:
            out.append(ok[off : off + c])
            off += c
        return out

    def predict_parts(self, parts, counts):
        """parts: device window stacks from extract_level (bucket-padded);
        counts: their true window counts. Per-part bucket-shaped predicts
        + ONE packed fetch; returns per-part (counts[i],) bool arrays.

        Every program shape here is bucket-bounded: concatenating the
        parts trimmed to their true counts would compile a new concat+pad
        program for each superbatch's size combination."""
        if not self.stages:
            return [np.ones(c, bool) for c in counts]
        # group parts by bucket shape and predict each group in ONE
        # dispatch chain: a superbatch is ~4 chains instead of one
        # dispatch and upload per part
        from collections import defaultdict

        groups = defaultdict(list)
        for i, p in enumerate(parts):
            groups[int(p.shape[0])].append(i)
        if not hasattr(self, "_zero_parts"):
            self._zero_parts = {}
        ok_rows = [None] * len(parts)
        for n_pad, gidx in groups.items():
            g = len(gidx)
            g_pad = 1 << int(np.ceil(np.log2(max(g, 1))))
            shape = tuple(parts[gidx[0]].shape)
            if g_pad != g and shape not in self._zero_parts:
                self._zero_parts[shape] = jnp.zeros(
                    shape, parts[gidx[0]].dtype
                )
            plist = [parts[i] for i in gidx]
            plist += [self._zero_parts[shape]] * (g_pad - g)
            x = jnp.concatenate(plist, axis=0)  # (g_pad*n_pad, h, w)
            ok = np.asarray(  # one fetch per shape group (~4/superbatch)
                self._predict_device(x)
            ).reshape(g_pad, n_pad)
            for j, i in enumerate(gidx):
                ok_rows[i] = ok[j]
        return [ok_rows[i][:c] for i, c in enumerate(counts)]

    def _predict_device(self, samples):
        """(m_bucket, h, w) device uint8 → (m_bucket,) device bool (padding
        windows evaluate too; callers slice by true count)."""
        used = self._used_vars()
        k = len(used)
        k_pad = max(16, -(-k // 16) * 16)
        used_padded = used + [used[0]] * (k_pad - k)
        ev = self._make_ev()
        ev.set_samples(samples)
        var_pos = {v: i for i, v in enumerate(used)}
        if not hasattr(self, "_jit_cache"):
            self._jit_cache = {}
        tables = self._stump_tables(var_pos, ev.maxCatCount > 0)
        if tables is None:
            return jnp.asarray(self.predict_batch(np.asarray(samples)))
        vals_dev = ev.values_for_vars(used_padded)
        return self._device_predict(
            vals_dev[:k], tables, int(samples.shape[0])
        )

    def predict_batch(self, samples: np.ndarray) -> np.ndarray:
        """samples: (m, h, w) uint8 → (m,) bool — True when every stage
        accepts (1 == reference predict)."""
        m = samples.shape[0]
        if not self.stages or m == 0:
            return np.ones(m, bool)
        # pad to a bucketed batch so mining reuses compiled programs;
        # device batches pad on device (np.concatenate on a jax array
        # silently round-trips the whole window batch through the host)
        m_pad = max(256, -(-m // 256) * 256)
        if m_pad != m:
            xp = jnp if isinstance(samples, jax.Array) else np
            samples = xp.concatenate(
                [samples, xp.zeros((m_pad - m,) + samples.shape[1:],
                                   samples.dtype)]
            )
        used = self._used_vars()
        # pad the used-variable list to a bucket so the number of trained
        # stages doesn't trigger recompiles of the evaluation program
        k = len(used)
        k_pad = max(16, -(-k // 16) * 16)
        used_padded = used + [used[0]] * (k_pad - k)
        ev = self._make_ev()
        ev.set_samples(samples)
        var_pos = {v: i for i, v in enumerate(used)}
        if not hasattr(self, "_jit_cache"):
            self._jit_cache = {}
        tables = self._stump_tables(var_pos, ev.maxCatCount > 0)
        if tables is not None:
            vals_dev = ev.values_for_vars(used_padded)  # stays on device
            ok = self._device_predict(vals_dev[:k], tables, m_pad)
            return np.asarray(ok)[:m]
        vals = np.asarray(ev.values_for_vars(used_padded))[:k, :m]  # (K, m)

        ok = np.ones(m, bool)
        categorical = ev.maxCatCount > 0
        for stage in self.stages:
            sums = np.zeros(m, np.float64)
            for tree in stage.trees:
                node = np.zeros(m, np.int32)
                out = np.zeros(m, np.float64)
                active = np.ones(m, bool)
                for _ in range(tree.num_nodes + 1):
                    if not active.any():
                        break
                    for ni in np.unique(node[active]):
                        sel = active & (node == ni)
                        v = vals[var_pos[int(tree.feature_idx[ni])]][sel]
                        if categorical:
                            code = v.astype(np.int64)
                            bit = (
                                tree.subsets[ni].astype(np.uint32)[code >> 5]
                                >> (code & 31)
                            ) & 1
                            go_left = bit != 0
                        else:
                            go_left = v <= tree.threshold[ni]
                        child = np.where(go_left, tree.left[ni], tree.right[ni])
                        idx = np.nonzero(sel)[0]
                        leaf = child <= 0
                        out[idx[leaf]] = tree.leaf_values[-child[leaf]]
                        active[idx[leaf]] = False
                        node[idx[~leaf]] = child[~leaf]
                sums += out
            ok &= ~(sums < stage.threshold - CV_THRESHOLD_EPS)
        return ok
