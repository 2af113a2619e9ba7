"""Multi-scale pyramid plan: static geometry for the detector.

The reference pipeline (OpenCV ``detectMultiScale``; consumed by
tools/detection/Cpp/main.cpp:45) processes one scaled image at a time with a
branchy per-window loop. This re-design packs *every* pyramid level into
one integral-image **canvas** so a single fused XLA program handles all
scales per frame:

  - scaled images are stacked vertically on a (canvas_h, canvas_w) grid,
    each level in a (h_s+1)-row block whose first row / first column are
    zero — so each block holds an OpenCV-layout integral image with the
    *uniform* row stride canvas_w (one relative-offset table serves every
    scale and window)
  - resize uses the bit-exact INTER_LINEAR_EXACT tables (ops/resize.py)
    evaluated as flat gathers, so one program resizes all levels
  - column prefix-sums run over the whole canvas with wrap-around int32
    arithmetic; per-block top-row subtraction recovers exact per-level
    integrals (values within a block fit int32/int64)

Scale enumeration, ystep and grid geometry replicate OpenCV 4.x
(empirically validated against the C++ oracle — see tests/test_detector.py):
  - factor = 1, 1·sf, sf², …; level kept while cvRound(win·factor) fits
    the image and [min,max]ObjectSize
  - scaled size = (cvRound(W/sc), cvRound(H/sc))
  - ystep = 1 if sc ≥ 2 else 2
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from cascadeclassifier_tpu.ops.resize import _axis_tab


def _cv_round(v):
    return int(np.rint(np.float64(v)))


@dataclasses.dataclass
class PyramidPlan:
    img_w: int
    img_h: int
    win_w: int
    win_h: int
    scales: np.ndarray  # (S,) float32 factors
    scaled_w: np.ndarray  # (S,) int
    scaled_h: np.ndarray
    ystep: np.ndarray  # (S,) int
    box_w: np.ndarray  # (S,) cvRound(win_w*factor)
    box_h: np.ndarray
    block_top: np.ndarray  # (S,) canvas row of each level's zero row
    canvas_w: int
    canvas_h: int
    # resize tables
    sy0: np.ndarray  # (canvas_h,) int32 source row (first)
    cy: np.ndarray  # (canvas_h,) int32 vertical coeff (0..256)
    sx0: np.ndarray  # (canvas_h, canvas_w) int16 source col
    cx: np.ndarray  # (canvas_h, canvas_w) uint16 horizontal coeff
    row_w: np.ndarray  # (canvas_h,) valid pixel count per canvas row
    is_top: np.ndarray  # (canvas_h,) bool — block zero rows
    top_of_row: np.ndarray  # (canvas_h,) block_top row index for each row
    # dense-grid row descriptors (canvas rows; length canvas_h)
    row_is_grid: np.ndarray  # (canvas_h,) bool — window grid rows (ystep-aware)
    row_step2: np.ndarray  # (canvas_h,) bool — level has ystep == 2
    row_maxc: np.ndarray  # (canvas_h,) int32 — last valid window column
    row_scale: np.ndarray  # (canvas_h,) int32 — level id of the row (-1 pad)

    @property
    def num_positions(self):
        return int(self.row_is_grid.sum() * self.canvas_w)


def opencv_scales(
    img_w, img_h, win_w, win_h, scale_factor, min_size=None, max_size=None
):
    """Replicates the scale enumeration of detectMultiScale."""
    min_w, min_h = min_size if min_size else (0, 0)
    max_w, max_h = max_size if (max_size and max_size[0] > 0) else (img_w, img_h)
    scales = []
    factor = 1.0
    while True:
        bw, bh = _cv_round(win_w * factor), _cv_round(win_h * factor)
        if bw > max_w or bh > max_h or bw > img_w or bh > img_h:
            break
        if not (bw < min_w or bh < min_h):
            scales.append(np.float32(factor))
        factor *= scale_factor
    return scales


@functools.lru_cache(maxsize=64)
def build_plan(
    img_w: int,
    img_h: int,
    win_w: int,
    win_h: int,
    scale_factor: float = 1.1,
    min_size: tuple | None = None,
    max_size: tuple | None = None,
    force_ystep: int | None = None,
) -> PyramidPlan:
    scales = opencv_scales(
        img_w, img_h, win_w, win_h, scale_factor, min_size, max_size
    )
    if not scales:
        raise ValueError("image smaller than detection window")
    S = len(scales)
    scaled_w = np.empty(S, np.int32)
    scaled_h = np.empty(S, np.int32)
    ystep = np.empty(S, np.int32)
    box_w = np.empty(S, np.int32)
    box_h = np.empty(S, np.int32)
    for i, sc in enumerate(scales):
        scaled_w[i] = _cv_round(img_w / sc)
        scaled_h[i] = _cv_round(img_h / sc)
        ystep[i] = 1 if sc >= 2 else 2
        # output boxes use FLOAT32 multiplies (the invoker's winSize =
        # cvRound(origWin·scalingFactor) with float scalingFactor), unlike
        # the double-precision enumeration bound in opencv_scales
        box_w[i] = _cv_round(np.float32(win_w) * sc)
        box_h[i] = _cv_round(np.float32(win_h) * sc)
    if force_ystep is not None:
        ystep[:] = force_ystep

    canvas_w = int(scaled_w.max()) + 1
    block_rows = scaled_h + 1
    # EVEN block_top for ystep-2 levels: their grid anchors sit at
    # block_top + 2k, so an even origin puts every step-2 anchor on an
    # even canvas row. Costs at most one garbage pad row per level.
    block_top = np.zeros(S, np.int32)
    top = 0
    for s in range(S):
        if ystep[s] == 2 and (top & 1):
            top += 1
        block_top[s] = top
        top += int(block_rows[s])
    canvas_h = top

    # per-row resize gather tables (the matmul resize in
    # detect/detector.py::_resize_matrices replaced them at runtime; the
    # resize tests still read them)
    sy0 = np.zeros(canvas_h, np.int32)
    cy = np.zeros(canvas_h, np.int32)
    sx0 = np.zeros((canvas_h, canvas_w), np.int16)
    cx = np.zeros((canvas_h, canvas_w), np.uint16)
    row_w = np.zeros(canvas_h, np.int32)
    is_top = np.zeros(canvas_h, bool)
    top_of_row = np.zeros(canvas_h, np.int32)

    for s in range(S):
        t = int(block_top[s])
        h_s, w_s = int(scaled_h[s]), int(scaled_w[s])
        ys, cys = _axis_tab(img_h, h_s)
        xs, cxs = _axis_tab(img_w, w_s)
        sx0[t + 1 : t + h_s + 1, 1 : w_s + 1] = xs[None, :]
        cx[t + 1 : t + h_s + 1, 1 : w_s + 1] = cxs[None, :]
        is_top[t] = True
        top_of_row[t : t + h_s + 1] = t
        row_w[t + 1 : t + h_s + 1] = w_s
        sy0[t + 1 : t + h_s + 1] = ys
        cy[t + 1 : t + h_s + 1] = cys

    # dense-grid row descriptors
    row_is_grid = np.zeros(canvas_h, bool)
    row_step2 = np.zeros(canvas_h, bool)
    row_maxc = np.full(canvas_h, -1, np.int32)
    row_scale = np.full(canvas_h, -1, np.int32)
    # OpenCV 4.x splits the y range into nstripes = cvCeil(szw0.width/32.)
    # stripes of stripeSize = max(ceil((prH/ystep)/nstripes), 1)*ystep and
    # iterates y < min(nstripes*stripeSize, prH) — when ystep == 2 and prH
    # is odd, the LAST grid row is visited iff the stripe total overshoots
    # prH−1, i.e. iff nstripes does not divide prH//ystep. Derived from
    # always-pass-cascade probes against the C++ oracle at 320x240
    # (nstripes=10: row 144 of prH=145 visited), 137x101 (nstripes=4: last
    # odd rows NOT visited) and 64x55 (nstripes=2).
    nstripes = int(np.ceil((int(scaled_w[0]) + 1 - win_w) / 32.0))
    for s in range(S):
        t, h_s, w_s = int(block_top[s]), int(scaled_h[s]), int(scaled_w[s])
        step = int(ystep[s])
        if w_s < win_w or h_s < win_h:
            continue
        # processingRect = szi − origWin with szi = scaled size + 1; the x
        # loop is x < prW (x ≤ w−ww inclusive), stepped by ystep
        pr_h = h_s + 1 - win_h
        stripe = max(-(-(pr_h // step) // max(nstripes, 1)), 1) * step
        y_bound = min(max(nstripes, 1) * stripe, pr_h)
        ys = np.arange(0, y_bound, step)
        row_is_grid[t + ys] = True
        row_step2[t : t + h_s + 1] = step == 2
        row_maxc[t : t + h_s + 1] = w_s - win_w
        row_scale[t : t + h_s + 1] = s

    return PyramidPlan(
        img_w=img_w,
        img_h=img_h,
        win_w=win_w,
        win_h=win_h,
        scales=np.array(scales, np.float32),
        scaled_w=scaled_w,
        scaled_h=scaled_h,
        ystep=ystep,
        box_w=box_w,
        box_h=box_h,
        block_top=block_top,
        canvas_w=canvas_w,
        canvas_h=canvas_h,
        sy0=sy0,
        cy=cy,
        sx0=sx0,
        cx=cx,
        row_w=row_w,
        is_top=is_top,
        top_of_row=top_of_row,
        row_is_grid=row_is_grid,
        row_step2=row_step2,
        row_maxc=row_maxc,
        row_scale=row_scale,
    )
