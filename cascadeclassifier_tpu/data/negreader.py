"""Deterministic multi-scale background-window miner.

Replicates the reference NegReader schedule exactly
(imagestorage.cpp:23-126): round-robin over the bg list with a
round-counter-derived start offset, windows slid by stepFactor=0.5·win,
then scale ·= √2 and rescan, then next image. Resizes use the bit-exact
INTER_LINEAR_EXACT twin (ops/resize.py) so every emitted window is
byte-identical to the reference's.

The batched twist: ``take_batch(n)`` materializes the next n schedule
windows in one (n, h, w) array so hard-negative mining can run the cascade
on-device over large batches instead of the reference's
one-window-per-predict loop (cascadeclassifier.cpp:329-357). Selection
equivalence holds because the schedule is independent of the cascade's
accept/reject decisions.
"""

from __future__ import annotations

import numpy as np

from cascadeclassifier_tpu.ops.resize import resize_linear_exact_np

SCALE_FACTOR = np.float32(1.4142135623730950488016887242097)
STEP_FACTOR = np.float32(0.5)


def read_pgm(path: str) -> np.ndarray:
    """Binary 8-bit PGM (P5) → (h, w) uint8, with numpy only."""
    with open(path, "rb") as f:
        data = f.read()
    fields, pos = [], 2
    if data[:2] != b"P5":
        raise ValueError(f"{path}: not a binary PGM (P5)")
    while len(fields) < 3:
        while data[pos : pos + 1].isspace():
            pos += 1
        if data[pos : pos + 1] == b"#":
            pos = data.index(b"\n", pos) + 1
            continue
        end = pos
        while not data[end : end + 1].isspace():
            end += 1
        fields.append(int(data[pos:end]))
        pos = end
    w, h, maxval = fields
    if maxval > 255:
        raise ValueError(f"{path}: 16-bit PGM is not supported")
    pos += 1  # the single whitespace byte after maxval
    return np.frombuffer(data, np.uint8, w * h, pos).reshape(h, w).copy()


def write_pgm(path: str, img: np.ndarray) -> None:
    """(h, w) uint8 → binary PGM (P5)."""
    img = np.ascontiguousarray(img, np.uint8)
    with open(path, "wb") as f:
        f.write(b"P5\n%d %d\n255\n" % (img.shape[1], img.shape[0]))
        f.write(img.tobytes())


def imread_gray(path: str):
    """Grayscale (h, w) uint8 image, None when unreadable (cv2.imread's
    contract). Binary PGM is read with numpy; other formats need OpenCV's
    Python bindings."""
    try:
        with open(path, "rb") as f:
            magic = f.read(2)
    except OSError:
        return None
    if magic == b"P5":
        return read_pgm(path)
    import cv2

    return cv2.imread(path, cv2.IMREAD_GRAYSCALE)


def read_bg_list(path: str):
    """bg.txt parsing (imagestorage.cpp:35-55): '#' comments skipped, an
    empty line terminates the list."""
    names = []
    with open(path) as f:
        for line in f:
            s = line.rstrip(" \n\r\t")
            if not s:
                break
            if s[0] == "#":
                continue
            names.append(s)
    return names


class LazyLevel:
    """A scheduled (image, scale) level whose resized pixels materialize
    on first host access.

    Device-side dense mining builds the level ON-CHIP from the uploaded
    source (gather-resize twin of resize_linear_exact), so for most
    levels the host never resizes at all — only levels that contribute
    accepted windows pay the exact host resize (the crop in
    CascadeTrainer._fill_negatives). At late-stage acceptance (< 1e-4)
    that removes ~all host resize wall-clock from the mining loop."""

    __slots__ = ("src", "src_id", "w", "h", "_img")

    def __init__(self, src, src_id, w, h):
        self.src = src
        self.src_id = src_id
        self.w, self.h = int(w), int(h)
        self._img = None

    @property
    def shape(self):
        return (self.h, self.w)

    @property
    def size(self):
        return self.h * self.w

    def materialize(self) -> np.ndarray:
        if self._img is None:
            self._img = resize_linear_exact_np(self.src, self.w, self.h)
        return self._img

    def __getitem__(self, sl):
        return self.materialize()[sl]

    def __array__(self, dtype=None, copy=None):
        a = self.materialize()
        return np.asarray(a, dtype=dtype)


class NegReader:
    """Streaming negative miner; ``get()`` yields one (h, w) uint8 window.

    lazy=True: scheduled levels are LazyLevel descriptors (shape-only on
    the host); the schedule arithmetic needs only sizes, so the exact
    resize runs on-device during dense mining and on-host only for
    accepted-window crops."""

    def __init__(self, bg_path: str, win_w: int, win_h: int, imread=None,
                 lazy: bool = False):
        self.filenames = read_bg_list(bg_path)
        if not self.filenames:
            raise FileNotFoundError(f"no backgrounds in {bg_path}")
        self.win_w, self.win_h = win_w, win_h
        self.src = None  # full-res gray image
        self.img = None  # current scaled image
        self.point = (0, 0)
        self.offset = (0, 0)
        self.scale = np.float32(1.0)
        self.last = 0
        self.round = 0
        self.lazy = lazy
        self.src_id = -1
        self._raw_imread = imread or imread_gray
        self._src_cache = {}

    # decoded-source cache: the round-robin schedule re-reads every
    # background once per pass — hundreds of passes at late-stage
    # acceptance re-decode the same files (the reference re-imreads too,
    # imagestorage.cpp:57-88, but pays it in its own wall-clock)
    SRC_CACHE_CAP = 256

    def _imread(self, path):
        img = self._src_cache.get(path)
        if img is None:
            img = self._raw_imread(path)
            if img is not None and len(self._src_cache) < self.SRC_CACHE_CAP:
                self._src_cache[path] = img
        return img

    def _resize(self, w, h):
        if self.lazy:
            return LazyLevel(self.src, self.src_id, w, h)
        return resize_linear_exact_np(self.src, w, h)

    # -- schedule (mirrors NegReader::nextImg / ::get) ----------------------

    def _next_img(self) -> bool:
        count = len(self.filenames)
        src = None
        off = (0, 0)
        for _ in range(count):
            src = self._imread(self.filenames[self.last])
            src_id = self.last
            self.last += 1
            if src is None or src.size == 0:
                self.last %= count
                src = None
                continue
            self.round += self.last // count
            self.round %= self.win_w * self.win_h
            self.last %= count
            ox = min(self.round % self.win_w, src.shape[1] - self.win_w)
            oy = min(self.round // self.win_w, src.shape[0] - self.win_h)
            if src.ndim == 2 and ox >= 0 and oy >= 0:
                off = (ox, oy)
                break
            src = None
        if src is None:
            return False
        self.src = src
        self.src_id = src_id
        self.point = self.offset = off
        rows, cols = src.shape
        self.scale = np.float32(
            max(
                np.float32(self.win_w + off[0]) / np.float32(cols),
                np.float32(self.win_h + off[1]) / np.float32(rows),
            )
        )
        sz_w = int(self.scale * cols + 0.5)
        sz_h = int(self.scale * rows + 0.5)
        self.img = self._resize(sz_w, sz_h)
        return True

    def _advance(self) -> bool:
        """Move ``point`` past the current window (imagestorage.cpp:105-124),
        crossing level / image boundaries. False when backgrounds run out."""
        ww, wh = self.win_w, self.win_h
        px, py = self.point
        if int(px + (1.0 + STEP_FACTOR) * ww) < self.img.shape[1]:
            self.point = (px + int(STEP_FACTOR * ww), py)
        else:
            px0 = self.offset[0]
            if int(py + (1.0 + STEP_FACTOR) * wh) < self.img.shape[0]:
                self.point = (px0, py + int(STEP_FACTOR * wh))
            else:
                self.point = (px0, self.offset[1])
                self.scale = np.float32(self.scale * SCALE_FACTOR)
                if self.scale <= 1.0:
                    rows, cols = self.src.shape
                    self.img = self._resize(
                        int(self.scale * cols), int(self.scale * rows)
                    )
                else:
                    if not self._next_img():
                        return False
        return True

    def get(self):
        """Next window, or None when no usable background exists."""
        if self.img is None:
            if not self._next_img():
                return None
        ww, wh = self.win_w, self.win_h
        px, py = self.point
        win = self.img[py : py + wh, px : px + ww].copy()
        if not self._advance():
            return None
        return win

    # -- level-granular access for device-side dense mining -----------------

    def state(self):
        """Snapshot of the schedule state (images by reference)."""
        return (self.src, self.img, self.point, self.offset, self.scale,
                self.last, self.round, self.src_id)

    def set_state(self, st):
        (self.src, self.img, self.point, self.offset, self.scale,
         self.last, self.round, self.src_id) = st

    def level_positions(self):
        """The remaining windows of the current (image, scale) level:
        ``(img, positions)`` with positions (m, 2) int32 ``(px, py)`` in
        schedule order starting at the current point. Does NOT advance
        state — pair with ``skip(k)``. None when backgrounds run out.

        With these two plus ``state``/``set_state``, hard-negative mining
        evaluates whole levels on-device (one small image upload instead
        of per-window crops) while preserving the reference's exact
        window schedule (imagestorage.cpp:90-126)."""
        if self.img is None and not self._next_img():
            return None
        ww, wh = self.win_w, self.win_h
        H, W = self.img.shape
        sx, sy = int(STEP_FACTOR * ww), int(STEP_FACTOR * wh)
        px0 = self.offset[0]
        xs = [px0]
        while int(xs[-1] + (1.0 + STEP_FACTOR) * ww) < W:
            xs.append(xs[-1] + sx)
        ys = [self.point[1]]
        while int(ys[-1] + (1.0 + STEP_FACTOR) * wh) < H:
            ys.append(ys[-1] + sy)
        xs = np.asarray(xs, np.int32)
        ys = np.asarray(ys, np.int32)
        first = xs[xs >= self.point[0]]
        gx, gy = np.meshgrid(xs, ys[1:])
        pos = np.concatenate([
            np.stack([first, np.full(len(first), ys[0], np.int32)], 1),
            np.stack([gx.ravel(), gy.ravel()], 1),
        ])
        return self.img, pos.reshape(-1, 2)

    def skip(self, k: int) -> bool:
        """Advance the schedule by k windows (no cropping).

        Equivalent to k repeated ``_advance()`` calls but O(levels)
        instead of O(k): positions within the current level come from
        the same grid arithmetic as level_positions, and level/image
        crossings reuse ``_advance`` from the level's last window (late-
        stage mining skips millions of windows per stage — the per-
        window Python walk was the round-3 mining wall)."""
        if self.img is None and not self._next_img():
            return False
        ww, wh = self.win_w, self.win_h
        while k > 0:
            H, W = self.img.shape
            sx, sy = int(STEP_FACTOR * ww), int(STEP_FACTOR * wh)
            px0 = self.offset[0]
            xs = [px0]
            while int(xs[-1] + (1.0 + STEP_FACTOR) * ww) < W:
                xs.append(xs[-1] + sx)
            ys = [self.point[1]]
            while int(ys[-1] + (1.0 + STEP_FACTOR) * wh) < H:
                ys.append(ys[-1] + sy)
            first = [x for x in xs if x >= self.point[0]]
            n_rem = len(first) + (len(ys) - 1) * len(xs)
            if n_rem == 0:  # defensive: no window at point
                if not self._advance():
                    return False
                k -= 1
                continue
            if k < n_rem:
                if k < len(first):
                    self.point = (first[k], ys[0])
                else:
                    j = k - len(first)
                    self.point = (xs[j % len(xs)], ys[1 + j // len(xs)])
                return True
            # cross the level: stand on its last window, advance once
            last_x = xs[-1] if len(ys) > 1 else first[-1]
            self.point = (last_x, ys[-1])
            k -= n_rem
            if not self._advance():
                return False
        return True

    def take_batch(self, n: int) -> np.ndarray:
        """Next n schedule windows as (m, win_h, win_w) uint8, m ≤ n."""
        out = np.empty((n, self.win_h, self.win_w), np.uint8)
        m = 0
        for i in range(n):
            w = self.get()
            if w is None:
                break
            out[m] = w
            m += 1
        return out[:m]
