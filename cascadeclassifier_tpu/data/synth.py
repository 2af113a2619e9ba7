"""Seeded synthetic images, numpy only.

Face cascades fire hundreds of raw windows on blurred "face blobs"
(bright ellipse + dark eyes and mouth), which makes detector-parity
checks non-vacuous; plain noise and flat textures fire none.
"""

from __future__ import annotations

import os

import numpy as np

CASCADE_DIR = os.path.join(os.path.dirname(__file__), "cascades")
HAAR_FRONTALFACE_ALT = os.path.join(
    CASCADE_DIR, "haarcascade_frontalface_alt.xml"
)
LBP_FRONTALFACE = os.path.join(CASCADE_DIR, "lbpcascade_frontalface.xml")


def _fill_ellipse(img, cx, cy, ax, ay, value):
    """Filled axis-aligned ellipse, clipped to the image."""
    h, w = img.shape
    y0, y1 = max(cy - ay, 0), min(cy + ay + 1, h)
    x0, x1 = max(cx - ax, 0), min(cx + ax + 1, w)
    if y0 >= y1 or x0 >= x1:
        return
    yy = (np.arange(y0, y1)[:, None] - cy) / max(ay, 0.5)
    xx = (np.arange(x0, x1)[None, :] - cx) / max(ax, 0.5)
    sub = img[y0:y1, x0:x1]
    sub[yy * yy + xx * xx <= 1.0] = value


def _gauss_blur5(img, sigma):
    """5-tap separable Gaussian blur, reflect-101 borders, rounded."""
    k = np.exp(-(np.arange(-2, 3) ** 2) / (2.0 * sigma * sigma))
    k /= k.sum()
    x = img.astype(np.float64)
    for axis in (0, 1):
        p = np.pad(x, [(2, 2) if a == axis else (0, 0) for a in (0, 1)],
                   mode="reflect")
        n = x.shape[axis]
        x = sum(
            k[i] * np.take(p, np.arange(i, i + n), axis=axis)
            for i in range(5)
        )
    return np.clip(np.rint(x), 0, 255).astype(np.uint8)


def face_blob_image(w=640, h=480, n=20, seed=3, size=(20, 60), margin=60):
    """(h, w) uint8 frame with n face blobs of radius in [size) at least
    `margin` px from the border, blurred, plus ±8 uniform noise."""
    rng = np.random.default_rng(seed)
    img = np.full((h, w), 128, np.uint8)
    for _ in range(n):
        cx = int(rng.integers(margin, w - margin))
        cy = int(rng.integers(margin, h - margin))
        s = int(rng.integers(*size))
        _fill_ellipse(img, cx, cy, s, int(s * 1.25), int(rng.integers(180, 230)))
        for ex in (-1, 1):
            r = max(2, s // 8)
            _fill_ellipse(img, cx + ex * s // 3, cy - s // 4, r, r,
                          int(rng.integers(30, 80)))
        _fill_ellipse(img, cx, cy + s // 2, s // 3, s // 8,
                      int(rng.integers(40, 90)))
    img = _gauss_blur5(img, 1.5)
    noise = rng.integers(-8, 8, img.shape).astype(np.int16)
    return np.clip(img.astype(np.int16) + noise, 0, 255).astype(np.uint8)


def bench_frame(k=0, h=1080, w=1920):
    """Frame k of the detection benchmark's crowded scene: 40 faces of
    radius 25..119 px."""
    return face_blob_image(w, h, n=40, seed=3 + k, size=(25, 120),
                           margin=80)


# Frames whose OpenCV detections are committed as goldens
# (tests/golden/detect/, written by oracle/make_goldens.py).
GOLDEN_FRAMES = {
    "1920x1080": dict(w=1920, h=1080, n=40, seed=3, size=(25, 120),
                      margin=80),
    "640x480": dict(w=640, h=480, n=8, seed=11, size=(20, 60), margin=60),
}
GOLDEN_CASCADES = {"haar": HAAR_FRONTALFACE_ALT, "lbp": LBP_FRONTALFACE}
GOLDEN_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))),
    "tests", "golden", "detect",
)
GOLDEN_SCALE = 1.1


def golden_frame(key):
    return face_blob_image(**GOLDEN_FRAMES[key])


def golden_path(cascade, key, min_neighbors):
    spec = GOLDEN_FRAMES[key]
    return os.path.join(
        GOLDEN_DIR,
        f"{cascade}_{key}_seed{spec['seed']}_mn{min_neighbors}.txt",
    )


def read_golden(cascade, key, min_neighbors):
    """The OpenCV C++ runtime's rects for a golden frame, in its order:
    (N, 4) int32 (x, y, w, h)."""
    rows = []
    with open(golden_path(cascade, key, min_neighbors)) as f:
        for line in f:
            if line.strip() and not line.startswith("#"):
                rows.append([int(v) for v in line.split()])
    return np.asarray(rows, np.int32).reshape(-1, 4)


def face_samples(n, seed, win=24, jitter=2):
    """(n, win, win) uint8 training positives: one face blob per sample,
    off centre by up to `jitter` px, with varied size, contrast, lighting
    gradient and noise."""
    rng = np.random.default_rng(seed)
    out = np.empty((n, win, win), np.uint8)
    yy, xx = np.mgrid[0:win, 0:win]
    for i in range(n):
        img = np.full((win, win), int(rng.integers(80, 176)), np.uint8)
        c = win // 2
        cx = c + int(rng.integers(-jitter, jitter + 1))
        cy = c + int(rng.integers(-jitter, jitter + 1))
        s = int(rng.integers(win // 4, win * 3 // 8 + 1))
        face = int(rng.integers(150, 240))
        _fill_ellipse(img, cx, cy, s, int(s * 1.25), face)
        dark = int(rng.integers(20, 110))
        for ex in (-1, 1):
            r = max(1, s // 5)
            _fill_ellipse(img, cx + ex * s // 2, cy - s // 3, r, r, dark)
        _fill_ellipse(img, cx, cy + s // 2, s // 2, max(1, s // 5),
                      int(rng.integers(30, 120)))
        img = _gauss_blur5(img, float(rng.uniform(0.8, 1.6)))
        g = rng.uniform(-1.5, 1.5, 2)
        light = g[0] * (xx - c) + g[1] * (yy - c)
        noise = rng.integers(-10, 11, img.shape)
        out[i] = np.clip(img + light + noise, 0, 255)
    return out


def clutter_image(w, h, seed, density=1.0):
    """(h, w) uint8 background without faces, dense with near-misses:
    face blobs missing an eye or the mouth, with displaced features or
    inverted contrast, plus plain blobs and bars — hard negatives that
    keep a face cascade's early stages accepting a large share of
    windows. density scales the shape count (1.0: about one shape per
    16x16 px)."""
    rng = np.random.default_rng(seed)
    img = np.full((h, w), int(rng.integers(90, 170)), np.uint8)
    for _ in range(int(density * w * h / 256)):
        cx, cy = int(rng.integers(0, w)), int(rng.integers(0, h))
        s = int(rng.integers(5, 16))
        kind = int(rng.integers(0, 6))
        if kind == 0:  # plain blob
            _fill_ellipse(img, cx, cy, s, int(s * rng.uniform(0.6, 1.5)),
                          int(rng.integers(0, 256)))
            continue
        if kind == 1:  # bar
            img[max(cy - s // 3, 0):cy + s // 3 + 1,
                max(cx - s, 0):cx + s + 1] = int(rng.integers(0, 256))
            continue
        face, dark = int(rng.integers(170, 230)), int(rng.integers(30, 90))
        if kind == 5:  # inverted contrast
            face, dark = dark, face
        _fill_ellipse(img, cx, cy, s, int(s * 1.25), face)
        eyes = (-1, 1) if kind != 2 else (int(rng.choice([-1, 1])),)
        dy = -s // 3 if kind != 4 else int(rng.integers(0, s // 2 + 1))
        for ex in eyes:
            r = max(1, s // 5)
            _fill_ellipse(img, cx + ex * s // 2, cy + dy, r, r, dark)
        if kind != 3:  # kind 3: no mouth
            _fill_ellipse(img, cx, cy + s // 2, s // 2, max(1, s // 5), dark)
    img = _gauss_blur5(img, 1.0)
    noise = rng.integers(-8, 8, img.shape).astype(np.int16)
    return np.clip(img.astype(np.int16) + noise, 0, 255).astype(np.uint8)


def near_face_image(w, h, seed, win=24):
    """(h, w) uint8 background of hard negatives on a win-sized grid:
    each cell holds a face sample shifted 4..8 px off centre, rescaled,
    or with an eye erased, or clutter."""
    rng = np.random.default_rng(seed)
    gh, gw = -(-h // win), -(-w // win)
    cells = face_samples(gh * gw, seed, win)
    img = clutter_image(gw * win, gh * win, seed + 1)
    for k in range(gh * gw):
        y, x = (k // gw) * win, (k % gw) * win
        kind = int(rng.integers(0, 4))
        if kind == 0:
            continue  # clutter cell
        cell = cells[k].copy()
        if kind == 1:  # erase an eye (paint it with the cheek value)
            ex = win // 2 + int(rng.choice([-1, 1])) * (win // 5)
            cell[win // 4: win // 2, ex - 3: ex + 3] = cell[win // 2, win // 2]
        elif kind == 2:  # rescale about the centre
            f = float(rng.choice([0.6, 0.75, 1.4, 1.7]))
            src = np.clip(((np.arange(win) - win / 2) / f + win / 2)
                          .astype(int), 0, win - 1)
            cell = cell[src][:, src]
        dy, dx = (int(rng.choice([-1, 1])) * int(rng.integers(4, 9))
                  for _ in range(2))
        img[y:y + win, x:x + win] = np.roll(cell, (dy, dx), (0, 1))
    return img[:h, :w]
