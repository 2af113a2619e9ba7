"""Training benchmark: 20-stage 24x24 HAAR cascade.

Runs CascadeTrainer on however many devices are visible and reports
wall-clock seconds to the reference's stop (numStages or the
required-leaf-FA stop). Data is generated on the fly with the
createsamples twin (bit-exact reference distortion pipeline): positives
are random 3-D distortions of a synthetic high-contrast mark over
textured backgrounds, negatives are mined from the same textured
background pool (drawing them needs OpenCV's Python bindings).

Prints ONE JSON line. Env knobs:
  BENCH_TRAIN_POS / _NEG / _STAGES — scale down for smoke runs.
"""

import json
import os
import sys
import tempfile
import time

import numpy as np


def _make_data(td, n_pos, n_bg=None, bg_h=None, bg_w=None):
    import cv2

    n_bg = n_bg or int(os.environ.get("BENCH_TRAIN_BGS", "100"))
    bg_h = bg_h or int(os.environ.get("BENCH_TRAIN_BG_H", "1080"))
    bg_w = bg_w or int(os.environ.get("BENCH_TRAIN_BG_W", "1920"))
    rng = np.random.default_rng(42)
    # high-contrast object mark on a mid-gray card
    obj = np.full((48, 48), 200, np.uint8)
    cv2.rectangle(obj, (6, 6), (41, 41), 20, 4)
    cv2.circle(obj, (24, 24), 9, 20, -1)
    obj_path = os.path.join(td, "obj.png")
    cv2.imwrite(obj_path, obj)

    bg_list = []
    density = max(1, (bg_h * bg_w) // 880)  # ~350 shapes per 640x480
    for k in range(n_bg):
        # structured, object-confusable clutter (rectangles, rings,
        # bars): early stages then reject ~half the windows per stage
        # like real data, instead of FA=0 stages that starve the
        # hard-negative miner. The corpus is sized to the scored regime
        # (default 100 distinct 1080p backgrounds): late-stage mining
        # must stream ~10^8-10^9 candidate windows, like the
        # reference's fillPassedSamples over a real photo corpus
        # (cascadeclassifier.cpp:329-357).
        bg = np.full((bg_h, bg_w), 128, np.uint8)
        for _ in range(density):
            x = int(rng.integers(0, bg_w - 40))
            y = int(rng.integers(0, bg_h - 40))
            s = int(rng.integers(8, 60))
            g = int(rng.integers(0, 256))
            kind = rng.integers(0, 3)
            if kind == 0:
                cv2.rectangle(bg, (x, y), (x + s, y + s), g,
                              int(rng.integers(1, 5)))
            elif kind == 1:
                cv2.circle(bg, (x, y), s // 2, g, int(rng.integers(1, 5)))
            else:
                cv2.line(bg, (x, y), (x + s, y + int(rng.integers(0, s))),
                         g, int(rng.integers(1, 4)))
        # Hard-negative decoys: near-miss variants of the positive mark,
        # on a difficulty spectrum from crudely-different to
        # almost-identical (jittered dot / thinner border / occlusions).
        # Generic clutter alone lets every stage reject ~2/3 of windows
        # (measured r5: acceptance 1.2e-5 after 6 stages), which both
        # explodes late-stage mining (10^9 candidate windows/stage) and
        # triggers the required-leaf-FA stop long before 20 stages. The
        # reference's 20+-stage transcripts (res/README.md) come from
        # real corpora whose hardest windows keep per-stage FA near the
        # 0.5 target — decoys reproduce that FA profile, exactly like
        # fillPassedSamples re-feeding the hardest survivors
        # (cascadeclassifier.cpp:329-357).
        n_decoy = max(1, density // 12)
        for _ in range(n_decoy):
            d = np.full((48, 48), 200, np.uint8)
            dk = int(rng.integers(0, 6))
            if dk == 0:  # border only (no dot)
                cv2.rectangle(d, (6, 6), (41, 41), 20, 4)
            elif dk == 1:  # dot only (no border)
                cv2.circle(d, (24, 24), 9, 20, -1)
            elif dk == 2:  # jittered near-twin: offset / resized dot
                cv2.rectangle(d, (6, 6), (41, 41), 20, 4)
                dx, dy = int(rng.integers(2, 7)), int(rng.integers(2, 7))
                cv2.circle(d, (24 + dx, 24 + dy),
                           int(rng.integers(4, 8)), 20, -1)
            elif dk == 3:  # polarity-inverted mark
                cv2.rectangle(d, (6, 6), (41, 41), 20, 4)
                cv2.circle(d, (24, 24), 9, 20, -1)
                d = (220 - d.astype(np.int16)).clip(0, 255).astype(
                    np.uint8
                )
            elif dk == 4:  # occluded mark (bar through it)
                cv2.rectangle(d, (6, 6), (41, 41), 20, 4)
                cv2.circle(d, (24, 24), 9, 20, -1)
                o = int(rng.integers(10, 38))
                cv2.rectangle(d, (0, o), (47, o + 6),
                              int(rng.integers(90, 170)), -1)
            else:  # thin-border variant
                cv2.rectangle(d, (6, 6), (41, 41), 20, 2)
                cv2.circle(d, (24, 24), int(rng.integers(6, 9)), 20, -1)
            ds = int(rng.integers(18, 80))
            x = int(rng.integers(0, bg_w - ds))
            y = int(rng.integers(0, bg_h - ds))
            bg[y : y + ds, x : x + ds] = cv2.resize(
                d, (ds, ds), interpolation=cv2.INTER_LINEAR
            )
        bg = cv2.GaussianBlur(bg, (3, 3), 0.8)
        p = os.path.join(td, f"bg{k}.png")
        cv2.imwrite(p, bg)
        bg_list.append(p)
    bg_txt = os.path.join(td, "bg.txt")
    with open(bg_txt, "w") as f:
        f.write("\n".join(bg_list) + "\n")

    from cascadeclassifier_tpu.tools.createsamples import (
        create_training_samples,
    )

    vec = os.path.join(td, "pos.vec")
    create_training_samples(
        vec, obj_path, n_pos, bgcolor=0, bgthreshold=10, bg_path=bg_txt,
        win_w=24, win_h=24,
    )
    return vec, bg_txt


def main():
    from cascadeclassifier_tpu.train.boost import BoostParams
    from cascadeclassifier_tpu.train.trainer import CascadeTrainer

    n_pos = int(os.environ.get("BENCH_TRAIN_POS", "1000"))
    n_neg = int(os.environ.get("BENCH_TRAIN_NEG", "2000"))
    n_stages = int(os.environ.get("BENCH_TRAIN_STAGES", "20"))

    td = tempfile.mkdtemp(prefix="cctpu_bench_train_")
    vec, bg = _make_data(td, n_pos + 200)

    import jax

    mesh = None
    if len(jax.devices()) > 1:
        from cascadeclassifier_tpu.parallel.sharded import make_mesh

        mesh = make_mesh()
        print(f"# feature mesh over {len(jax.devices())} devices",
              file=sys.stderr)
    tr = CascadeTrainer(
        win_w=24, win_h=24, boost=BoostParams(),
        precalc_val_mb=4096.0, precalc_idx_mb=8192.0,
        mesh=mesh,
        mining_batch=int(os.environ.get("BENCH_TRAIN_MINE_BATCH",
                                        str(1 << 18))),
    )
    t0 = time.time()
    model = tr.train(
        os.path.join(td, "data"), vec, bg, num_pos=n_pos, num_neg=n_neg,
        num_stages=n_stages, verbose=bool(int(os.environ.get(
            "BENCH_TRAIN_VERBOSE", "1"))),
    )
    dt = time.time() - t0
    stages_done = len(tr.stages)

    from cascadeclassifier_tpu.utils.profiling import timings

    for name, ts in sorted(timings().items(), key=lambda kv: -sum(kv[1])):
        print(f"# phase {name}: {sum(ts):8.1f}s over {len(ts)} calls",
              file=sys.stderr)

    d = jax.devices()[0]
    print(
        json.dumps(
            {
                "metric": "haar_24x24_20stage_train",
                "value": dt,
                "unit": f"seconds ({stages_done}/{n_stages} stages, "
                        f"{n_pos}p/{n_neg}n)",
                "device": {"platform": d.platform, "kind": d.device_kind,
                           "count": len(jax.devices())},
            }
        )
    )
    sys.stdout.flush()
    return model


if __name__ == "__main__":
    main()
