"""Hard-negative mining profiler.

Reproduces the late-stage mining regime with a synthetic stump cascade
whose per-stage acceptance is calibrated to ~0.5 (like real training),
then times `_fill_negatives` end-to-end with the trainer's phase scopes.
Acceptance after S stages ~ 0.5^S, so BENCH_MINE_STAGES=12 matches the
stage-5..6 regime and 16 matches stage 8-9 (1.5e-5).

    python bench_mine.py                      # 12 stages, 500 negs
    BENCH_MINE_STAGES=16 BENCH_MINE_COUNT=200 python bench_mine.py

Prints per-phase host wall-clock (mine_gather / mine_resize /
mine_extract / mine_values / mine_fetch) and the effective µs/window.
"""

import os
import sys
import tempfile
import time

import numpy as np


def main():
    n_stages = int(os.environ.get("BENCH_MINE_STAGES", "12"))
    count = int(os.environ.get("BENCH_MINE_COUNT", "500"))
    trees_per_stage = int(os.environ.get("BENCH_MINE_TREES", "6"))

    td = tempfile.mkdtemp(prefix="cctpu_bench_mine_")
    from bench_train import _make_data

    _vec, bg = _make_data(td, 1)

    from cascadeclassifier_tpu.data import negreader as nr_mod
    from cascadeclassifier_tpu.data.negreader import NegReader
    from cascadeclassifier_tpu.models.model import Stage, WeakTree
    from cascadeclassifier_tpu.ops.features import HAAR_BASIC, haar_catalog
    from cascadeclassifier_tpu.train.trainer import CascadeTrainer
    from cascadeclassifier_tpu.utils import profiling
    from cascadeclassifier_tpu.utils.profiling import timed, timings

    # count host-side exact resizes (the level-crossing cost)
    orig_resize = nr_mod.resize_linear_exact_np

    def timed_resize(*a, **k):
        with timed("mine_resize"):
            return orig_resize(*a, **k)

    nr_mod.resize_linear_exact_np = timed_resize

    tr = CascadeTrainer(win_w=24, win_h=24,
                        mining_batch=int(os.environ.get(
                            "BENCH_MINE_BATCH", str(1 << 18))))
    cat = haar_catalog(24, 24, HAAR_BASIC)
    rng = np.random.default_rng(0)
    n_feat = len(cat.rects)

    # calibrate: evaluate candidate stumps on a window sample, set each
    # stage threshold at the median of its (surviving) response sums
    neg0 = NegReader(bg, 24, 24)
    sample = neg0.take_batch(4096)
    ev = tr.evaluator
    m = sample.shape[0]
    m_pad = -(-m // 256) * 256
    sample_p = np.concatenate(
        [sample, np.zeros((m_pad - m, 24, 24), np.uint8)])
    ev.set_samples(sample_p)

    stages = []
    alive = np.ones(m, bool)
    for si in range(n_stages):
        fidx = rng.choice(n_feat, trees_per_stage, replace=False).astype(int)
        vals = np.asarray(ev.values_for_vars(list(fidx)))[:, :m]  # (T, m)
        thr = np.median(vals[:, alive], axis=1)
        leaf = np.where(vals <= thr[:, None], 1.0, -1.0)  # (T, m)
        ssum = leaf.sum(axis=0)
        sthr = float(np.median(ssum[alive])) - 0.5
        trees = [
            WeakTree(
                left=np.array([-1], np.int32), right=np.array([-2], np.int32),
                feature_idx=np.array([fidx[t]], np.int32),
                threshold=np.array([thr[t]], np.float32),
                leaf_values=np.array([0.0, 1.0, -1.0], np.float32),
            )
            for t in range(trees_per_stage)
        ]
        stages.append(Stage(threshold=sthr, trees=trees))
        ok = ssum >= sthr - 1e-5
        alive &= ok
        print(f"# stage {si}: pass={alive.mean():.3f}", file=sys.stderr)
    tr.stages = stages

    profiling.reset_timings()
    neg = NegReader(bg, 24, 24, lazy=True)
    consumed = [0]
    t0 = time.time()
    kept = tr._fill_negatives(neg, count, 1e-12, consumed)
    dt = time.time() - t0
    print(f"# kept={len(kept)} consumed={consumed[0]} "
          f"acceptance={len(kept) / max(consumed[0], 1):.3g}",
          file=sys.stderr)
    for name, ts in sorted(timings().items(), key=lambda kv: -sum(kv[1])):
        rest = ts[1:] if len(ts) > 1 else ts
        print(f"# {name:16s} {sum(ts):8.2f}s over {len(ts):6d} calls  "
              f"first={ts[0]:.2f}s steady={sum(rest) / len(rest):.3f}s",
              file=sys.stderr)
    print(f"# total {dt:.2f}s  -> {dt / max(consumed[0], 1) * 1e6:.2f} "
          f"us/window", file=sys.stderr)


if __name__ == "__main__":
    main()
