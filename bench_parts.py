"""Per-phase detection timing and roofline table for the fused engine on
one GPU:

    python bench_parts.py              # 1080p
    BENCH_H=480 BENCH_W=640 python bench_parts.py

For every chained program of the fused engine (canvas, prep, each front
program, tail) it reports:
  - steady-state ms per dispatch (N dispatches ending in
    block_until_ready)
  - bytes of operands + results (a lower bound on device-memory traffic,
    ignoring XLA temporaries)
  - the least time those bytes take at the card's peak memory bandwidth
    (PEAKS, keyed by device_kind) and the share of it achieved
"""

import json
import os
import time

import numpy as np

# Published peaks, dense, no sparsity. A device missing here is an error.
PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(
        hbm_gbps=3350.0, bf16_tflops=989.0, tf32_tflops=495.0,
        fp32_tflops=67.0,
        source="NVIDIA H100 Tensor Core GPU data sheet, SXM5 column",
    ),
}


def peaks_for(device_kind):
    if device_kind not in PEAKS:
        raise SystemExit(f"no published peaks for {device_kind!r}")
    return PEAKS[device_kind]


def _nbytes(tree):
    import jax

    return sum(
        x.size * x.dtype.itemsize
        for x in jax.tree_util.tree_leaves(tree)
        if hasattr(x, "dtype")
    )


class Timer:
    def __init__(self, hbm_gbps, iters=None):
        self.iters = int(os.environ.get("BENCH_PART_ITERS", iters or 30))
        self.hbm_gbps = hbm_gbps
        self.rows = []

    def time(self, name, fn, *args):
        import jax

        out = jax.block_until_ready(fn(*args))  # compile + warm
        t0 = time.perf_counter()
        for _ in range(self.iters):
            out = fn(*args)
        jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / self.iters
        bts = _nbytes(args) + _nbytes(out)
        roof = bts / (self.hbm_gbps * 1e9)
        self.rows.append(dict(
            phase=name, ms=dt * 1e3, mb=bts / 1e6, roof_ms=roof * 1e3,
            pct_roof=100 * roof / dt if dt > 0 else 0.0,
        ))
        return out

    def report(self):
        w = max(len(r["phase"]) for r in self.rows)
        print(f"{'phase'.ljust(w)}  {'ms':>9}  {'MB':>8}  {'roof ms':>8} "
              f" {'% roof':>7}")
        tot = 0.0
        for r in self.rows:
            tot += r["ms"]
            print(f"{r['phase'].ljust(w)}  {r['ms']:>9.3f}  {r['mb']:>8.1f} "
                  f" {r['roof_ms']:>8.3f}  {r['pct_roof']:>7.1f}")
        print(f"{'TOTAL (sum of parts)'.ljust(w)}  {tot:>9.3f}")
        print(json.dumps({"parts": self.rows, "total_ms": tot}))


def main():
    import jax.numpy as jnp

    from bench import require_gpu
    from cascadeclassifier_tpu.data import synth
    from cascadeclassifier_tpu.detect.detector import PackedCascade, plan_tables
    from cascadeclassifier_tpu.detect.engine import FusedEngine
    from cascadeclassifier_tpu.detect.pyramid import build_plan
    from cascadeclassifier_tpu.models.xml_io import read_cascade_xml

    dev, _smi = require_gpu()
    peaks = peaks_for(dev.device_kind)
    model = read_cascade_xml(
        os.environ.get("BENCH_XML", synth.HAAR_FRONTALFACE_ALT)
    )
    packed = PackedCascade.from_model(model)
    eng = FusedEngine(packed, exact=False)
    bh = int(os.environ.get("BENCH_H", "1080"))
    bw = int(os.environ.get("BENCH_W", "1920"))
    img = synth.bench_frame(0, bh, bw)
    max_det = 1 << 14
    plan = build_plan(bw, bh, packed.win_w, packed.win_h, 1.1)
    tab = plan_tables(plan)
    (canvas, prep), fronts, tail, (R, Cs) = eng.program(plan, max_det)
    print(f"# {bw}x{bh} canvas {plan.canvas_h}x{plan.canvas_w} "
          f"({plan.canvas_h * plan.canvas_w / 1e6:.1f}M cells), "
          f"n_dense={eng.n_dense}, front programs {len(fronts)}; "
          f"peaks: {peaks['hbm_gbps']} GB/s ({peaks['source']})")
    t = Timer(peaks["hbm_gbps"])
    dimg = jnp.asarray(img)
    sum2d, sq2d, tilt2d = t.time("canvas", canvas, dimg, tab, R, Cs)
    inv_nf, alive = t.time("prep", prep, sum2d, sq2d, tilt2d, tab)
    for i, f in enumerate(fronts):
        alive = t.time(f"front[{i}]", f, sum2d, tilt2d, inv_nf, alive)
    out = t.time("tail", tail, sum2d, tilt2d, inv_nf, alive)
    fidx, fcnt, cnt, oflow = (np.asarray(x) for x in out)
    print(f"# front survivors={int(cnt)}, detections={int(fcnt)}, "
          f"overflow={bool(oflow)}")
    t.report()


if __name__ == "__main__":
    main()
