"""Benchmark: multi-scale Haar face detection throughput at 1080p on one GPU.

    python bench.py                        # the default (auto) engine
    python bench.py fused compact

Each positional argument is an engine (auto | fused | compact | xla).
Engines are timed in turns (A B … B A) in this one process, so they
share the card and its clocks. Prints the card (device kind, nvidia-smi name and power limit),
then one JSON line per configuration:
{"metric", "value", "unit", "config", "device"}.

Frames are the seeded synthetic crowded scene (cascadeclassifier_tpu/
data/synth.py::bench_frame), staged in device memory before the timed
region; the timed region covers every detection dispatch, the result
fetches and host grouping. Before timing, frame 0's grouped detections
are checked against the OpenCV C++ runtime: the committed golden at the
default 1080p size, else oracle/detect_oracle when it is built.

Env: BENCH_FRAMES (32), BENCH_H (1080), BENCH_W (1920), BENCH_EXACT (0).
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

from cascadeclassifier_tpu.data import synth


def require_gpu():
    """The first JAX device, which must be a GPU; prints the card."""
    import jax

    d = jax.devices()[0]
    if d.platform != "gpu":
        raise SystemExit(f"needs a GPU; JAX's first device is {d.platform}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"# device: {d.device_kind} x{len(jax.devices())}; "
          f"nvidia-smi: {smi}", flush=True)
    return d, smi


def oracle_rects(xml, frame, sf, mn):
    oracle = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "oracle", "detect_oracle")
    if not os.path.exists(oracle):
        return None
    from cascadeclassifier_tpu.data.negreader import write_pgm

    with tempfile.TemporaryDirectory() as td:
        p = os.path.join(td, "frame.pgm")
        write_pgm(p, frame)
        out = subprocess.run(
            [oracle, xml, p, str(sf), str(mn)], capture_output=True,
            text=True, check=True,
        ).stdout.splitlines()
    assert out and out[0].strip() == "LOADED"
    return np.asarray([[int(v) for v in l.split()] for l in out[1:]
                       if l.strip()], np.int32).reshape(-1, 4)


def main(argv=None):
    import jax
    import jax.numpy as jnp

    from cascadeclassifier_tpu.detect.detector import TPUDetector
    from cascadeclassifier_tpu.models.xml_io import read_cascade_xml

    specs = (argv if argv is not None else sys.argv[1:]) or ["auto"]
    dev, smi = require_gpu()
    xml = synth.HAAR_FRONTALFACE_ALT
    model = read_cascade_xml(xml)
    exact = bool(int(os.environ.get("BENCH_EXACT", "0")))
    n_frames = int(os.environ.get("BENCH_FRAMES", "32"))
    bh = int(os.environ.get("BENCH_H", "1080"))
    bw = int(os.environ.get("BENCH_W", "1920"))
    frames = [synth.bench_frame(k, bh, bw) for k in range(n_frames)]
    sf, mn = 1.1, 3

    if (bw, bh) == (1920, 1080):
        want = synth.read_golden("haar", "1920x1080", mn)
    else:
        want = oracle_rects(xml, frames[0], sf, mn)
    dets = {s: TPUDetector(model, exact=exact, engine=s) for s in specs}
    for s, det in dets.items():
        got = det.detect_multi_scale(frames[0], sf, mn)
        if want is None:
            print(f"# {s}: no oracle for {bw}x{bh}; parity not checked",
                  flush=True)
        elif sorted(map(tuple, np.asarray(got).tolist())) != sorted(
                map(tuple, want.tolist())):
            raise SystemExit(f"{s}: detections differ from the oracle")

    stack = jnp.asarray(np.stack(frames))
    stack.block_until_ready()
    for det in dets.values():  # warm every program and batch shape
        det.detect_multi_scale_batch(stack, sf, mn)
    times = {s: [] for s in specs}
    for order in (specs, specs[::-1]):
        for s in order:
            t0 = time.perf_counter()
            res = dets[s].detect_multi_scale_batch(stack, sf, mn)
            times[s].append(time.perf_counter() - t0)
            assert len(res) == n_frames
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    for s in specs:
        dt = min(times[s])
        print(json.dumps({
            "metric": f"haar_{bh}p_multiscale_detect",
            "value": n_frames / dt,
            "unit": "frames/sec",
            "ms_per_frame": dt / n_frames * 1e3,
            "config": f"{s} (engine={dets[s].engine}, exact={exact})",
            "device": device,
            "nvidia_smi": smi,
        }), flush=True)


if __name__ == "__main__":
    main()
