"""Native detection CLI — the framework's own detectMultiScale front end.

Replaces the reference detection samples (tools/detection/Cpp/main.cpp,
Python/detect.py), which delegate to OpenCV's runtime; here the JAX
detector runs the cascade itself. Defaults match the reference sample
(scaleFactor=4, minNeighbors=50 — main.cpp:45)."""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(prog="tpu-detect")
    p.add_argument("cascade", help="cascade.xml")
    p.add_argument("image", help="input image")
    p.add_argument("--scale-factor", type=float, default=4.0)
    p.add_argument("--min-neighbors", type=int, default=50)
    p.add_argument("--min-size", type=int, nargs=2, default=None)
    p.add_argument("--max-size", type=int, nargs=2, default=None)
    p.add_argument("-o", "--output", default=None,
                   help="write annotated image here")
    p.add_argument("--fast", action="store_true",
                   help="float32 stage sums (near-exact)")
    p.add_argument("--engine",
                   choices=["auto", "fused", "xla", "compact"],
                   default="auto", help="stage-evaluation engine")
    args = p.parse_args(argv)

    import cv2

    from cascadeclassifier_tpu.detect.detector import TPUDetector
    from cascadeclassifier_tpu.models.model import FEATURE_HOG
    from cascadeclassifier_tpu.models.xml_io import read_cascade_xml

    img = cv2.imread(args.image, cv2.IMREAD_GRAYSCALE)
    if img is None:
        print(f"cannot read {args.image}", file=sys.stderr)
        return 1
    model = read_cascade_xml(args.cascade)
    if model.feature_type == FEATURE_HOG:
        # HOG cascades: the OpenCV runtime cannot serve these at all
        # (reference trains but never detects HOG, SURVEY §2.3); route to
        # the crop-consistent HOG detector (engine flags do not apply)
        from cascadeclassifier_tpu.detect.hog_detector import HOGDetector

        print(
            "note: HOG cascades run the crop-consistent host-loop "
            "detector (per-window evaluation; orders of magnitude "
            "slower than the fused Haar/LBP engines — see "
            "ARCHITECTURE.md)",
            file=sys.stderr,
        )
        det = HOGDetector(model)
    else:
        det = TPUDetector(model, exact=not args.fast, engine=args.engine)
    rects = det.detect_multi_scale(
        img,
        scale_factor=args.scale_factor,
        min_neighbors=args.min_neighbors,
        min_size=args.min_size,
        max_size=args.max_size,
    )
    for (x, y, w, h) in rects:
        print(f"{x} {y} {w} {h}")
    if args.output:
        vis = cv2.cvtColor(img, cv2.COLOR_GRAY2BGR)
        for (x, y, w, h) in rects:
            cv2.rectangle(vis, (int(x), int(y)), (int(x + w), int(y + h)),
                          (0, 0, 255), 2)
        cv2.imwrite(args.output, vis)
    return 0


if __name__ == "__main__":
    sys.exit(main())
