"""Regenerate tests/golden/detect/: the OpenCV C++ runtime's detections
(oracle/detect_oracle) on the seeded synthetic golden frames.

    make -C oracle detect_oracle && python oracle/make_goldens.py

Needs the oracle binary (system OpenCV 4.x C++); the frames come from the
package's numpy generator and are written as PGM.
"""

import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cascadeclassifier_tpu.data.negreader import write_pgm  # noqa: E402
from cascadeclassifier_tpu.data.synth import (  # noqa: E402
    GOLDEN_CASCADES,
    GOLDEN_DIR,
    GOLDEN_FRAMES,
    GOLDEN_SCALE,
    golden_frame,
    golden_path,
)

ORACLE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "detect_oracle")


def main():
    os.makedirs(GOLDEN_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory() as td:
        for key, spec in GOLDEN_FRAMES.items():
            img = os.path.join(td, f"{key}.pgm")
            write_pgm(img, golden_frame(key))
            for cascade, xml in GOLDEN_CASCADES.items():
                for mn in (0, 3):
                    out = subprocess.run(
                        [ORACLE, xml, img, str(GOLDEN_SCALE), str(mn)],
                        capture_output=True, text=True, check=True,
                    ).stdout.splitlines()
                    assert out[0] == "LOADED", out[:1]
                    spec_s = ", ".join(f"{k}={v}" for k, v in spec.items())
                    with open(golden_path(cascade, key, mn), "w") as f:
                        f.write(
                            f"# oracle/detect_oracle {os.path.basename(xml)}"
                            f" on face_blob_image({spec_s})"
                            f" scale_factor={GOLDEN_SCALE}"
                            f" min_neighbors={mn}\n"
                        )
                        f.write("\n".join(out[1:]) + "\n")
                    print(cascade, key, mn, len(out) - 1)


if __name__ == "__main__":
    main()
