"""The detector's one decision keyed on the platform it runs on.

``engine="auto"`` picks its engine here, from ``jax.default_backend()``;
nothing else in the detector branches on the platform. Tests pass
``backend`` explicitly.
"""

from __future__ import annotations

import jax


def auto_engine(can_fused: bool, can_stump_haar: bool,
                backend: str | None = None) -> str:
    """Engine for engine="auto".

    On a GPU the fused engine (no host round trip per frame) is the
    faster end to end at 1080p on an H100 (CHANGES.md); elsewhere the
    host-adaptive compact engine serves. Where the cascade rules the
    choice out (fused takes Haar/LBP, compact stump Haar only), the
    dense XLA engine serves it."""
    backend = backend or jax.default_backend()
    if backend == "gpu" and can_fused:
        return "fused"
    return "compact" if can_stump_haar else "xla"
