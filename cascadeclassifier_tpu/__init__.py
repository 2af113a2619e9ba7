"""cascadeclassifier_tpu — a TPU-native Viola–Jones cascade framework.

A ground-up JAX/XLA/Pallas re-design of the capabilities of the reference
OpenCV ``opencv_traincascade`` suite (vladiant/CascadeClassifier):

- batched integral-image kernels (sum / squared-sum / tilted)
- vectorized Haar / LBP / HOG feature catalogs and evaluators
- a dense multi-scale sliding-window detector with survivor compaction
- a GAB/DAB/RAB/LB boosted-cascade trainer built on sort-based exact
  weighted split search (vectorized over the whole feature axis)
- OpenCV-compatible cascade.xml / params.xml / stageN.xml round-trip I/O
- sample tooling (.vec read/write, background mining, sample synthesis)
- multi-chip scaling via jax.sharding (feature-sharded split search,
  window/batch data parallelism)

The compute path is pure JAX (jit/pjit/shard_map + Pallas); host-side IO has
a native C++ companion library (csrc/) with a Python fallback.
"""

__version__ = "0.1.0"

import os as _os

import jax as _jax


def compile_cache_dir() -> str:
    """Where compiled programs persist across processes:
    $JAX_COMPILATION_CACHE_DIR when set, else .jax_cache in the checkout
    (a fixed path — the path is part of the cache key)."""
    return _os.environ.get("JAX_COMPILATION_CACHE_DIR") or _os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
        ".jax_cache",
    )


# detector/trainer programs are large: keep compiled code across processes
_jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
_jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

from cascadeclassifier_tpu.models.model import (  # noqa: F401
    CascadeModel,
    Stage,
    WeakTree,
    HaarFeature,
    LBPFeature,
    HOGFeature,
)
