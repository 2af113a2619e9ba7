"""Worker process for the multi-host (DCN) execution test.

Each process owns ONE CPU device; `sharded.init_distributed` brings up
`jax.distributed` so `jax.devices()` spans both processes, and the
feature-sharded split search runs over the 2-device global mesh with its
all_gather riding the inter-process (DCN-path) backend. This executes
the same code path a real multi-host cluster uses (SURVEY §2.6 / §7
step 7) — the reference has no distributed capability at all.

Usage: python multihost_worker.py <process_id> <coordinator> <out_json>
"""

import json
import os
import sys

pid = int(sys.argv[1])
coord = sys.argv[2]
out = sys.argv[3]

# one CPU device per process; must be set before jax import
os.environ["JAX_PLATFORM_NAME"] = "cpu"
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: E402

from cascadeclassifier_tpu.parallel.sharded import (  # noqa: E402
    init_distributed,
    sharded_ordered_best_split,
)
from cascadeclassifier_tpu.train.boost import as_f64  # noqa: E402


def main():
    init_distributed(coord, 2, pid)
    devs = jax.devices()
    assert len(devs) == 2, devs
    assert jax.process_count() == 2
    mesh = Mesh(np.array(devs), ("feat",))

    # the SAME problem the in-process mesh test uses (seed 0, 64x96)
    rng = np.random.default_rng(0)
    f, n = 64, 96
    values = rng.normal(size=(f, n)).astype(np.float32)
    sort_idx = np.argsort(values, axis=1).astype(np.int32)
    w = rng.uniform(0.1, 1, n)
    w /= w.sum()
    resp = rng.choice([-1.0, 1.0], n)
    mask = np.ones(n, bool)

    # each process contributes only ITS half of the feature axis — the
    # global (F, N) array is assembled from process-local shards, as a
    # multi-host data loader would
    sh = NamedSharding(mesh, P("feat", None))
    half = f // 2
    lo, hi = pid * half, (pid + 1) * half
    vs = jax.make_array_from_process_local_data(sh, values[lo:hi])
    si = jax.make_array_from_process_local_data(sh, sort_idx[lo:hi])

    fn = sharded_ordered_best_split(mesh)
    gq, gvar, gthr = fn(vs, si, as_f64(w), as_f64(resp), jnp.asarray(mask))
    res = {
        "process_id": pid,
        "quality": float(gq),
        "var": int(gvar),
        "threshold": float(gthr),
    }
    with open(out, "w") as fo:
        json.dump(res, fo)
    jax.distributed.shutdown()


if __name__ == "__main__":
    main()
