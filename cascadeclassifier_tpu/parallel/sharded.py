"""Multi-chip sharding for training and detection.

The reference is strictly single-process (SURVEY §2.6); scaling is a new,
first-class subsystem here, built on `jax.sharding`:

  - **feature-axis sharding** (tensor-parallel analogue): the primary,
    production path is `StageTrainer(..., mesh=mesh)` — FeatureCache
    places every (B, N) feature block with NamedSharding(P("feat", None))
    and the jitted split kernels (train/boost.py) auto-partition via
    GSPMD: per-feature quality rows are computed locally and the global
    first-argmax reduction lowers to collectives. Per-feature
    arithmetic is row-independent, so the sharded run picks *identical*
    splits to the single-device run (tested in tests/test_parallel.py).
  - this module provides the explicit `shard_map` formulation of the same
    combine — useful when the caller already holds device-local shards
    (e.g. a multi-host data loader) and wants the collectives spelled
    out: local best via the SAME split kernels as the trainer
    (train/boost._ordered_split_sorted — one kernel, two callers), then
    all_gather of per-shard (quality, var, thr) triples.
  - **sample/batch sharding** (data-parallel analogue): evaluator matmuls
    and weight statistics shard over samples with `psum` reductions.
  - multi-host runs reuse the same mesh via jax.distributed (DCN).

Collectives ride the mesh; no point-to-point code. Works on any backend,
including the N-virtual-device CPU mesh used in tests.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def shard_map(f, *, mesh, in_specs, out_specs, check_rep=False):
    """jax.shard_map across API generations (check_rep → check_vma)."""
    if hasattr(jax, "shard_map"):
        return jax.shard_map(
            f, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
            check_vma=check_rep,
        )
    from jax.experimental.shard_map import shard_map as _sm

    return _sm(
        f, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
        check_rep=check_rep,
    )

from cascadeclassifier_tpu.train.boost import (  # noqa: F401
    FLT_EPSILON,
    _ordered_split_sorted,
    as_f64,
)


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Multi-host entry: initialize jax.distributed so that
    `jax.devices()` spans every host's cards and make_mesh() below builds
    a global mesh whose collectives ride NVLink within a host and the
    network across hosts (SURVEY §2.6). Call once per process before any other
    JAX work — e.g. `traincascade_cli -numDevices -1 --coordinator
    host0:1234 --numProcesses 4 --processId $SLURM_PROCID`, or rely on
    JAX's cluster auto-detection where the launcher provides it (all
    args None)."""
    kw = {}
    if coordinator is not None:
        kw["coordinator_address"] = coordinator
    if num_processes is not None:
        kw["num_processes"] = num_processes
    if process_id is not None:
        kw["process_id"] = process_id
    jax.distributed.initialize(**kw)


def make_mesh(n_devices: int | None = None, axis: str = "feat") -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), (axis,))


def shard_features(mesh: Mesh, values, sort_idx=None, axis: str = "feat"):
    """Place (F, N) feature arrays with F sharded across the mesh."""
    sh = NamedSharding(mesh, P(axis, None))
    v = jax.device_put(values, sh)
    si = jax.device_put(sort_idx, sh) if sort_idx is not None else None
    return v, si


def _local_ordered_best(values, sort_idx, w, resp, mask):
    """Per-shard best ordered split: (quality, local_idx, threshold).

    Thin wrapper over the trainer's split kernel
    (train/boost._ordered_split_sorted) — one kernel, two callers — plus
    a local first-argmax for the collective combine."""
    with jax.enable_x64(True):
        wm = jnp.where(mask, w, 0.0)
        rm = wm * resp
        vs = jnp.take_along_axis(values, sort_idx, axis=1)
        ws = wm[sort_idx]
        rs = rm[sort_idx]
        kept = mask[sort_idx]
        q, thr = _ordered_split_sorted(
            vs, ws, rs, kept, jnp.sum(wm), jnp.sum(rm)
        )
        bq = jnp.max(q)
        fpos = jax.lax.broadcasted_iota(jnp.int32, q.shape, 0)
        bf = jnp.min(jnp.where(q == bq, fpos, q.shape[0]))
        bf = jnp.minimum(bf, q.shape[0] - 1)
    return bq, bf, thr[bf]


def sharded_ordered_best_split(mesh: Mesh, axis: str = "feat"):
    """Returns a jitted fn(values, sort_idx, w, resp, mask) →
    (quality f64, global_var i32, threshold f32) with values/sort_idx
    feature-sharded over `mesh`. The combine all-gathers one triple per
    device and picks max quality (ties → lowest global feature index, the
    reference's ascending-var scan order)."""

    def inner(values, sort_idx, w, resp, mask):
        shard = jax.lax.axis_index(axis)
        f_local = values.shape[0]
        bq, bf, thr = _local_ordered_best(values, sort_idx, w, resp, mask)
        gvar = shard * f_local + bf
        qs = jax.lax.all_gather(bq, axis)  # (S,)
        vs_ = jax.lax.all_gather(gvar, axis)
        ts = jax.lax.all_gather(thr, axis)
        qmax = jnp.max(qs)
        cand = jnp.where(qs == qmax, vs_, jnp.iinfo(jnp.int32).max)
        gbest = jnp.min(cand)
        sel = jnp.argmin(jnp.where(vs_ == gbest, 0, 1))
        return qmax, gbest, ts[sel]

    fn = jax.jit(
        shard_map(
            inner,
            mesh=mesh,
            in_specs=(P(axis, None), P(axis, None), P(), P(), P()),
            out_specs=(P(), P(), P()),
            check_rep=False,
        )
    )

    def call(values, sort_idx, w, resp, mask):
        # keep float64 w/resp across the jit boundary (canonicalization
        # would truncate them under the global 32-bit default)
        with jax.enable_x64(True):
            return fn(values, sort_idx, w, resp, mask)

    return call


def sharded_batch_eval(mesh: Mesh, axis: str = "data"):
    """Data-parallel evaluator matmul: corner matrix replicated, integral
    rows sharded over samples; also returns a psum'd per-feature weighted
    response accumulation as the histogram-allreduce pattern."""

    def inner(corner_m, sum_rows, w):
        vals = jnp.dot(
            corner_m, sum_rows.T, precision=jax.lax.Precision.HIGHEST
        )  # (F, N_local)
        wsum = jax.lax.psum(
            jnp.dot(vals, w, precision=jax.lax.Precision.HIGHEST), axis
        )  # (F,) over all samples
        return vals, wsum

    fn = shard_map(
        inner,
        mesh=mesh,
        in_specs=(P(), P(axis, None), P(axis)),
        out_specs=(P(None, axis), P()),
        check_rep=False,
    )
    return jax.jit(fn)
