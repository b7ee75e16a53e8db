"""Multi-process (multi-host) distribution runtime.

The reference is strictly single-process (three threads, two mutexes —
SURVEY.md §2); its only transport is DDS.  This build's scale-out story is
the ``jax.distributed`` multi-controller runtime: every process runs the
same host program, owns a shard of the global device mesh, and the sharded
kernels in ``parallel/`` (angle-sharded match, constraint-sharded LM/PCG,
descriptor all-to-all, ray-sharded occupancy) communicate with XLA
collectives — psum/all_gather ride NVLink *within* a host and the network
*across* hosts, with no application-level networking at all.

Process model
-------------
* Every process replays the same deterministic input stream (bag replay is
  cheap; scan ingest is NOT the bottleneck — the 35k-candidate match is),
  so host-side orchestration (gates, constraint bookkeeping, cadences)
  stays identical everywhere without any cross-process RPC.  This is the
  standard SPMD multi-controller discipline: divergence is impossible
  because every process executes the same pure function of the same data.
* Device *inputs* are passed as host numpy arrays — in multi-controller
  JAX these are treated as process-replicated and each process feeds only
  its addressable shards.  Committed single-device ``jnp`` arrays are a
  single-process optimization and are avoided on the multi-process path
  (see Mapper._dev / _devf).
* Device *outputs* come back either fully replicated (``out_specs=P()`` —
  readable directly on every process) or mesh-sharded (``P(axis)`` — each
  process holds a slice); :func:`fetch` handles both.

Device placement: on a GPU host each process takes one card, so four
processes on a four-card host do not each claim all four (process ``k``
uses local card ``k``; one host, one process per card).  On GPUs the
processes also set two XLA flags (see :func:`initialize`), without which
four processes on four H100s stalled.

Simulation recipe (no accelerator needed): N processes ×
``--xla_force_host_platform_device_count=K`` CPU devices each gives an
N*K-device global mesh with real process boundaries — the fake backend
SURVEY.md §4 prescribes; ``tests/test_distributed.py`` runs it in CI.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import numpy as np

ENV_COORD = "NDT2D_DIST_COORD"
ENV_NPROC = "NDT2D_DIST_NPROC"
ENV_PID = "NDT2D_DIST_PID"
GPU_FLAGS = ("--xla_gpu_shard_autotuning=false",
             "--xla_gpu_deterministic_ops=true")


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Join the jax.distributed multi-controller runtime.

    Arguments default to the ``NDT2D_DIST_{COORD,NPROC,PID}`` environment
    variables (how ``cli --distributed`` and the test harness pass them).
    Process 0 hosts the coordination service; all processes block here
    until everyone has joined.  Call before any device computation.

    Unless the configured platforms are CPU only, process ``k`` is given
    local device ``k`` alone (``local_device_ids``): several processes on
    one GPU host then split its cards instead of all opening every card.
    Those processes also get two XLA flags, each unless ``XLA_FLAGS``
    already sets it:

    * ``--xla_gpu_shard_autotuning=false``: with autotuning shared out
      between the processes, compiling a program that spans them and
      holds a matrix product never finished;
    * ``--xla_gpu_deterministic_ops=true``: every process computes the
      replicated values itself and reads its own copy, and a float
      scatter-add sums in another order on each card, so the processes'
      gate decisions, and then their collectives, drifted apart.
    """
    import jax

    from ndt_2d_tpu.utils.jax_cache import cpu_only
    coordinator_address = coordinator_address or os.environ.get(ENV_COORD)
    if num_processes is None:
        num_processes = int(os.environ.get(ENV_NPROC, "0")) or None
    if process_id is None:
        pid = os.environ.get(ENV_PID)
        process_id = int(pid) if pid is not None else None
    if not coordinator_address or not num_processes:
        raise ValueError(
            "distributed.initialize needs a coordinator address and process "
            f"count (set {ENV_COORD}/{ENV_NPROC}/{ENV_PID} or pass args)")
    gpu = not cpu_only(jax.config.jax_platforms)
    if gpu:
        # Read when the backend starts, which is after this call.
        flags = os.environ.get("XLA_FLAGS", "")
        for flag in GPU_FLAGS:
            if flag.split("=")[0] not in flags:
                flags = f"{flags} {flag}".strip()
        os.environ["XLA_FLAGS"] = flags
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id,
                               local_device_ids=[process_id]
                               if gpu and process_id is not None else None)


def is_multiprocess(mesh=None) -> bool:
    """True when this runtime spans more than one controller process (or,
    with a mesh, when the mesh contains devices of more than one process)."""
    import jax
    if mesh is not None:
        procs = {d.process_index for d in mesh.devices.flat}
        return len(procs) > 1
    return jax.process_count() > 1


def fetch(tree: Any) -> Any:
    """Bring a pytree of device results to every process's host memory.

    Fully-addressable leaves (single-process arrays, replicated outputs)
    use a plain ``device_get``.  Multi-process leaves that are FULLY
    REPLICATED read the process-local copy directly (every process already
    holds the whole value — no cross-process traffic; this is what makes
    threading replicated jit-output state across pipelined steps cheap);
    mesh-sharded leaves are materialized with ``process_allgather`` (one
    all-gather across processes).  Non-array leaves pass through.  This is
    the one fetch entry point the mapper/runtime use so single- and
    multi-process modes share call sites.
    """
    import jax

    def _leaf(x):
        if isinstance(x, jax.Array) and not x.is_fully_addressable:
            if x.sharding.is_fully_replicated:
                return np.asarray(x.addressable_data(0))
            from jax.experimental import multihost_utils
            return multihost_utils.process_allgather(x, tiled=True)
        return x

    tree = jax.tree_util.tree_map(_leaf, tree)
    return jax.device_get(tree)


def barrier(name: str = "ndt2d") -> None:
    """Block until every process reaches this point (one cross-process
    round trip)."""
    import jax
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils
        multihost_utils.sync_global_devices(name)


def assert_replicated(x: np.ndarray, name: str = "value") -> None:
    """Debug guard: verify a host value is bitwise identical on every
    process (the SPMD invariant the replicated-host-loop design rests on).
    No-op single-process; one allgather + compare otherwise."""
    import jax
    if jax.process_count() <= 1:
        return
    from jax.experimental import multihost_utils
    mine = np.asarray(x)
    gathered = multihost_utils.process_allgather(mine[None], tiled=False)
    ref = np.asarray(gathered)[0]
    for p in range(jax.process_count()):
        got = np.asarray(gathered)[p]
        if not np.array_equal(ref, got, equal_nan=True):
            raise AssertionError(
                f"host value {name!r} diverged between process 0 and {p}: "
                f"{ref!r} vs {got!r} — the replicated host loop is broken")
