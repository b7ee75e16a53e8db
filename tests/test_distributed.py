"""True multi-process distribution.

Spawns N=2 fresh Python processes, each with 4 virtual CPU devices, joined
into one 8-device global mesh via ``jax.distributed.initialize`` — real
process boundaries: distinct runtimes, separate compilations, collectives
crossing the coordinator's transport (the network stand-in).  Each worker runs

  * the constraint-sharded LM/PCG solve vs a process-local solve,
  * the descriptor all-to-all top-k vs a process-local dense search,
  * a full office-loop SLAM session through ``Mapper(mesh=...)`` with loop
    closures, optimization, and sharded occupancy export, asserting the
    final poses and grid are bitwise replicated across processes

(tests/distributed_worker.py).  The parent additionally cross-checks the
two processes' reported numbers agree exactly.
"""

import json
import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "distributed_worker.py")
NPROC = 2
LOCAL_DEVICES = 4


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_mesh():
    port = _free_port()
    env = dict(os.environ)
    # Children configure their own virtual-device count; scrub any inherited
    # forcing so _LOCAL is authoritative.
    env.pop("XLA_FLAGS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(pid), str(NPROC), str(port),
             str(LOCAL_DEVICES)],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        for pid in range(NPROC)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=1400)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()

    results = {}
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-4000:]}"
        lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        assert lines, f"no RESULT line:\n{out[-4000:]}"
        r = json.loads(lines[-1][len("RESULT "):])
        results[r["pid"]] = r

    assert set(results) == set(range(NPROC))
    r0, r1 = results[0], results[1]
    assert r0["devices"] == NPROC * LOCAL_DEVICES
    # Both controllers must have computed the identical session (the worker
    # already asserted bitwise pose/grid replication via allgather; this
    # cross-checks the reported summaries end-to-end).
    for key in ("solve", "descriptor", "slam", "pipeline", "pf"):
        assert r0[key] == r1[key], (key, r0[key], r1[key])
    assert r0["slam"]["closures"] >= 1
    assert r0["slam"]["optimizations"] >= 1
    assert r0["slam"]["ate"] < 0.35
    # Round 5: pipelining + the sharded-measurement PF under multi-process.
    assert r0["pipeline"]["scans"] == 16
    assert r0["pf"]["updates"] > 5
    assert r0["pf"]["mean_err"] < 0.2
