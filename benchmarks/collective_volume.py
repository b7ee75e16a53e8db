"""Measure per-step collective traffic of every mesh program.

Compiles the sharded pipeline's device programs on an 8-virtual-CPU-device
mesh and inventories the XLA collectives in the optimized HLO — op kind,
tensor shape, bytes moved per execution — to state exactly what crosses
NVLink (collectives among one host's cards) vs the network (the same
collectives when the mesh axis spans hosts; XLA emits the same ops, the
fabric underneath changes).  These are byte counts from shapes, not
timings.

Ops inside a `while` body (the PCG loop) execute once per iteration; the
report marks those with the loop's trip source so the per-step totals can
be scaled (e.g. x ~30 CG iterations x ~10 LM iterations per solve).

Usage: python benchmarks/collective_volume.py   (writes collective_volume.json)
"""

from __future__ import annotations

import json
import os
import re
import sys

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

RESULTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "collective_volume.json")

_DTYPE_BYTES = {"f64": 8, "f32": 4, "bf16": 2, "f16": 2, "s32": 4, "u32": 4,
                "s64": 8, "u64": 8, "pred": 1, "s8": 1, "u8": 1, "s16": 2,
                "u16": 2}
_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")
_OP_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?[\w.\-]+\s*=\s*(\([^)]*\)|\S+)\s+"
    r"(" + "|".join(_COLLECTIVES) + r")(?:-start|-done)?\(")
_SHAPE_RE = re.compile(r"(f64|f32|bf16|f16|s64|u64|s32|u32|s16|u16|s8|u8|pred)"
                       r"\[([\d,]*)\]")


def _shape_bytes(shape_str: str) -> int:
    total = 0
    for m in _SHAPE_RE.finditer(shape_str):
        dtype, dims = m.group(1), m.group(2)
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


_COMP_RE = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s*\(")
_BODY_RE = re.compile(r"body=%?([\w.\-]+)")
_CALL_RE = re.compile(r"(?:to_apply|calls|condition|body)=%?([\w.\-]+)")


def inventory(compiled) -> list:
    """Parse optimized HLO: [(kind, bytes, in_while)] per collective op.

    Collectives are attributed to their computation; a computation is
    "in a loop" if it is (transitively) the body of any `while` op.
    `-start`/`-done` pairs of async collectives count once (on -start).
    """
    per_comp = {}        # computation -> [op dict]
    callees = {}         # computation -> set of called computations
    loop_bodies = set()  # computations named as while bodies
    current = None
    for line in compiled.as_text().splitlines():
        stripped = line.strip()
        header = _COMP_RE.match(stripped)
        if header and stripped.endswith("{"):
            current = header.group(1)
            per_comp.setdefault(current, [])
            callees.setdefault(current, set())
            continue
        if current is None:
            continue
        if " while(" in stripped or stripped.startswith("while("):
            for m in _BODY_RE.finditer(stripped):
                loop_bodies.add(m.group(1))
        for m in _CALL_RE.finditer(stripped):
            callees[current].add(m.group(1))
        if "-done(" in stripped:
            continue
        m = _OP_RE.match(line)
        if m:
            per_comp[current].append({"kind": m.group(2),
                                      "bytes": _shape_bytes(m.group(1))})

    # Transitive closure: everything reachable from a loop body is in-loop.
    in_loop = set()
    frontier = list(loop_bodies)
    while frontier:
        c = frontier.pop()
        if c in in_loop:
            continue
        in_loop.add(c)
        frontier.extend(callees.get(c, ()))

    ops = []
    for comp, comp_ops in per_comp.items():
        for o in comp_ops:
            ops.append({**o, "in_loop": comp in in_loop})
    return ops


def summarize(name: str, compiled, note: str) -> dict:
    ops = inventory(compiled)
    once = sum(o["bytes"] for o in ops if not o["in_loop"])
    per_iter = sum(o["bytes"] for o in ops if o["in_loop"])
    row = {
        "program": name,
        "collectives": len(ops),
        "by_kind": {},
        "bytes_once": once,
        "bytes_per_loop_iter": per_iter,
        "note": note,
    }
    for o in ops:
        k = o["kind"] + (" (loop)" if o["in_loop"] else "")
        row["by_kind"][k] = row["by_kind"].get(k, 0) + o["bytes"]
    print(json.dumps(row), flush=True)
    return row


def main() -> int:
    from ndt_2d_tpu.config import ScanMatcherConfig, SolverConfig
    from ndt_2d_tpu.matching import matcher
    from ndt_2d_tpu.parallel import loop_search, runtime
    from ndt_2d_tpu.parallel import solver as psolver
    from ndt_2d_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(8)          # (space=4, batch=2) -- _factor(8)
    rows = []
    P = 512

    # 1. Rolling match: angle lattice sharded over `space`.
    mcfg = ScanMatcherConfig(grid_cells_x=160, grid_cells_y=160)
    window = matcher.RollingWindow(
        np.zeros((10, 3), np.float32), np.zeros((10, P, 2), np.float32),
        np.zeros((10, P), bool), np.ones(10, bool))
    lowered = runtime.match_scan_rolling_multichip.lower(
        mcfg, mesh, window, np.float32(12.0), np.zeros((P, 2), np.float32),
        np.zeros(P, bool), np.int32(100), np.zeros(3, np.float32))
    rows.append(summarize(
        "match_scan_rolling (per accepted scan)", lowered.compile(),
        "Olson K/u/s psum + best/corr all_gather over 'space'"))

    # 1b. Pipelined mapping step (round 5: runs under multi-process too —
    #     the window/pose chain threads through as replicated jit outputs,
    #     so the collective inventory must equal the synchronous match's:
    #     the pipelining adds NO cross-device traffic).
    lowered = runtime.mapping_step_async_multichip.lower(
        mcfg, mesh, window, np.zeros(3, np.float32), np.float32(12.0),
        np.zeros((P, 2), np.float32), np.zeros(P, bool), np.int32(100),
        np.zeros(3, np.float32))
    rows.append(summarize(
        "mapping_step_async (per pipelined scan)", lowered.compile(),
        "same psum/all_gather set as the synchronous match — the "
        "device-resident pose/window chain is replicated, not gathered"))

    # 2. Loop-closure confirmation batch: candidates over `batch`,
    #    angles over `space`.
    K = 8
    lowered = runtime.confirm_batch_multichip.lower(
        mcfg, mesh, np.zeros((K, 2, 3), np.float32),
        np.zeros((K, 2, P, 2), np.float32), np.zeros((K, 2, P), bool),
        np.zeros((K, 2), bool), np.float32(12.0),
        np.zeros((P, 2), np.float32), np.zeros(P, bool), np.int32(100),
        np.zeros((K, 3), np.float32))
    rows.append(summarize(
        f"confirm_batch K={K} (per confirmation pass)", lowered.compile(),
        "per-candidate K/u/s psum + best all_gather over 'space'"))

    # 3. Pose-graph solve: constraints over `batch`; PCG matvec psums per
    #    CG iteration, gradient/diag psums per LM iteration.
    Np, C = 64, 128
    scfg = SolverConfig()
    lowered = psolver.solve_multichip.lower(
        scfg, mesh, np.zeros((Np, 3), np.float32), np.zeros(C, np.int32),
        np.zeros(C, np.int32), np.zeros((C, 3), np.float32),
        np.zeros((C, 3, 3), np.float32), np.ones(C, bool), np.ones(Np, bool),
        fixed_index=0, robust_mask=np.zeros(C, bool))
    rows.append(summarize(
        f"solve Np={Np} C={C} (per optimize call)", lowered.compile(),
        "loop bytes execute once per CG iteration (the matvec psum) and "
        "once per LM iteration (gradient+diag+cost psums); typical solve = "
        "~10 LM x ~30 CG iterations"))

    # 4. Descriptor all-to-all: keyframes over `batch`.
    N, B = 256, 192
    lowered = loop_search.search_all_pairs_multichip.lower(
        mesh, np.zeros((N, B), np.float32), np.ones(N, bool), k=8,
        rolling_exclude=10)
    rows.append(summarize(
        f"descriptor_all_pairs N={N} (per loop-closure pass)",
        lowered.compile(),
        "one descriptor-table all_gather (N*B*4 B) over 'batch'"))

    # 5. Occupancy export: rays over the whole mesh.
    R = 8192
    lowered = runtime.raymarch_counts_multichip.lower(
        mesh, np.zeros((R, 2), np.float32), np.zeros((R, 2), np.float32),
        np.ones(R, bool), np.zeros(2, np.float32), np.float32(0.05),
        256, 256, 128)
    rows.append(summarize(
        "raymarch 256x256 (per map render)", lowered.compile(),
        "hit/empty count-image psums over the whole mesh"))

    with open(RESULTS, "w") as f:
        json.dump(rows, f, indent=1)
    print(f"wrote {RESULTS}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
