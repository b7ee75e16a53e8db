"""Config 11: the live server surface, sync vs windowed protocol.

The reference's node ingests scans over DDS; our analog is ``cli serve``
(UNIX socket, one JSON scan per line).  The per-scan request/reply
protocol runs at sync speed (one host<->device round trip per scan) while
bag replay runs pipelined; the windowed protocol (immediate acks, async
pose results) carries the pipelined win to the live surface.

Each arm gets a FRESH server process (a served session is stateful — a
second feed of the same bag is motion-gated to nothing) and one timed feed;
the reported figure is the MEDIAN per-scan client latency over scans 4..n
(the first dispatches compile and load the programs and are excluded the
same way every other benchmark excludes them).
Windowed mode also asserts every accepted scan's pose is eventually
delivered.

Usage: python benchmarks/server_bench.py [--quick]
Appends a config-11 row to benchmarks/results.json.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

RESULTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "results.json")


def run_arm(bag_path: str, sock: str, windowed: bool) -> dict:
    from ndt_2d_tpu.mapping.server import stream_bag
    if os.path.exists(sock):
        os.unlink(sock)
    srv = subprocess.Popen(
        [sys.executable, "-m", "ndt_2d_tpu.cli", "serve", "--socket", sock,
         "--max-inflight", "8",
         "--local_scan_matcher.grid_cells", "192",
         "--global_scan_matcher.grid_cells", "192"],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        for _ in range(300):
            if os.path.exists(sock):
                break
            time.sleep(1)
        else:
            raise RuntimeError("server socket never appeared")
        t0 = time.perf_counter()
        last = stream_bag(bag_path, sock, windowed=windowed)
        wall = time.perf_counter() - t0
    finally:
        srv.terminate()
        srv.wait(timeout=30)
    times = np.asarray(last.pop("scan_times_s"))
    return {
        "wall_s": round(wall, 2),
        "scan_ms_median": round(float(np.median(times[3:])) * 1e3, 2),
        "poses_delivered": len(last.get("results", {})),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args(argv)

    n = 60 if args.quick else 200
    bag_path = "/tmp/server_bench_bag.npz"
    from ndt_2d_tpu.io import bag as bag_mod
    bag_mod.save_bag(bag_mod.record_synthetic("corridor", n, n_beams=360),
                     bag_path)

    sync_row = run_arm(bag_path, "/tmp/server_bench_s.sock", windowed=False)
    win_row = run_arm(bag_path, "/tmp/server_bench_w.sock", windowed=True)

    row = {
        "config": 11,
        "name": "live_server_protocols",
        "scans": n,
        "sync": sync_row,
        "windowed": win_row,
        "speedup_median": round(
            sync_row["scan_ms_median"] / win_row["scan_ms_median"], 2),
        "ts": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    }
    print(json.dumps(row), flush=True)
    existing = json.load(open(RESULTS)) if os.path.exists(RESULTS) else []
    existing.append(row)
    json.dump(existing, open(RESULTS, "w"), indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
