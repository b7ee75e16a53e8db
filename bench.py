"""Headline benchmark: scan-match throughput (candidates/sec/chip).

Prints ONE JSON line:
  {"metric": "...", "value": N, "unit": "...", "vs_baseline": N}

The metric is the NDT scan matcher's candidate-pose scoring throughput on one
chip (the reference's hot loop: 80 x 21 x 21 = 35 280 candidates x 100 beams
per matchScan, src/scan_matcher_ndt.cpp:103-143).  ``vs_baseline`` is the
speedup against the single-threaded C++ implementation of the same algorithm
(native/baseline_matcher.cpp) measured on the same host — the reference
publishes no numbers of its own, so the C++-equivalent baseline is measured
in-situ.  Any failing phase fails the run.

Extra diagnostic metrics go to stderr; stdout carries only the result line.
"""

import json
import sys
import time

import numpy as np


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def make_fixture(range_max: float = 15.0):
    """The headline match at bench shapes: a 10-scan rolling window of
    512-point scans in a box world, and a query scan with its start pose.

    Returns (window poses [10, 3], window points [10, 512, 2], window mask,
    query points [512, 2], query mask, query point count, query pose [3]).
    """
    from ndt_2d_tpu.utils import sim

    world = sim.make_box_world(10.0, 8.0)
    rng = np.random.default_rng(0)
    poses = np.asarray(
        [[4.0 + 0.15 * i, 3.8 + 0.02 * i, 0.01 * i] for i in range(10)],
        np.float32)
    pts, msk = [], []
    for p in poses:
        msg = sim.scan_at_pose(world, p, n_beams=360, range_max=range_max,
                               noise=0.01, rng=rng)
        a, b = sim.project_scan(msg, 512)
        pts.append(a)
        msk.append(b)
    msg = sim.scan_at_pose(world, poses[-1] + [0.15, 0.0, 0.0],
                           n_beams=360, range_max=range_max)
    qpts, qmask = sim.project_scan(msg, 512)
    query_pose = (poses[-1] + np.asarray([0.17, 0.01, 0.005])).astype(
        np.float32)
    return (poses, np.stack(pts), np.stack(msk), qpts, qmask,
            int(qmask.sum()), query_pose)


CHAIN = 512


def chained_seconds_per_match(config, grid, points, mask, num_points, pose,
                              range_max: float, rounds: int = 3) -> float:
    """Seconds per match of the scoring program, best of ``rounds``.

    CHAIN varied matches run chained inside one jit, so per-dispatch launch
    and host overhead are amortized: this times the device program.
    """
    import jax
    import jax.numpy as jnp

    from ndt_2d_tpu.matching import matcher

    offsets = jnp.asarray(
        0.0005 * np.arange(CHAIN)[:, None] * np.ones(3, np.float32),
        jnp.float32)

    @jax.jit
    def run_chain(base_pose):
        def body(i, acc):
            r = matcher.match_scan(config, grid, points, mask, num_points,
                                   base_pose + offsets[i],
                                   jnp.float32(range_max))
            return acc + r.score
        return jax.lax.fori_loop(0, CHAIN, body, jnp.float32(0.0))

    jax.block_until_ready(run_chain(pose))
    best = float("inf")
    for _ in range(rounds):
        t0 = time.perf_counter()
        jax.block_until_ready(run_chain(pose))
        best = min(best, (time.perf_counter() - t0) / CHAIN)
    return best


def main():
    import jax
    import jax.numpy as jnp

    from ndt_2d_tpu.utils.jax_cache import enable_compilation_cache
    enable_compilation_cache()

    from ndt_2d_tpu.config import ScanMatcherConfig
    from ndt_2d_tpu.matching import matcher

    config = ScanMatcherConfig(grid_cells_x=160, grid_cells_y=160)
    range_max = 15.0
    dev = jax.devices()[0]
    log(f"device: {dev}")

    (poses, window_points, window_mask, qpts, qmask, n_scan,
     query_pose) = make_fixture(range_max)

    # ---- device path: build NDT once, then time the match program ----
    grid = matcher.build_window_ndt(
        config, jnp.asarray(poses), jnp.asarray(window_points),
        jnp.asarray(window_mask), jnp.ones(10, bool), jnp.float32(range_max))
    jax.block_until_ready(grid)

    jpts = jnp.asarray(qpts)
    jmask = jnp.asarray(qmask)
    jn = jnp.int32(n_scan)
    pose_dev = jnp.asarray(query_pose)
    res = matcher.match_scan(config, grid, jpts, jmask, jn, pose_dev,
                             jnp.float32(range_max))
    jax.block_until_ready(res)
    log(f"warm match: score={float(res.score):.4f} "
        f"corr={np.asarray(res.correction)}")

    t_chain = chained_seconds_per_match(config, grid, jpts, jmask, jn,
                                        pose_dev, range_max)
    rate = config.num_candidates / t_chain
    log(f"{dev.platform} chained x{CHAIN}: {t_chain*1e3:.4f} ms/match, "
        f"{rate:.3e} candidates/s")

    # ---- C++ single-thread baseline (the reference-equivalent loop) ----
    from ndt_2d_tpu.io import native
    score, corr, cands = native.match_baseline(
        poses, window_points, window_mask, qpts, qmask, n_scan,
        query_pose, range_max, config)
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        native.match_baseline(poses, window_points, window_mask, qpts,
                              qmask, n_scan, query_pose, range_max, config)
    t_cpp = (time.perf_counter() - t0) / reps
    baseline_rate = cands / t_cpp
    log(f"c++ baseline: {t_cpp*1e3:.1f} ms/match, "
        f"{baseline_rate:.3e} candidates/s; score={score:.4f} corr={corr}")
    log(f"agreement: {dev.platform}={float(res.score):.5f} cpp={score:.5f}")

    print(json.dumps({
        "metric": "scan_match_candidates_per_sec_per_chip",
        "value": round(rate),
        "unit": "candidates/s",
        "vs_baseline": round(rate / baseline_rate, 2),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": jax.device_count()},
    }), flush=True)


if __name__ == "__main__":
    main()
