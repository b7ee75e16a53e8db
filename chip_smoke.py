#!/usr/bin/env python3
"""Smoke test of the SLAM engine on one NVIDIA GPU, through its entry points.

Phases (each a child process, run one after another):

  0  device     nvidia-smi name and power limit; JAX's devices and versions;
                the compile-cache directory.
  1  kernels    the device programs at real widths against plain references:
                the rolling-window match (10-scan window of 512 points,
                160x160 grid, 35 280 candidates, 100 beams) against the
                float64 C++ matcher (native/) and against the same jitted
                program on the CPU backend; the PF measurement over 5000
                particles; descriptor DFT and top-k search against float64
                numpy; the LM solve (dense and PCG) on a 2304-node graph; the
                scoring program's ms per match; the peak device memory of one
                32-row coarse loop-closure confirmation chunk.  Then the
                tests marked `gpu` (`pytest -m gpu`), which must pass.
  2  slam       `cli run` over the committed 1769-scan CARMEN survey
                (datasets/simlab.clf.gz) with the simlab recipe, truth
                attached so the run reports its ATE.
  3  localize   `cli localize --particle-filter --pf.max_particles 5000`
                against phase 2's map, checked with motion-model alphas
                fitted to the survey's odometry (FITTED_ALPHAS), then
                reported unchecked with the default alphas.
  4  serve      `cli serve --max-inflight 8` fed 300 scans by
                `cli feed --windowed`, a second process that must not open
                the card; the server stops on SIGTERM.

With --multi-gpu it runs only phase 2, three ways on a four-card host: as
four --distributed processes (one card each), on one card for comparison,
and with --mesh 4 in one process.

The parent process never starts a JAX backend, so one process at a time holds
the card.  Children get JAX_PLATFORMS=cuda,cpu: a missing GPU is an error,
not a fall back to the CPU.  Any failed phase or missed bound exits non-zero
and prints no result line.  On success the last line of stdout is
  {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}

Usage:
  python3 chip_smoke.py               # one GPU, phases 0-4
  python3 chip_smoke.py --multi-gpu   # four GPUs, phase 2 three ways
  python3 chip_smoke.py --rehearse    # CPU dry run of phases 0-4 on the
                                      # first 300 scans; never prints ok
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "chiprun_out", "chip_smoke")
DATASET = os.path.join(ROOT, "datasets", "simlab.clf.gz")
TRUTH = os.path.join(ROOT, "datasets", "simlab_truth.npz")

# Config 9 of benchmarks/run_benchmarks.py through the CLI: the simlab
# recipe, pipelined mapping, closure pass every 20 scans, and the dataset's
# global-matcher settings.
SLAM_FLAGS = [
    "--recipe", "simlab", "--max-inflight", "8",
    "--loop-closure-every", "20", "--minimum-travel-distance", "0.3",
    "--max-range", "10", "--global-search-size", "4.0",
    "--optimization-node-limit", "10",
    "--global_scan_matcher.grid_cells", "160",
    "--global_scan_matcher.ndt_resolution", "0.35",
    "--global_scan_matcher.search_linear_size", "0.15",
    "--global_scan_matcher.search_linear_resolution", "0.01",
    "--global_scan_matcher.search_angular_size", "0.05",
]
SERVE_SCANS = 300
REHEARSE_SCANS = 300

# Bounds.  ATE_FRACTION: SLAM must remove at least three quarters of the
# odometry's ATE.  LOCALIZE_ATE_M: PF tracking against the SLAM map; the map
# itself carries that run's ATE, and the particle cloud adds its spread.
ATE_FRACTION = 0.25
LOCALIZE_ATE_M = 0.35
# Mesh and distributed runs against the one-card run: closure decisions can
# differ between runs (float sums in another order can flip a borderline
# gate), which moves the final ATE by up to about this much.
MULTI_ATE_DIFF_M = 0.15
# The four-process run takes 83 s on the CPU rehearsal (four processes of
# one virtual device each, full survey); a stalled run is cut off here.
DIST_TIMEOUT_S = 300


class SmokeFailure(Exception):
    pass


def say(*args):
    print(*args, flush=True)


# --------------------------------------------------------------------------
# Parent: orchestration.  Imports numpy and the repo's numpy-only IO
# modules, never jax.
# --------------------------------------------------------------------------
def child_env(platforms: str, **extra) -> dict:
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = platforms
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env.update({k: str(v) for k, v in extra.items()})
    return env


def run(cmd, env, timeout: float, name: str) -> list:
    """Run one child to completion; echo its stdout; return its lines."""
    t0 = time.perf_counter()
    try:
        out = subprocess.run(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                             text=True, timeout=timeout)
    except subprocess.TimeoutExpired:
        raise SmokeFailure(f"{name}: no result within {timeout:.0f} s")
    lines = out.stdout.splitlines()
    for ln in lines:
        say(f"  [{name}] {ln}")
    say(f"  [{name}] exit {out.returncode} after "
        f"{time.perf_counter() - t0:.1f} s")
    if out.returncode != 0:
        raise SmokeFailure(f"{name}: exit code {out.returncode}")
    return lines


def last_json(lines: list, name: str) -> dict:
    for ln in reversed(lines):
        if ln.startswith("{"):
            return json.loads(ln)
    raise SmokeFailure(f"{name}: printed no JSON line")


def check(ok: bool, what: str) -> None:
    say(f"  check {'PASS' if ok else 'FAIL'}: {what}")
    if not ok:
        raise SmokeFailure(what)


def cli(*args) -> list:
    return [sys.executable, "-m", "ndt_2d_tpu.cli", *args]


def prepare_bags(n_scans):
    """The CARMEN survey as a bag with truth attached, plus the first
    SERVE_SCANS scans for the served phase."""
    sys.path.insert(0, ROOT)
    import numpy as np

    from ndt_2d_tpu.io import bag as bag_mod
    from ndt_2d_tpu.io import carmen

    bag = carmen.load_carmen(DATASET, range_max=10.0)
    truth = np.load(TRUTH)["truth"]
    if len(truth) != len(bag):
        raise SmokeFailure(f"truth has {len(truth)} poses for "
                           f"{len(bag)} scans")
    bag.truth = truth

    def cut(n):
        return bag_mod.ScanBag(
            ranges=bag.ranges[:n], angle_min=bag.angle_min,
            angle_increment=bag.angle_increment,
            time_increment=bag.time_increment, range_max=bag.range_max,
            odom=bag.odom[:n], truth=bag.truth[:n],
            times=None if bag.times is None else bag.times[:n])

    full = os.path.join(WORK, "simlab.npz")
    serve = os.path.join(WORK, "simlab_serve.npz")
    bag_mod.save_bag(cut(n_scans or len(bag)), full)
    bag_mod.save_bag(cut(SERVE_SCANS), serve)
    return full, serve


def nvidia_smi_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise SmokeFailure(f"nvidia-smi failed: {e}")
    if out.returncode != 0:
        raise SmokeFailure(f"nvidia-smi exit {out.returncode}: "
                           f"{out.stderr.strip()}")
    return out.stdout.strip()


def phase_slam(env, bag, map_out, name, extra=(), timeout=900) -> dict:
    stats = last_json(run(cli("run", "--bag", bag, "--map-out", map_out,
                              *SLAM_FLAGS, *extra), env, timeout, name),
                      name)
    sess = stats["session"]
    say(f"  [{name}] stats: " + json.dumps(
        {k: v for k, v in stats.items() if k != "session"}))
    say(f"  [{name}] session: " + json.dumps(
        {k: v for k, v in sess.items() if k != "timing"}))
    say(f"  [{name}] timing: " + json.dumps(sess["timing"]))
    check(stats["ate_rmse_m"] <= ATE_FRACTION * stats["odom_ate_rmse_m"],
          f"{name}: ate_rmse_m {stats['ate_rmse_m']:.4f} <= "
          f"{ATE_FRACTION} x odom_ate_rmse_m {stats['odom_ate_rmse_m']:.4f}")
    check(sess["loop_closures_accepted"] >= 1,
          f"{name}: loop_closures_accepted "
          f"{sess['loop_closures_accepted']} >= 1")
    n_match = sess["timing"].get("local_match", {}).get("count", 0)
    check(n_match == stats["scans_accepted"] - 1,
          f"{name}: local_match count {n_match} == scans_accepted - 1 "
          f"({stats['scans_accepted'] - 1})")
    return stats


# The survey's odometry noise is about 1 cm and 0.0035 rad per scan
# (benchmarks/make_simlab.py).  With the reference's default motion-model
# alphas (0.2) the cloud spreads faster than the NDT-score weights pull it
# back, and the filter loses track after about 290 scans; alphas of 0.05
# fit this odometry.  The checked run uses 0.05; a second run with the
# defaults reports its ATE unchecked.
PF_FLAGS = ["--particle-filter", "--pf.max_particles", "5000"]
FITTED_ALPHAS = ["--pf.odom_alpha1", "0.05", "--pf.odom_alpha2", "0.05",
                 "--pf.odom_alpha3", "0.05", "--pf.odom_alpha4", "0.05"]


def phase_localize(env, bag, map_path) -> dict:
    stats = {}
    for name, alphas in (("localize", FITTED_ALPHAS),
                         ("localize-default-alphas", [])):
        stats[name] = last_json(run(
            cli("localize", "--bag", bag, "--map", map_path, *PF_FLAGS,
                *alphas, "--max-range", "10"), env, 600, name), name)
        say(f"  [{name}] stats: " + json.dumps(
            {k: v for k, v in stats[name].items() if k != "session"}))
    ate = stats["localize"]["ate_rmse_m"]
    check(ate <= LOCALIZE_ATE_M,
          f"localize: ate_rmse_m {ate:.4f} <= {LOCALIZE_ATE_M} m")
    say(f"  localize with the default alphas (0.2, not checked): "
        f"ate_rmse_m {stats['localize-default-alphas']['ate_rmse_m']:.4f}")
    return stats


def wait_for_line(proc, token: str, timeout: float) -> str:
    import selectors
    sel = selectors.DefaultSelector()
    sel.register(proc.stdout, selectors.EVENT_READ)
    deadline = time.monotonic() + timeout
    try:
        while time.monotonic() < deadline:
            if proc.poll() is not None:
                break
            if sel.select(timeout=1.0):
                line = proc.stdout.readline()
                if token in line:
                    return line.strip()
    finally:
        sel.close()
    raise SmokeFailure(f"server did not print {token!r} within "
                       f"{timeout:.0f} s (exit {proc.poll()})")


def phase_serve(env, bag) -> dict:
    sock = os.path.join(WORK, "scan.sock")
    srv = subprocess.Popen(
        cli("serve", "--socket", sock, "--max-inflight", "8",
            "--max-range", "10"), cwd=ROOT, env=env,
        stdout=subprocess.PIPE, text=True)
    try:
        say("  [serve] " + wait_for_line(srv, "serving", 300))
        # The client gets a platform list naming only a GPU it cannot see:
        # if it started any JAX backend it would fail, so its success shows
        # it never opened the card.
        client_env = child_env("cuda", CUDA_VISIBLE_DEVICES="")
        feed = last_json(run(cli("feed", "--bag", bag, "--socket", sock,
                                 "--windowed"), client_env, 600, "feed"),
                         "feed")
        srv.send_signal(signal.SIGTERM)
        try:
            rc = srv.wait(timeout=120)
        except subprocess.TimeoutExpired:
            raise SmokeFailure("serve: still running 120 s after SIGTERM")
    finally:
        if srv.poll() is None:
            srv.kill()
            srv.wait()
    check(feed.get("ok") is True, "feed: final reply ok")
    check(feed["scans_accepted"] >= 1,
          f"feed: scans_accepted {feed['scans_accepted']} >= 1")
    check(feed["poses_delivered"] == feed["scans_accepted"],
          f"feed: poses_delivered {feed['poses_delivered']} == "
          f"scans_accepted {feed['scans_accepted']}")
    check(rc == 0, f"serve: exit code {rc} on SIGTERM == 0")
    return feed


def phase_gpu_tests(env) -> None:
    """The test suite's card-only checks (marker `gpu`); a skip fails.
    Only the files that hold such tests are collected: another installed
    package named `tests` can shadow the test directory's own imports."""
    import glob
    files = [f for f in sorted(glob.glob(os.path.join(ROOT, "tests",
                                                      "test_*.py")))
             if "pytest.mark.gpu" in open(f).read()]
    check(bool(files), "tests marked gpu exist")
    lines = run([sys.executable, "-m", "pytest", "-m", "gpu", "-q", "-rs",
                 "-p", "no:cacheprovider", *files], env, 600, "pytest-gpu")
    tail = lines[-1] if lines else ""
    check(" passed" in tail and "skipped" not in tail
          and "failed" not in tail, f"pytest -m gpu: {tail!r}")


def load_map_arrays(path: str) -> dict:
    import numpy as np
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def compare_to_one_card(name: str, st: dict, one: dict) -> None:
    d = abs(st["ate_rmse_m"] - one["ate_rmse_m"])
    check(d <= MULTI_ATE_DIFF_M,
          f"{name}: |ate {st['ate_rmse_m']:.4f} - one-card ate "
          f"{one['ate_rmse_m']:.4f}| = {d:.4f} <= {MULTI_ATE_DIFF_M} m")
    check(st["device"]["count"] == 4,
          f"{name}: ran over {st['device']['count']} devices == 4")


def phase_distributed(platforms: str, bag: str) -> dict:
    """Phase 2 as four --distributed processes, one card each; their maps
    must be identical.  A process still running at DIST_TIMEOUT_S gets
    SIGABRT, on which Python's fault handler prints every thread's stack
    into its log, so a stall shows where it waits."""
    port = free_port()
    procs, logs = [], []
    t0 = time.perf_counter()
    for pid in range(4):
        env = child_env(platforms, NDT2D_DIST_COORD=f"localhost:{port}",
                        NDT2D_DIST_NPROC=4, NDT2D_DIST_PID=pid,
                        PYTHONFAULTHANDLER=1)
        log = open(os.path.join(WORK, f"dist{pid}.log"), "w+")
        logs.append(log)
        procs.append(subprocess.Popen(
            cli("run", "--bag", bag, "--map-out",
                os.path.join(WORK, f"map_dist{pid}.npz"), *SLAM_FLAGS,
                "--distributed"),
            cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT,
            text=True))
    deadline = time.monotonic() + DIST_TIMEOUT_S
    rcs = []
    try:
        for p in procs:
            try:
                rcs.append(p.wait(timeout=max(1.0, deadline
                                              - time.monotonic())))
            except subprocess.TimeoutExpired:
                rcs.append(None)
        if None in rcs:
            for p in procs:
                if p.poll() is None:
                    p.send_signal(signal.SIGABRT)
            time.sleep(10)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    say(f"  [slam-dist4] exit codes {rcs} after "
        f"{time.perf_counter() - t0:.1f} s")
    dist = []
    for pid, log in enumerate(logs):
        log.seek(0)
        lines = log.read().splitlines()
        log.close()
        if rcs[pid] != 0:
            for ln in lines[-80:]:
                say(f"  [dist{pid}] {ln}")
            raise SmokeFailure(f"distributed process {pid}: " + (
                f"exit {rcs[pid]}" if rcs[pid] is not None else
                f"no result within {DIST_TIMEOUT_S} s"))
        dist.append(last_json(lines, f"dist{pid}"))
    say("  [slam-dist4] stats: " + json.dumps(
        {k: v for k, v in dist[0].items() if k != "session"}))
    say("  [slam-dist4] session: " + json.dumps(dist[0]["session"]))
    maps = [load_map_arrays(os.path.join(WORK, f"map_dist{p}.npz"))
            for p in range(4)]
    import numpy as np
    same = all(m.keys() == maps[0].keys()
               and all(np.array_equal(m[k], maps[0][k]) for k in m)
               for m in maps[1:])
    check(same, "distributed: the four controllers' maps are identical")
    return dist[0]


def multi_gpu(platforms: str, rehearse: bool, bag: str) -> dict:
    """Phase 2 as four --distributed processes, on one card, and with
    --mesh 4; the first and last are held to the one-card run.  The
    distributed arm runs first, so a failure there ends the run early."""
    dist = phase_distributed(platforms, bag)
    one_env = child_env(platforms, **({} if rehearse
                                      else {"CUDA_VISIBLE_DEVICES": "0"}))
    one = phase_slam(one_env, bag, os.path.join(WORK, "map_one.npz"),
                     "slam-1card")
    # Rehearsal: four virtual CPU devices for the mesh.
    mesh_env = child_env(platforms, **(
        {"XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
        if rehearse else {}))
    mesh = phase_slam(mesh_env, bag, os.path.join(WORK, "map_mesh.npz"),
                      "slam-mesh4", ["--mesh", "4"])
    compare_to_one_card("distributed", dist, one)
    compare_to_one_card("mesh", mesh, one)
    return mesh["device"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi-gpu", action="store_true",
                    help="four cards: phase 2 with --mesh 4, on one card, "
                         "and as four --distributed processes")
    ap.add_argument("--rehearse", action="store_true",
                    help="CPU dry run at reduced scale (never prints ok)")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        return child_main(args.child, args.rehearse)

    for path in (os.path.join(ROOT, "ndt_2d_tpu", "cli.py"), DATASET, TRUTH,
                 os.path.join(ROOT, "native", "baseline_matcher.cpp")):
        if not os.path.exists(path):
            print(f"chip_smoke: {path} missing; run from a checkout of the "
                  f"repository", file=sys.stderr)
            return 2
    try:
        smi = None if args.rehearse else nvidia_smi_line()
    except SmokeFailure as e:
        say(f"FAILED: {e}")
        return 1
    say(f"nvidia-smi: {smi if smi else 'not run (rehearsal)'}")
    platforms = "cpu" if args.rehearse else "cuda,cpu"
    env = child_env(platforms)
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    timings = {}
    t_all = time.perf_counter()

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        say(f"== {name}")
        out = fn(*a)
        timings[name] = round(time.perf_counter() - t0, 1)
        return out

    me = [sys.executable, os.path.abspath(__file__)]
    rflag = ["--rehearse"] if args.rehearse else []
    try:
        dev = timed("phase 0: device",
                    lambda: last_json(run(me + ["--child", "device"] + rflag,
                                          env, 300, "device"), "device"))
        bag, serve_bag = timed(
            "prepare bags", prepare_bags,
            REHEARSE_SCANS if args.rehearse else None)
        if args.multi_gpu:
            device = timed("phase 2 on four cards", multi_gpu, platforms,
                           args.rehearse, bag)
        else:
            timed("phase 1: kernels",
                  lambda: run(me + ["--child", "kernels"] + rflag, env, 900,
                              "kernels"))
            if not args.rehearse:
                timed("phase 1: gpu tests", phase_gpu_tests, env)
            timed("phase 2: slam", phase_slam, env, bag,
                  os.path.join(WORK, "map.npz"), "slam")
            timed("phase 3: localize", phase_localize, env, bag,
                  os.path.join(WORK, "map.npz"))
            timed("phase 4: serve", phase_serve, env, serve_bag)
            device = dev["device"]
    except SmokeFailure as e:
        say(f"FAILED: {e}")
        say("phase seconds: " + json.dumps(timings))
        return 1
    say("phase seconds: " + json.dumps(timings)
        + f"; total {time.perf_counter() - t_all:.1f} s")
    if smi:
        say(f"card: {smi}")
    if device["platform"] != "gpu":
        say(f"FAILED: ran on {device['platform']}, not a GPU")
        return 1
    say(json.dumps({"ok": True, "device": device}))
    return 0


# --------------------------------------------------------------------------
# Children: device work.  Each prints its evidence and ends with one JSON
# line; a missed bound exits 1.
# --------------------------------------------------------------------------
def child_main(name: str, rehearse: bool) -> int:
    import jax
    if name == "device":
        from ndt_2d_tpu.utils.jax_cache import enable_compilation_cache
        cache = enable_compilation_cache()
        import jaxlib
        devs = jax.devices()
        d = devs[0]
        say(f"jax {jax.__version__} jaxlib {jaxlib.__version__}")
        say(f"devices: {devs}")
        say(f"compile cache: {cache or 'off (CPU-only platforms)'}")
        device = {"platform": d.platform, "kind": d.device_kind,
                  "count": len(devs)}
        if d.platform != "gpu" and not rehearse:
            say(f"first device is {d.platform}, not a GPU")
            return 1
        say(json.dumps({"device": device}))
        return 0
    if name == "kernels":
        return kernels(rehearse)
    raise SystemExit(f"unknown child {name!r}")


def bound(name: str, err: float, limit: float, precision: str) -> bool:
    ok = err <= limit
    say(f"{'PASS' if ok else 'FAIL'} {name}: max error {err:.3e} "
        f"(bound {limit:.1e}; {precision})")
    return ok


def np_descriptors(points, mask, range_max, n_bins=32, n_sectors=64,
                   n_rings=4):
    """float64 numpy statement of loop_search.descriptors.  Bin indices come
    from float32 ranges and angles, as on the device, so that a point on a
    bin edge lands in the same bin; everything after is float64."""
    import numpy as np
    p32 = points.astype(np.float32)
    r32 = np.sqrt(p32[..., 0] ** 2 + p32[..., 1] ** 2)
    ang = np.arctan2(p32[..., 1], p32[..., 0])
    r = np.hypot(points[..., 0].astype(np.float64),
                 points[..., 1].astype(np.float64))
    sec = np.clip(((ang + np.float32(np.pi)) / np.float32(2 * np.pi)
                   * n_sectors).astype(np.int64), 0, n_sectors - 1)
    ring = np.clip((r32 / np.float32(range_max) * n_rings).astype(np.int64),
                   0, n_rings - 1)
    hb = np.clip((r32 / np.float32(range_max) * n_bins).astype(np.int64),
                 0, n_bins - 1)
    k = np.arange(1, n_sectors // 2 + 1)
    a = np.arange(n_sectors)
    w = 2.0 * np.pi * a[:, None] * k[None, :] / n_sectors
    cos, sin = np.cos(w), np.sin(w)
    out = []
    for s in range(points.shape[0]):
        m = mask[s]
        n = max(m.sum(), 1)
        cnt = np.bincount(sec[s][m], minlength=n_sectors)
        prof = (np.bincount(sec[s][m], weights=r[s][m], minlength=n_sectors)
                / np.maximum(cnt, 1) / range_max)
        spec = np.hypot(prof @ cos, prof @ sin)
        rc = np.bincount(ring[s][m] * n_sectors + sec[s][m],
                         minlength=n_rings * n_sectors) / n
        rc = rc.reshape(n_rings, n_sectors)
        rspec = np.hypot(rc @ cos, rc @ sin).ravel()
        hist = np.bincount(hb[s][m], minlength=n_bins) / n
        d = np.concatenate([spec, rspec, hist - hist.mean()])
        norm = np.linalg.norm(d)
        out.append(d / max(norm, 1e-12) if m.any() else 0.0 * d)
    return np.asarray(out)


def np_ndt_build(poses, points, mask, origin, cell_size, width, height):
    """float64 numpy statement of the window NDT build: point counts,
    centred (two-pass) covariances (c00, c01, c11) and each cell's largest
    squared distance from the world origin."""
    import numpy as np
    p = poses.astype(np.float64)
    x = points.astype(np.float64)
    c, s = np.cos(p[:, 2:3]), np.sin(p[:, 2:3])
    w = np.stack([c * x[..., 0] - s * x[..., 1] + p[:, 0:1],
                  s * x[..., 0] + c * x[..., 1] + p[:, 1:2]], -1)
    w = w.reshape(-1, 2)
    rel = (w - origin.astype(np.float64)) / cell_size
    ix, iy = np.floor(rel[:, 0]).astype(int), np.floor(rel[:, 1]).astype(int)
    ok = mask.reshape(-1) & (ix >= 0) & (iy >= 0) & (ix < width) & (
        iy < height)
    cells, w = (iy * width + ix)[ok], w[ok]
    size = width * height
    n = np.bincount(cells, minlength=size)
    mean = np.stack([np.bincount(cells, weights=w[:, i], minlength=size)
                     for i in (0, 1)], -1) / np.maximum(n, 1)[:, None]
    d = w - mean[cells]
    cov = np.stack([np.bincount(cells, weights=d[:, i] * d[:, j],
                                minlength=size)
                    for i, j in ((0, 0), (0, 1), (1, 1))], -1)
    cov /= np.maximum(n - 1, 1)[:, None]
    r2 = np.zeros(size)
    np.maximum.at(r2, cells, (w ** 2).sum(-1))
    return n, cov, r2


def lattice_graph(side: int = 48, seed: int = 0):
    """A side x side lattice of poses with odometry and cross-bracing
    constraints (exact relative transforms) and noisy initial poses."""
    import numpy as np
    rng = np.random.default_rng(seed)
    n = side * side
    xs, ys = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    truth = np.stack([xs.ravel(), ys.ravel(), np.zeros(n)], -1).astype(float)
    init = truth + rng.normal(0, 0.08, truth.shape)
    init[0] = truth[0]
    k = np.arange(n).reshape(side, side)
    begin = np.concatenate([k[:, :-1].ravel(), k[:-1, :].ravel()])
    end = np.concatenate([k[:, 1:].ravel(), k[1:, :].ravel()])
    c = len(begin)
    tr = np.concatenate([truth[end, :2] - truth[begin, :2],
                         np.zeros((c, 1))], -1)
    info = np.tile(np.eye(3)[None] * 100.0, (c, 1, 1))
    return (truth, init.astype(np.float32), begin.astype(np.int32),
            end.astype(np.int32), tr.astype(np.float32),
            info.astype(np.float32))


def kernels(rehearse: bool) -> int:
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np

    import bench
    from ndt_2d_tpu.config import MapperConfig, ScanMatcherConfig, \
        SolverConfig
    from ndt_2d_tpu.graph import solver
    from ndt_2d_tpu.io import native
    from ndt_2d_tpu.matching import matcher
    from ndt_2d_tpu.parallel import loop_search
    from ndt_2d_tpu.utils.jax_cache import enable_compilation_cache

    enable_compilation_cache()
    dev = jax.devices()[0]
    cpu = jax.devices("cpu")[0]
    if dev.platform != "gpu" and not rehearse:
        say(f"first device is {dev.platform}, not a GPU")
        return 1
    say(f"device: {dev.device_kind} ({dev.platform}); reference backend: "
        f"{cpu.device_kind}")
    ok = True
    results = {}

    def on(d, *xs):
        return jax.device_put(xs, d)

    # -- peak device memory of one 32-row coarse confirmation chunk (first,
    # so the process peak is this program's).  Shapes: the mapper's
    # coarse-to-fine segment (mapping/mapper.py, cap 32) at the
    # office-descriptor recipe: region size 3, 512 points per scan, default
    # coarse lattice, fine matcher with 8 Newton iterations.
    mcfg = MapperConfig()
    coarse_cfg = mcfg.coarse_scan_matcher
    fine_cfg = dataclasses.replace(mcfg.global_scan_matcher,
                                   refine_iterations=8)
    (poses, wpts, wmask, qpts, qmask, n_scan,
     qpose) = bench.make_fixture(15.0)
    rows, S = 32, 3
    chunk = (np.broadcast_to(poses[:S], (rows, S, 3)).copy(),
             np.broadcast_to(wpts[:S], (rows, S) + wpts.shape[1:]).copy(),
             np.broadcast_to(wmask[:S], (rows, S) + wmask.shape[1:]).copy(),
             np.ones((rows, S), bool), np.float32(15.0),
             np.broadcast_to(qpts, (rows,) + qpts.shape).copy(),
             np.broadcast_to(qmask, (rows,) + qmask.shape).copy(),
             np.full(rows, n_scan, np.int32),
             np.broadcast_to(qpose, (rows, 3)).copy())
    chunk_dev = jax.device_put(chunk, dev)
    stats = dev.memory_stats() or {}
    before = stats.get("bytes_in_use", 0)
    jax.block_until_ready(matcher.match_scan_batch_multi_coarse_fine(
        coarse_cfg, fine_cfg, *chunk_dev))
    stats = dev.memory_stats()
    if stats:
        peak = stats["peak_bytes_in_use"]
        say(f"coarse chunk (32 rows): peak_bytes_in_use {peak} "
            f"({peak / 2**30:.3f} GiB), inputs {before} bytes, "
            f"on {dev.device_kind}")
        results["coarse_chunk_peak_bytes"] = peak
    else:
        say("coarse chunk (32 rows): peak memory not measured "
            f"({dev.platform} reports no memory stats)")
    del chunk_dev

    # -- rolling-window match at bench shapes --
    config = ScanMatcherConfig(grid_cells_x=160, grid_cells_y=160)
    assert config.num_candidates == 35280 and config.laser_max_beams == 100
    build = jax.jit(lambda p, x, m: matcher.build_window_ndt(
        config, p, x, m, jnp.ones(p.shape[0], bool), jnp.float32(15.0)))
    match = jax.jit(lambda g, q, qm, pose: matcher.match_scan(
        config, g, q, qm, jnp.int32(n_scan), pose, jnp.float32(15.0)))
    measure = jax.jit(lambda g, q, qm, parts: matcher.score_points_batch(
        config, g, q, qm, jnp.int32(n_scan), parts))

    # NDT build on each backend.  Float scatter sums run in another order
    # (on the GPU, in an order that changes from run to run), and sin/cos/
    # division may round differently, so a point on a cell edge can land
    # in the neighbouring cell.  The covariance comes from uncentred
    # moments (E[xx] - E[x]^2 in world coordinates): its float32 rounding
    # error scales with eps * R^2 (R the cell's distance from the world
    # origin), not with the covariance, and reaches about 1% of a cell's
    # trace.  Each backend's covariances are held to float64 within that
    # rounding bound; build + match scores then move by up to about 1%
    # between H100 runs, so their bound (BUILD_REL) is loose and the
    # scoring program is compared tightly on one shared grid.
    BUILD_REL = 3e-2
    g_dev = build(*on(dev, poses, wpts, wmask))
    g_cpu = build(*on(cpu, poses, wpts, wmask))
    gd, gc = jax.device_get((g_dev, g_cpu))
    occupied = np.asarray(gc.count) > 0
    same = np.asarray(gd.count) == np.asarray(gc.count)
    ok &= bound("NDT build vs CPU backend: share of occupied cells whose "
                "point count differs", float((~same & occupied).sum()
                                             / occupied.sum()), 0.02,
                "edge points may change cell")
    keep = same & (np.asarray(gc.count) >= 3)
    ok &= bound("NDT build vs CPU backend: cell means (m), equal-count "
                "cells", float(np.abs(np.asarray(gd.mean)[keep]
                                      - np.asarray(gc.mean)[keep]).max()),
                1e-4, "float32 sums in another order")
    n64, cov64, r2 = np_ndt_build(poses, wpts, wmask, np.asarray(gc.origin),
                                  float(gc.cell_size), config.grid_cells_x,
                                  config.grid_cells_y)
    eps = float(np.finfo(np.float32).eps)
    # Worst-case float32 rounding of the uncentred covariance, per cell, in
    # any summation order: sum(x^2)/n is off by <= n eps R^2 and the mean
    # by <= n eps R, so mean^2 by <= 2 n eps R^2; then n/(n-1).
    scorable = (n64 >= 5) & (np.asarray(gc.count) == n64)
    lim = ((3 * n64 + 3) * eps * r2 * n64 / np.maximum(n64 - 1, 1))[
        scorable]
    for tag, g, k in ((dev.platform, gd, 1.0), ("cpu", gc, 1.0),
                      (f"{dev.platform} vs cpu", gd, 2.0)):
        other = gc.covariance if k == 2.0 else cov64
        both = scorable & (np.asarray(g.count) == n64)
        err = np.abs(np.asarray(g.covariance) - np.asarray(other))
        err = np.where(both[:, None], err, 0.0)[scorable].max(-1)
        say(f"NDT covariance {tag}: max abs error {err.max():.3e} m^2 over "
            f"{int(both.sum())} scorable cells (median trace "
            f"{np.median(cov64[scorable][:, 0] + cov64[scorable][:, 2]):.3e}"
            f" m^2)")
        ok &= bound(f"NDT build covariances, {tag}"
                    + ("" if k == 2.0 else " vs numpy float64 (centred)")
                    + ": error / float32 rounding bound", float(
                        (err / (k * lim)).max()), 1.0,
                    f"{k:g} x (3n+3) eps32 R^2 n/(n-1) per cell")

    q_dev, qm_dev, p_dev = on(dev, qpts, qmask, qpose)
    q_cpu, qm_cpu, p_cpu = on(cpu, qpts, qmask, qpose)
    r_dev = jax.device_get(match(g_dev, q_dev, qm_dev, p_dev))
    r_cpu = jax.device_get(match(g_cpu, q_cpu, qm_cpu, p_cpu))
    r_shared = jax.device_get(match(jax.device_put(g_cpu, dev), q_dev,
                                    qm_dev, p_dev))
    c_score, c_corr, _ = native.match_baseline(
        poses, wpts, wmask, qpts, qmask, n_scan, qpose, 15.0, config)
    say(f"match: {dev.platform} score {float(r_dev.score):.6f} corr "
        f"{np.asarray(r_dev.correction)}; C++ float64 score {c_score:.6f} "
        f"corr {c_corr}; cpu score {float(r_cpu.score):.6f}; "
        f"{dev.platform} on the cpu-built grid {float(r_shared.score):.6f}")
    step = np.asarray([config.search_linear_resolution,
                       config.search_linear_resolution,
                       config.search_angular_resolution])

    def cells_apart(a, b):
        return float((np.abs(np.asarray(a) - np.asarray(b)) / step).max())

    def rel(a, b):
        return abs(float(a) - float(b)) / abs(float(b))

    ok &= bound("build + match vs C++: lattice cells apart",
                cells_apart(r_dev.correction, c_corr), 0.01, "same cell")
    ok &= bound("build + match vs C++: score (relative)",
                rel(r_dev.score, c_score), BUILD_REL,
                "float32 device build, summation order varies, vs float64 "
                "C++")
    ok &= bound("scoring program on the CPU-built grid vs C++: score "
                "(relative)", rel(r_shared.score, c_score), 4e-3,
                "float32 vs float64 C++")
    ok &= bound("scoring program vs CPU backend, one shared grid: lattice "
                "cells apart", cells_apart(r_shared.correction,
                                           r_cpu.correction), 0.01,
                "same cell")
    ok &= bound("scoring program vs CPU backend, one shared grid: score "
                "(relative)", rel(r_shared.score, r_cpu.score), 1e-5,
                "float32 both; sums in another order")
    ok &= bound("build + match vs CPU backend: lattice cells apart",
                cells_apart(r_dev.correction, r_cpu.correction), 0.01,
                "same cell")
    ok &= bound("build + match vs CPU backend: score (relative)",
                rel(r_dev.score, r_cpu.score), BUILD_REL,
                "float32 both; the NDT build's summation order, above")
    results["match_score"] = {"device": float(r_dev.score),
                              "cpp_f64": c_score,
                              "cpu": float(r_cpu.score),
                              "device_on_cpu_grid": float(r_shared.score)}

    # -- the scoring program's time: chained matches, as bench.py --
    t = bench.chained_seconds_per_match(config, g_dev, q_dev, qm_dev,
                                        jnp.int32(n_scan), p_dev, 15.0)
    card = "" if rehearse else nvidia_smi_line()
    say(f"scoring program: {t * 1e3:.4f} ms/match "
        f"({config.num_candidates / t:.3e} candidates/s), chained "
        f"x{bench.CHAIN}, best of 3, on {card or dev.device_kind}")
    results["ms_per_match"] = t * 1e3

    # -- PF measurement: 5000 particles against a 160x160 NDT --
    rng = np.random.default_rng(1)
    parts = (qpose + rng.normal(0, [0.3, 0.3, 0.1], (5000, 3))).astype(
        np.float32)
    s_shared = np.asarray(measure(jax.device_put(g_cpu, dev), q_dev, qm_dev,
                                  jax.device_put(parts, dev)))
    s_cpu = np.asarray(measure(g_cpu, q_cpu, qm_cpu,
                               jax.device_put(parts, cpu)))
    s_dev = np.asarray(measure(g_dev, q_dev, qm_dev,
                               jax.device_put(parts, dev)))
    ok &= bound("PF measurement, 5000 particles, vs CPU backend, one "
                "shared grid (score units; scores in [-1, 0])",
                float(np.abs(s_shared - s_cpu).max()), 1e-5,
                "float32 both")
    ok &= bound("PF build + measurement vs CPU backend (score units)",
                float(np.abs(s_dev - s_cpu).max()), 0.05,
                "float32 both; the NDT build's summation order, above")

    # -- descriptor DFT + top-k search vs float64 numpy --
    # Points sit inside their sector and range bins, never within a tenth
    # of a bin of an edge, so float32 rounding cannot move a point to
    # another bin than the float64 reference puts it in.
    n_kf, n_pts, rmax = 256, 512, 10.0
    rad = ((rng.integers(1, 32, (n_kf, n_pts))
            + rng.uniform(0.1, 0.9, (n_kf, n_pts))) * rmax / 32)
    th = -np.pi + ((rng.integers(0, 64, (n_kf, n_pts))
                    + rng.uniform(0.1, 0.9, (n_kf, n_pts))) * np.pi / 32)
    dpts = np.stack([rad * np.cos(th), rad * np.sin(th)], -1).astype(
        np.float32)
    dmask = rng.uniform(size=(n_kf, n_pts)) < rng.uniform(0.3, 1.0,
                                                          (n_kf, 1))
    d_dev = np.asarray(loop_search.descriptors(*on(dev, dpts, dmask),
                                               np.float32(rmax)))
    d_ref = np_descriptors(dpts, dmask, rmax)
    ok &= bound("descriptors (DFT spectra + histogram) vs numpy float64",
                float(np.abs(d_dev - d_ref).max()), 1e-4,
                "float32 with HIGHEST-precision products; the float32 "
                "DFT tables alone are off by ~1e-5")
    valid = np.ones(n_kf, bool)
    k_top, excl = 8, 10
    idx, sc = jax.device_get(loop_search.search_all_pairs(
        *on(dev, d_dev, valid), k=k_top, rolling_exclude=excl))
    sims = d_ref @ d_ref.T
    ar = np.arange(n_kf)
    sims = np.where(ar[None, :] <= ar[:, None] - excl, sims, -np.inf)
    order = np.argsort(-sims, axis=1, kind="stable")
    mism = ties = rows_cmp = 0
    for i in range(excl + k_top, n_kf):
        rows_cmp += 1
        ref_set = set(order[i, :k_top].tolist())
        if ref_set != set(idx[i].tolist()):
            gap = sims[i, order[i, k_top - 1]] - sims[i, order[i, k_top]]
            if gap < 2e-4:   # a near-tie at the k-th place
                ties += 1
            else:
                mism += 1
    ok &= bound(f"top-{k_top} search: rows with other indices than numpy "
                f"({rows_cmp} rows, {ties} near-ties excused)",
                float(mism), 0.0, "identical index sets")
    fin = np.isfinite(sc)
    ok &= bound("top-k scores vs numpy float64",
                float(np.abs(sc[fin] - np.take_along_axis(
                    sims, idx, 1)[fin]).max()), 1e-4,
                "float32, HIGHEST precision")

    # -- LM pose-graph solve, dense and PCG, 2304 nodes --
    truth, init, begin, end, tr, info = lattice_graph()
    n, c = len(init), len(begin)
    scfg = SolverConfig(max_iterations=30)
    for dense in (True, False):
        sargs = (init, begin, end, tr, info, np.ones(c, bool),
                 np.ones(n, bool))
        p_dev = jax.device_get(solver.solve(scfg, *on(dev, *sargs),
                                            use_dense=dense))
        p_cpu = jax.device_get(solver.solve(scfg, *on(cpu, *sargs),
                                            use_dense=dense))
        tag = "dense" if dense else "PCG"
        ok &= bound(f"LM {tag} ({n} nodes, {c} edges) vs CPU backend: "
                    f"poses (m)",
                    float(np.abs(np.asarray(p_dev.poses)[:, :2]
                                 - np.asarray(p_cpu.poses)[:, :2]).max()),
                    1e-3, "float32, HIGHEST precision")
        ok &= bound(f"LM {tag} vs truth: poses (m)",
                    float(np.abs(np.asarray(p_dev.poses)[:, :2]
                                 - truth[:, :2]).max()), 0.02,
                    "float32; truth is exact")
        ok &= bool(p_dev.success)

    say(json.dumps({"kernels_ok": bool(ok), **results}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
