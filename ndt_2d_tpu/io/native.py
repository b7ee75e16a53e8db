"""ctypes bindings for the native C++ runtime components.

Builds native/libndt2d_native.so on demand (g++ is in the image; pybind11 is
not, so the boundary is a plain C ABI + numpy pointers).  Provides:

* ``match_baseline``  — the single-core C++ matcher used as the benchmark
  baseline and float64 oracle (bench.py, chip_smoke.py),
* ``save_graph`` / ``load_graph`` — the fast binary map codec (the rosbag2
  replacement for large maps; npz remains the portable default).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "build", "libndt2d_native.so")
_SOURCES = ["baseline_matcher.cpp", "graph_codec.cpp", "bag_codec.cpp",
            "reference_pipeline.cpp"]

_lib: Optional[ctypes.CDLL] = None


def build(force: bool = False) -> str:
    """Compile the native library if missing; returns the .so path."""
    srcs = [os.path.join(_NATIVE_DIR, s) for s in _SOURCES]
    if not force and os.path.exists(_SO_PATH):
        newest_src = max(os.path.getmtime(s) for s in srcs)
        if os.path.getmtime(_SO_PATH) >= newest_src:
            return _SO_PATH
    os.makedirs(os.path.dirname(_SO_PATH), exist_ok=True)
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC",
           "-o", _SO_PATH] + srcs
    subprocess.run(cmd, check=True, capture_output=True)
    return _SO_PATH


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        lib.ndt2d_match_baseline.restype = ctypes.c_double
        lib.ndt2d_reference_slam.restype = ctypes.c_int
        lib.ndt2d_save_graph.restype = ctypes.c_int
        lib.ndt2d_graph_header.restype = ctypes.c_int
        lib.ndt2d_load_graph.restype = ctypes.c_int
        lib.ndt2d_save_bag.restype = ctypes.c_int
        lib.ndt2d_bag_header.restype = ctypes.c_int
        lib.ndt2d_load_bag.restype = ctypes.c_int
        _lib = lib
    return _lib


def available() -> bool:
    try:
        _load()
        return True
    except Exception:
        return False


def _ptr(a: np.ndarray, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def match_baseline(window_poses, window_points, window_mask, scan_points,
                   scan_mask, n_scan_points, pose, range_max, config
                   ) -> Tuple[float, np.ndarray, int]:
    """Run the C++ baseline matcher once.

    Returns (score, correction [3], candidates_evaluated).
    """
    lib = _load()
    wp = np.ascontiguousarray(window_poses, np.float32)
    wpts = np.ascontiguousarray(window_points, np.float32)
    wm = np.ascontiguousarray(window_mask, np.uint8)
    sp = np.ascontiguousarray(scan_points, np.float32)
    sm = np.ascontiguousarray(scan_mask, np.uint8)
    ps = np.ascontiguousarray(pose, np.float32)
    corr = np.zeros(3, np.float32)
    cands = ctypes.c_longlong(0)
    s, p = wpts.shape[0], wpts.shape[1]
    score = lib.ndt2d_match_baseline(
        _ptr(wp, ctypes.c_float), _ptr(wpts, ctypes.c_float),
        _ptr(wm, ctypes.c_uint8), ctypes.c_int(s), ctypes.c_int(p),
        _ptr(sp, ctypes.c_float), _ptr(sm, ctypes.c_uint8),
        ctypes.c_int(int(n_scan_points)), _ptr(ps, ctypes.c_float),
        ctypes.c_double(range_max), ctypes.c_double(config.ndt_resolution),
        ctypes.c_double(config.search_angular_resolution),
        ctypes.c_double(config.search_angular_size),
        ctypes.c_double(config.search_linear_resolution),
        ctypes.c_double(config.search_linear_size),
        ctypes.c_int(config.laser_max_beams),
        _ptr(corr, ctypes.c_float), ctypes.byref(cands))
    return float(score), corr, int(cands.value)


def reference_slam(points, mask, odom, range_max, mapper_cfg,
                   gate_scale: float = 1.0):
    """Run the reference-shaped full C++ SLAM pipeline on pre-projected
    scans (native/reference_pipeline.cpp): rolling-window matching, radius
    loop closure with the EWMA gate, Gauss-Newton optimization.

    This is the trajectory ORACLE the JAX pipeline's ATE is compared
    against (benchmarks/reference_oracle.py) — the reference itself
    publishes no numbers, so this from-scratch reimplementation of its
    node loop (src/ndt_mapper.cpp:495-683) creates them.

    Args:
      points: [T, P, 2] float32 robot-frame projected points; mask: [T, P];
      odom: [T, 3] odometry poses; mapper_cfg: MapperConfig (local/global
      matcher settings + gates/cadences are read from it).
    Returns (poses [A, 3], accepted_ids [A], n_closures, n_optimizations).
    """
    lib = _load()
    pts = np.ascontiguousarray(points, np.float32)
    msk = np.ascontiguousarray(mask, np.uint8)
    od = np.ascontiguousarray(odom, np.float64)
    T, P = msk.shape
    poses_out = np.zeros((T, 3), np.float64)
    ids_out = np.zeros(T, np.int32)
    ncl = ctypes.c_int(0)
    nopt = ctypes.c_int(0)
    lc = mapper_cfg.local_scan_matcher
    gc = mapper_cfg.global_scan_matcher
    n = lib.ndt2d_reference_slam(
        _ptr(pts, ctypes.c_float), _ptr(msk, ctypes.c_uint8),
        _ptr(od, ctypes.c_double), ctypes.c_int(T), ctypes.c_int(P),
        ctypes.c_double(range_max),
        ctypes.c_double(mapper_cfg.minimum_travel_distance),
        ctypes.c_double(mapper_cfg.minimum_travel_rotation),
        ctypes.c_int(mapper_cfg.rolling_depth),
        ctypes.c_double(lc.ndt_resolution),
        ctypes.c_double(lc.search_angular_resolution),
        ctypes.c_double(lc.search_angular_size),
        ctypes.c_double(lc.search_linear_resolution),
        ctypes.c_double(lc.search_linear_size),
        ctypes.c_double(gc.ndt_resolution),
        ctypes.c_double(gc.search_angular_resolution),
        ctypes.c_double(gc.search_angular_size),
        ctypes.c_double(gc.search_linear_resolution),
        ctypes.c_double(gc.search_linear_size),
        ctypes.c_int(lc.laser_max_beams),
        ctypes.c_double(mapper_cfg.global_search_size),
        ctypes.c_int(mapper_cfg.global_search_limit),
        ctypes.c_int(mapper_cfg.optimization_node_limit),
        ctypes.c_int(mapper_cfg.loop_closure_every),
        ctypes.c_double(gate_scale),
        _ptr(poses_out, ctypes.c_double), _ptr(ids_out, ctypes.c_int32),
        ctypes.byref(ncl), ctypes.byref(nopt))
    return (poses_out[:n], ids_out[:n], int(ncl.value), int(nopt.value))


def save_graph(graph, path: str) -> None:
    lib = _load()
    poses = np.ascontiguousarray(graph.poses, np.float64)
    points = np.ascontiguousarray(graph.points, np.float32)
    mask = np.ascontiguousarray(graph.point_mask, np.uint8)
    begin = np.ascontiguousarray(graph.constraint_begin, np.int32)
    end = np.ascontiguousarray(graph.constraint_end, np.int32)
    tr = np.ascontiguousarray(graph.constraint_transform, np.float64)
    info = np.ascontiguousarray(graph.constraint_information, np.float64)
    sw = np.ascontiguousarray(graph.constraint_switchable, np.uint8)
    rc = lib.ndt2d_save_graph(
        path.encode(), ctypes.c_int(graph.num_scans),
        ctypes.c_int(graph.max_points), _ptr(poses, ctypes.c_double),
        _ptr(points, ctypes.c_float), _ptr(mask, ctypes.c_uint8),
        ctypes.c_int(graph.num_constraints), _ptr(begin, ctypes.c_int32),
        _ptr(end, ctypes.c_int32), _ptr(tr, ctypes.c_double),
        _ptr(info, ctypes.c_double), _ptr(sw, ctypes.c_uint8))
    if rc != 0:
        raise IOError(f"native save_graph failed: rc={rc}")


def save_bag(bag, path: str) -> None:
    """Write a ScanBag in the native binary format (large sequential I/O)."""
    lib = _load()
    ranges = np.ascontiguousarray(bag.ranges, np.float32)
    odom = np.ascontiguousarray(bag.odom, np.float64)
    has_truth = bag.truth is not None
    truth = (np.ascontiguousarray(bag.truth, np.float64) if has_truth
             else np.zeros((0, 3)))
    t, n = ranges.shape
    rc = lib.ndt2d_save_bag(
        path.encode(), ctypes.c_int(t), ctypes.c_int(n),
        ctypes.c_uint8(1 if has_truth else 0),
        ctypes.c_double(bag.angle_min), ctypes.c_double(bag.angle_increment),
        ctypes.c_double(bag.time_increment), ctypes.c_double(bag.range_max),
        _ptr(ranges, ctypes.c_float), _ptr(odom, ctypes.c_double),
        _ptr(truth, ctypes.c_double))
    if rc != 0:
        raise IOError(f"native save_bag failed: rc={rc}")


def load_bag(path: str):
    """Read a native-format ScanBag."""
    from ndt_2d_tpu.io.bag import ScanBag
    lib = _load()
    t = ctypes.c_int(0)
    n = ctypes.c_int(0)
    ht = ctypes.c_uint8(0)
    am = ctypes.c_double(0)
    ai = ctypes.c_double(0)
    ti = ctypes.c_double(0)
    rm = ctypes.c_double(0)
    rc = lib.ndt2d_bag_header(path.encode(), ctypes.byref(t), ctypes.byref(n),
                              ctypes.byref(ht), ctypes.byref(am),
                              ctypes.byref(ai), ctypes.byref(ti),
                              ctypes.byref(rm))
    if rc != 0:
        raise IOError(f"native bag header read failed: rc={rc}")
    ranges = np.zeros((t.value, n.value), np.float32)
    odom = np.zeros((t.value, 3), np.float64)
    truth = np.zeros((t.value, 3), np.float64) if ht.value else None
    rc = lib.ndt2d_load_bag(
        path.encode(), _ptr(ranges, ctypes.c_float),
        _ptr(odom, ctypes.c_double),
        _ptr(truth, ctypes.c_double) if truth is not None else None)
    if rc != 0:
        raise IOError(f"native load_bag failed: rc={rc}")
    return ScanBag(ranges=ranges, angle_min=am.value,
                   angle_increment=ai.value, time_increment=ti.value,
                   range_max=rm.value, odom=odom, truth=truth)


def load_graph(path: str, max_points_per_scan: int, use_barycenter=True):
    from ndt_2d_tpu.graph.pose_graph import Graph
    lib = _load()
    ns = ctypes.c_int(0)
    mp = ctypes.c_int(0)
    nc = ctypes.c_int(0)
    rc = lib.ndt2d_graph_header(path.encode(), ctypes.byref(ns),
                                ctypes.byref(mp), ctypes.byref(nc))
    if rc != 0:
        raise IOError(f"native graph header read failed: rc={rc}")
    s, p, c = ns.value, mp.value, nc.value
    poses = np.zeros((s, 3), np.float64)
    points = np.zeros((s, p, 2), np.float32)
    mask = np.zeros((s, p), np.uint8)
    begin = np.zeros(c, np.int32)
    end = np.zeros(c, np.int32)
    tr = np.zeros((c, 3), np.float64)
    info = np.zeros((c, 3, 3), np.float64)
    sw = np.zeros(c, np.uint8)
    rc = lib.ndt2d_load_graph(
        path.encode(), _ptr(poses, ctypes.c_double),
        _ptr(points, ctypes.c_float), _ptr(mask, ctypes.c_uint8),
        _ptr(begin, ctypes.c_int32), _ptr(end, ctypes.c_int32),
        _ptr(tr, ctypes.c_double), _ptr(info, ctypes.c_double),
        _ptr(sw, ctypes.c_uint8))
    if rc != 0:
        raise IOError(f"native load_graph failed: rc={rc}")

    graph = Graph(max_points_per_scan, use_barycenter)
    mask = mask.astype(bool)
    q = min(p, max_points_per_scan)
    for i in range(s):
        pp = np.zeros((max_points_per_scan, 2), np.float32)
        mm = np.zeros(max_points_per_scan, bool)
        pp[:q] = points[i, :q]
        mm[:q] = mask[i, :q]
        graph.add_scan(poses[i], pp, mm)
    for j in range(c):
        graph.add_constraint(int(begin[j]), int(end[j]), tr[j], info[j],
                             bool(sw[j]))
    return graph
