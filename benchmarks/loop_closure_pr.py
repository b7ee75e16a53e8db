"""Loop-closure candidate recall / confirmation precision benchmark.

Without a ground-truth revisit metric nothing says whether the descriptors,
the similarity constant, or the EWMA gate decides which candidates a
loop-closure pass accepts.  This benchmark labels
TRUE revisits from the simulator's ground truth and scores each candidate
source + gate setting on:

  * candidate recall  — revisit queries whose proposal list contains a true
    revisit / all revisit queries.  A revisit query is an accepted keyframe
    with at least one earlier keyframe (outside the rolling window) within
    ``r_gt`` meters in TRUTH coordinates.
  * confirmation precision — accepted closures whose (query, candidate) pair
    is a true revisit / all accepted closures.
  * closure recall — revisit queries that got >= 1 accepted true closure.

Modes: "radius" (Graph::findNearest parity, drift-sensitive by construction:
it searches the DRIFTED pose estimates, src/graph.cpp:167-189) and
"descriptor" (appearance-based, drift-agnostic).  Scenarios: the config-3
office drift level and a 3x-drift variant where odometry error exceeds the
radius search's reach — the case the descriptor path exists for.

Usage: python benchmarks/loop_closure_pr.py [--quick] [--scenario office|
office_drift|simlab|all]
Appends rows to benchmarks/lc_pr_results.json and prints them.
"""

from __future__ import annotations

import argparse
import dataclasses as dc
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

RESULTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "lc_pr_results.json")


def label_revisits(truth_xy: np.ndarray, exclude: int, r_gt: float):
    """Per-keyframe true-revisit sets from ground truth.

    Returns a list of sets: revisit[idx] = {i : i <= idx - exclude,
    ||truth[i] - truth[idx]|| < r_gt}.
    """
    n = len(truth_xy)
    d = np.linalg.norm(truth_xy[:, None, :] - truth_xy[None, :, :], axis=-1)
    out = []
    for idx in range(n):
        limit = idx - exclude + 1
        hits = set(np.nonzero(d[idx, :max(limit, 0)] < r_gt)[0].tolist())
        out.append(hits)
    return out


def _rel_transform(pa, pb):
    """Relative transform of pb in pa's frame (constraint.cpp:35-56 math)."""
    c, s = np.cos(pa[2]), np.sin(pa[2])
    d = pb[:2] - pa[:2]
    dth = pb[2] - pa[2]
    return np.asarray([c * d[0] + s * d[1], -s * d[0] + c * d[1],
                       np.arctan2(np.sin(dth), np.cos(dth))])


def transform_error_rows(mapper, truth_used: np.ndarray,
                         tol_m: float = 0.3, tol_rad: float = 0.05):
    """Per accepted-closure transform error vs truth.

    An accepted closure is transform-TRUE iff the switchable constraint's
    relative transform matches the TRUTH relative transform of its
    (begin, end) pair within (tol_m, tol_rad) — the criterion that decides
    map quality, unlike 1 m-truth-separation set membership (a confident
    geometric match between scans taken 1-3 m apart is a GOOD edge and
    was scored false by the old criterion).  Returns a list of
    (begin, end, pos_err_m, ang_err_rad, is_true) rows.
    """
    g = mapper.graph
    n = len(truth_used)
    rows = []
    for c in range(g.num_constraints):
        if not g.constraint_switchable[c]:
            continue
        b, e = int(g.constraint_begin[c]), int(g.constraint_end[c])
        if b >= n or e >= n:
            continue
        t_est = np.asarray(g.constraint_transform[c], float)
        t_true = _rel_transform(truth_used[b], truth_used[e])
        pos_err = float(np.hypot(*(t_est[:2] - t_true[:2])))
        ang_err = float(abs(np.arctan2(np.sin(t_est[2] - t_true[2]),
                                       np.cos(t_est[2] - t_true[2]))))
        rows.append((b, e, pos_err, ang_err,
                     pos_err < tol_m and ang_err < tol_rad))
    return rows


def attribute_misses(mapper, truth_used: np.ndarray, revisits, queries,
                     cands, cand_query_xy):
    """Per-cause attribution of revisit queries whose proposal list never
    contained a true revisit (the simlab candidate-recall
    ceiling).  Causes, checked in order per missed query:

      no_points     every true revisit is a point-less scan (dropped,
                    ndt_mapper.cpp:625 parity)
      radius_reach  radius source: every true revisit's barycenter lies
                    beyond the squared-radius bound of the AT-QUERY-TIME
                    search position (drift pushed the estimate out of
                    reach)
      radius_rank   a true revisit was within reach but crowded out of the
                    global_search_limit-capped list by nearer candidates
      desc_sim      descriptor source: every true revisit's similarity is
                    below descriptor_min_similarity
      desc_rank     similarity passes but not within the top-k
      other         none of the above (e.g. query never reached a
                    loop-closure pass)
    """
    cfg = mapper.config
    g = mapper.graph
    mode = cfg.loop_search
    counts = {}
    n = len(truth_used)

    desc_sims = None
    if mode in ("descriptor", "both"):
        import jax.numpy as jnp

        from ndt_2d_tpu.parallel import loop_search
        desc = np.asarray(loop_search.descriptors(
            g.points_padded, g.point_mask_padded,
            np.float32(mapper.range_max), cfg.descriptor_bins))
        norm = np.linalg.norm(desc, axis=-1, keepdims=True)
        dn = desc / np.maximum(norm, 1e-9)
        desc_sims = dn @ dn.T  # [N, N] cosine similarity

    bary = g.barycenters() if g.use_barycenter else g.poses[:, :2]
    missed = []
    for idx in sorted(queries):
        if cands.get(idx) and (cands[idx] & revisits[idx]):
            continue  # hit
        true_set = [i for i in revisits[idx] if i < n]
        if idx not in cand_query_xy:
            counts["other"] = counts.get("other", 0) + 1
            missed.append((idx, "other"))
            continue
        if not any(g.point_mask[i].any() for i in true_set):
            counts["no_points"] = counts.get("no_points", 0) + 1
            missed.append((idx, "no_points"))
            continue
        cause = "other"
        if mode in ("radius", "both"):
            q = np.asarray(cand_query_xy[idx])
            d2 = {i: float(np.sum((bary[i] - q) ** 2)) for i in true_set
                  if g.point_mask[i].any()}
            in_reach = [i for i, d in d2.items()
                        if d < cfg.global_search_size]
            if not in_reach:
                # Sub-attribute: is the miss the BARYCENTER's geometry
                # (reverse-direction revisit: poses coincide but the
                # world-frame point means face away from each other) or
                # genuine pose drift beyond the radius?
                pd2 = min(float(np.sum((g.poses[i, :2]
                                        - g.poses[idx, :2]) ** 2))
                          for i in d2) if d2 else np.inf
                cause = ("barycenter_geometry"
                         if g.use_barycenter
                         and pd2 < cfg.global_search_size
                         else "radius_reach")
            else:
                cause = "radius_rank"
        if mode in ("descriptor", "both") and cause in ("other",
                                                        "radius_reach"):
            # The descriptor source could still have proposed it.
            sims = [float(desc_sims[idx, i]) for i in true_set
                    if g.point_mask[i].any()]
            if sims and max(sims) < cfg.descriptor_min_similarity:
                cause = "desc_sim"
            elif sims:
                # Rank among all valid earlier-than-rolling scans —
                # point-less scans carry meaningless cosines and must not
                # count toward the rank.
                limit = max(idx - cfg.rolling_depth, 0)
                valid = np.asarray([g.point_mask[i].any()
                                    for i in range(limit)], bool)
                row = np.asarray(desc_sims[idx, :limit])[valid]
                rank = int(np.sum(row > max(sims)))
                cause = ("desc_rank" if rank >= cfg.global_search_limit
                         else ("radius_reach" if mode == "both"
                               else "other"))
        counts[cause] = counts.get(cause, 0) + 1
        missed.append((idx, cause))
    return counts, missed


def score_session(mapper, truth_used: np.ndarray, r_gt: float = 1.0):
    """Recall/precision of one finished session's lc_log vs truth."""
    exclude = mapper.config.rolling_depth + 1
    revisits = label_revisits(truth_used[:, :2], exclude, r_gt)
    queries = {i for i, r in enumerate(revisits) if r}

    cands = {}
    cand_query_xy = {}
    for idx, cc, *extra in mapper.lc_log["candidates"]:
        if idx < len(revisits):
            cands.setdefault(idx, set()).update(cc)
            if extra:
                cand_query_xy[idx] = extra[0]
    hit_queries = {idx for idx in queries
                   if cands.get(idx) and (cands[idx] & revisits[idx])}

    accepted = [(idx, i) for idx, i, _, _, ok in mapper.lc_log["decisions"]
                if ok and idx < len(revisits)]
    true_accepted = [(idx, i) for idx, i in accepted if i in revisits[idx]]
    closed_queries = {idx for idx, _ in true_accepted}

    # Diagnostics: why do revisit queries fail to close?  For each revisit
    # query, was a TRUE pair ever scored, did it pass the score gate, and
    # what truth separation do the false accepts actually have?
    true_scored = set()
    true_passing = set()
    for idx, i, score, gate, ok in mapper.lc_log["decisions"]:
        if idx < len(revisits) and i in revisits[idx]:
            true_scored.add(idx)
            if score < gate:
                true_passing.add(idx)
    false_seps = [float(np.linalg.norm(truth_used[idx, :2]
                                       - truth_used[i, :2]))
                  for idx, i in accepted if i not in revisits[idx]]

    # Transform-error criterion (round 5): precision over accepted edges
    # and closure recall counting only transform-true edges.
    tf_rows = transform_error_rows(mapper, truth_used)
    tf_true = [(b, e) for b, e, _, _, ok in tf_rows if ok]
    tf_closed = {e for _, e in tf_true}
    tf_pos_errs = [p for _, _, p, _, _ in tf_rows]

    miss_counts, _ = attribute_misses(mapper, truth_used, revisits, queries,
                                      cands, cand_query_xy)

    return {
        "revisit_queries": len(queries),
        "candidate_recall": round(len(hit_queries) / max(len(queries), 1), 3),
        "miss_causes": miss_counts or None,
        "accepted": len(accepted),
        "confirmation_precision": round(
            len(true_accepted) / max(len(accepted), 1), 3),
        "closure_recall": round(
            len(closed_queries & queries) / max(len(queries), 1), 3),
        "tf_precision": round(len(tf_true) / max(len(tf_rows), 1), 3),
        "tf_closure_recall": round(
            len(tf_closed & queries) / max(len(queries), 1), 3),
        "tf_pos_err_median_m": round(float(np.median(tf_pos_errs)), 3)
        if tf_pos_errs else None,
        "tf_pos_err_max_m": round(float(np.max(tf_pos_errs)), 3)
        if tf_pos_errs else None,
        "true_pair_scored_queries": len(true_scored & queries),
        "true_pair_gate_pass_queries": len(true_passing & queries),
        "false_sep_median_m": round(float(np.median(false_seps)), 2)
        if false_seps else None,
        "false_sep_max_m": round(float(np.max(false_seps)), 2)
        if false_seps else None,
    }


def run_office(loop_search: str, gate_scale: float, min_sim: float,
               odom_scale: float, n: int, recipe: dict = None,
               gm: dict = None):
    """``recipe``: extra MapperConfig overrides (e.g. region size);
    ``gm``: extra global-matcher overrides (e.g. overlapping grids /
    Newton refinement)."""
    from ndt_2d_tpu.config import ScanMatcherConfig, SolverConfig
    from ndt_2d_tpu.io import bag as bag_mod
    from ndt_2d_tpu.mapping.mapper import Mapper
    from ndt_2d_tpu.utils import metrics

    bag = bag_mod.record_synthetic(
        "office", n, n_beams=600, range_max=12.0, seed=1,
        odom_trans_noise=0.02 * odom_scale, odom_rot_noise=0.004 * odom_scale)
    global_mcfg = ScanMatcherConfig(
        ndt_resolution=0.35, search_linear_size=0.15,
        search_linear_resolution=0.01, search_angular_size=0.05,
        grid_cells_x=160, grid_cells_y=160, **(gm or {}))
    mcfg = ScanMatcherConfig(grid_cells_x=192, grid_cells_y=192)
    from ndt_2d_tpu.config import MapperConfig
    kw = dict(
        local_scan_matcher=mcfg, global_scan_matcher=global_mcfg,
        max_points_per_scan=512, global_search_size=4.0,
        optimization_node_limit=10, loop_closure_every=20,
        minimum_travel_distance=0.3, max_inflight=8,
        loop_search=loop_search, descriptor_min_similarity=min_sim,
        loop_closure_gate_scale=gate_scale,
        solver=dc.replace(SolverConfig(), robust_loss="geman_mcclure"))
    kw.update(recipe or {})  # recipe overrides the base keys
    cfg = MapperConfig(**kw)
    mapper = Mapper(cfg)
    used_truth = []
    t0 = time.perf_counter()
    for t, (msg, odom) in enumerate(bag):
        res = mapper.process_scan(msg, odom)
        if res.accepted:
            used_truth.append(bag.truth[t])
    mapper.flush()
    mapper.loop_closure()
    wall = time.perf_counter() - t0
    used_truth = np.asarray(used_truth)
    row = score_session(mapper, used_truth)
    final = mapper.graph.poses[:len(used_truth)]
    row.update(
        ate_rmse_m=round(metrics.ate_rmse(final, used_truth), 4),
        ate_aligned_m=round(metrics.ate_rmse_aligned(final, used_truth), 4),
        odom_only_ate_m=round(metrics.ate_rmse(bag.odom, bag.truth), 4),
        far_rows_pruned=mapper.stats.far_rows_pruned,
        far_rows_cache_skipped=mapper.stats.far_rows_cache_skipped,
        wall_s=round(wall, 1))
    return row


def run_simlab(gate_scale: float, loop_search: str, min_sim: float, n=None,
               recipe: dict = None, gm: dict = None):
    from ndt_2d_tpu.config import (MapperConfig, ScanMatcherConfig,
                                   SolverConfig)
    from ndt_2d_tpu.io import carmen
    from ndt_2d_tpu.mapping.mapper import Mapper
    from ndt_2d_tpu.utils import metrics

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    bag = carmen.load_carmen(os.path.join(root, "datasets", "simlab.clf.gz"),
                             range_max=10.0)
    truth = np.load(os.path.join(root, "datasets", "simlab_truth.npz"))[
        "truth"]
    n = n or len(bag)
    global_mcfg = ScanMatcherConfig(
        ndt_resolution=0.35, search_linear_size=0.15,
        search_linear_resolution=0.01, search_angular_size=0.05,
        grid_cells_x=160, grid_cells_y=160, **(gm or {}))
    mcfg = ScanMatcherConfig(grid_cells_x=192, grid_cells_y=192)
    kw = dict(
        local_scan_matcher=mcfg, global_scan_matcher=global_mcfg,
        max_points_per_scan=512, global_search_size=4.0,
        optimization_node_limit=10, loop_closure_every=20,
        minimum_travel_distance=0.3, max_range=10.0, max_inflight=8,
        loop_search=loop_search, descriptor_min_similarity=min_sim,
        loop_closure_gate_scale=gate_scale,
        solver=dc.replace(SolverConfig(), robust_loss="geman_mcclure"))
    kw.update(recipe or {})  # recipe overrides the base keys
    cfg = MapperConfig(**kw)
    mapper = Mapper(cfg)
    used_truth = []
    t0 = time.perf_counter()
    for t in range(n):
        msg, odom = bag[t]
        res = mapper.process_scan(msg, odom)
        if res.accepted:
            used_truth.append(truth[t])
    mapper.flush()
    mapper.loop_closure()
    wall = time.perf_counter() - t0
    used_truth = np.asarray(used_truth)
    row = score_session(mapper, used_truth)
    final = mapper.graph.poses[:len(used_truth)]
    row.update(
        ate_rmse_m=round(metrics.ate_rmse(final, used_truth), 4),
        ate_aligned_m=round(metrics.ate_rmse_aligned(final, used_truth), 4),
        odom_only_ate_m=round(metrics.ate_rmse(bag.odom[:n], truth[:n]), 4),
        far_rows_pruned=mapper.stats.far_rows_pruned,
        far_rows_cache_skipped=mapper.stats.far_rows_cache_skipped,
        wall_s=round(wall, 1))
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--scenario", default="all",
                    choices=["office", "office_drift", "simlab", "all",
                             "round4", "round4b", "round4c", "round4d",
                             "round4e", "round5", "round5prune",
                             "round5simlab", "round5drift"])
    args = ap.parse_args(argv)

    from ndt_2d_tpu.utils.jax_cache import enable_compilation_cache
    enable_compilation_cache()

    n_office = 300 if args.quick else 1200
    n_simlab = 300 if args.quick else None
    rows = []

    def add(scenario, mode, gate, sim, row):
        row = dict(scenario=scenario, loop_search=mode, gate_scale=gate,
                   min_similarity=sim, **row)
        rows.append(row)
        print(json.dumps(row), flush=True)

    if args.scenario in ("office", "all"):
        for gate in (0.85, 1.0, 1.15):
            add("office", "radius", gate, None,
                run_office("radius", gate, 0.95, 1.0, n_office))
        for sim_t in (0.90, 0.95, 0.97):
            add("office", "descriptor", 1.0, sim_t,
                run_office("descriptor", 1.0, sim_t, 1.0, n_office))

    if args.scenario in ("office_drift", "all"):
        # 3x odometry noise: drift exceeds the 2 m radius search reach —
        # the descriptor path's reason to exist.
        for mode, sim_t in (("radius", None), ("descriptor", 0.90),
                            ("descriptor", 0.95)):
            add("office_drift", mode, 1.0, sim_t,
                run_office(mode, 1.0, sim_t or 0.95, 3.0, n_office))

    if args.scenario in ("simlab", "all"):
        for gate in (0.85, 1.0, 1.15):
            add("simlab", "radius", gate, None,
                run_simlab(gate, "radius", 0.95, n_simlab))

    if args.scenario == "round4":
        # Region-3 confirmation windows, Newton-polished
        # overlapping-grid global matcher, the "both" candidate union, and
        # the drift case — swept against the round-3 shipped recipe.
        R3 = {"loop_closure_region_size": 3}
        NEWTON = {"refine_iterations": 8}
        OVER = {"overlapping_grids": True, "refine_iterations": 8}

        def tag(name, mode, gate, sim, row, **extra):
            row = dict(scenario=name, loop_search=mode, gate_scale=gate,
                       min_similarity=sim, **extra, **row)
            rows.append(row)
            print(json.dumps(row), flush=True)

        for recipe_name, recipe, gm in (
                ("region3", R3, None),
                ("region3+newton", R3, NEWTON),
                ("region3+overlap+newton", R3, OVER)):
            tag("office", "radius", 0.85, None,
                run_office("radius", 0.85, 0.95, 1.0, n_office,
                           recipe=recipe, gm=gm), recipe=recipe_name)
        tag("office", "both", 0.85, 0.90,
            run_office("both", 0.85, 0.90, 1.0, n_office, recipe=R3),
            recipe="region3")
        for mode, sim_t in (("radius", None), ("descriptor", 0.90),
                            ("both", 0.90)):
            tag("office_drift", mode, 1.0, sim_t,
                run_office(mode, 1.0, sim_t or 0.95, 3.0, n_office,
                           recipe=R3), recipe="region3")
        tag("simlab", "radius", 0.85, None,
            run_simlab(0.85, "radius", 0.95, n_simlab, recipe=R3),
            recipe="region3")
        tag("simlab", "both", 0.85, 0.90,
            run_simlab(0.85, "both", 0.90, n_simlab, recipe=R3),
            recipe="region3")

    if args.scenario == "round4b":
        # Gate recalibration for region-3 confirmation NDTs: the denser
        # regions score much closer to the 10-scan rolling EWMA, so the
        # round-3 scale (0.85, i.e. LOOSER than reference) over-accepts.
        R3 = {"loop_closure_region_size": 3}
        N8 = {"refine_iterations": 8}

        def tag(name, mode, gate, sim, row, **extra):
            row = dict(scenario=name, loop_search=mode, gate_scale=gate,
                       min_similarity=sim, **extra, **row)
            rows.append(row)
            print(json.dumps(row), flush=True)

        for gate in (0.95, 1.0, 1.05, 1.1):
            tag("office", "radius", gate, None,
                run_office("radius", gate, 0.95, 1.0, n_office,
                           recipe=R3, gm=N8), recipe="region3+newton")
        for gate in (1.05, 1.1, 1.2):
            tag("office_drift", "both", gate, 0.90,
                run_office("both", gate, 0.90, 3.0, n_office,
                           recipe=R3, gm=N8), recipe="region3+newton")
        for gate in (1.0, 1.1):
            tag("simlab", "radius", gate, None,
                run_simlab(gate, "radius", 0.95, n_simlab, recipe=R3,
                           gm=N8), recipe="region3+newton")

    if args.scenario == "round4c":
        # accept="best" (at most one closure per query per pass — kills the
        # correlated redundant accepts adjacent region-3 windows produce)
        # + the matched-separation gate (the match's own estimate of how
        # far apart the scans were taken must be < 1.5 m — the measured
        # false-accept class is 1-2 m-separation geometric matches).
        RB = {"loop_closure_region_size": 3, "loop_closure_accept": "best",
              "loop_closure_max_separation": 1.5}
        N8 = {"refine_iterations": 8}

        def tag(name, mode, gate, sim, row, **extra):
            row = dict(scenario=name, loop_search=mode, gate_scale=gate,
                       min_similarity=sim, **extra, **row)
            rows.append(row)
            print(json.dumps(row), flush=True)

        for gate in (0.85, 0.95):
            tag("office", "radius", gate, None,
                run_office("radius", gate, 0.95, 1.0, n_office,
                           recipe=RB, gm=N8),
                recipe="region3+newton+best+sep1.5")
        for gate in (0.85, 0.95, 1.05):
            tag("office_drift", "both", gate, 0.90,
                run_office("both", gate, 0.90, 3.0, n_office,
                           recipe=RB, gm=N8),
                recipe="region3+newton+best+sep1.5")
        for gate in (0.85, 0.95):
            tag("simlab", "radius", gate, None,
                run_simlab(gate, "radius", 0.95, n_simlab, recipe=RB,
                           gm=N8), recipe="region3+newton+best+sep1.5")
        tag("simlab", "both", 0.85, 0.90,
            run_simlab(0.85, "both", 0.90, n_simlab, recipe=RB, gm=N8),
            recipe="region3+newton+best+sep1.5")

    if args.scenario == "round4d":
        # Drift-case candidate recall: wider descriptor top-k and lower
        # similarity cutoff (best+separation guard the precision side), and
        # the office operating point between the 4c gates.
        N8 = {"refine_iterations": 8}

        def tag(name, mode, gate, sim, row, **extra):
            row = dict(scenario=name, loop_search=mode, gate_scale=gate,
                       min_similarity=sim, **extra, **row)
            rows.append(row)
            print(json.dumps(row), flush=True)

        for sim_t, k in ((0.85, 8), (0.80, 8), (0.85, 12)):
            rb = {"loop_closure_region_size": 3,
                  "loop_closure_accept": "best",
                  "loop_closure_max_separation": 1.5,
                  "global_search_limit": k}
            tag("office_drift", "both", 0.85, sim_t,
                run_office("both", 0.85, sim_t, 3.0, n_office,
                           recipe=rb, gm=N8),
                recipe=f"region3+newton+best+sep1.5+k{k}")
        for gate, sep in ((0.90, 1.5), (0.90, 1.0), (0.95, 1.0)):
            rb = {"loop_closure_region_size": 3,
                  "loop_closure_accept": "best",
                  "loop_closure_max_separation": sep}
            tag("office", "radius", gate, None,
                run_office("radius", gate, 0.95, 1.0, n_office,
                           recipe=rb, gm=N8),
                recipe=f"region3+newton+best+sep{sep}")

    if args.scenario == "round4e":
        # The wide-heading coarse lattice (config.py: ±0.5 rad — the old
        # ±0.1 rad covered only ~1σ of the 3x-drift heading error, so
        # descriptor-proposed true revisits were unconfirmable): drift
        # variants around the best 4c/4d operating point.
        N8 = {"refine_iterations": 8}

        def tag(name, mode, gate, sim, row, **extra):
            row = dict(scenario=name, loop_search=mode, gate_scale=gate,
                       min_similarity=sim, **extra, **row)
            rows.append(row)
            print(json.dumps(row), flush=True)

        for sim_t, k, sep in ((0.85, 8, 1.5), (0.85, 8, 1.0),
                              (0.80, 8, 1.5), (0.85, 5, 1.5)):
            rb = {"loop_closure_region_size": 3,
                  "loop_closure_accept": "best",
                  "loop_closure_max_separation": sep,
                  "global_search_limit": k}
            tag("office_drift", "both", 0.85, sim_t,
                run_office("both", 0.85, sim_t, 3.0, n_office,
                           recipe=rb, gm=N8),
                recipe=f"wide+best+sep{sep}+k{k}")

    if args.scenario == "round5":
        # The round-4 office operating points re-scored on
        # the transform-error criterion (tf_precision / tf_closure_recall
        # now emitted by score_session for every row).
        N8 = {"refine_iterations": 8}
        R3 = {"loop_closure_region_size": 3}
        RB = {"loop_closure_region_size": 3, "loop_closure_accept": "best",
              "loop_closure_max_separation": 1.5}

        def tag(name, mode, gate, sim, row, **extra):
            row = dict(scenario=name, loop_search=mode, gate_scale=gate,
                       min_similarity=sim, **extra, **row)
            rows.append(row)
            print(json.dumps(row), flush=True)

        tag("office", "radius", 0.85, None,
            run_office("radius", 0.85, 0.95, 1.0, n_office,
                       recipe=R3, gm=N8), recipe="region3+newton")
        tag("office", "radius", 0.95, None,
            run_office("radius", 0.95, 0.95, 1.0, n_office,
                       recipe=RB, gm=N8),
            recipe="region3+newton+best+sep1.5")
        tag("simlab", "radius", 1.0, None,
            run_simlab(1.0, "radius", 0.95, n_simlab, recipe=R3, gm=N8),
            recipe="region3+newton")

    if args.scenario == "round5simlab":
        # Lift the simlab candidate-recall ceiling.  The
        # baseline row's miss_causes attribution picks the lever; the
        # sweep then measures the candidate fixes (larger squared radius,
        # higher candidate cap, descriptor union).
        N8 = {"refine_iterations": 8}
        R3 = {"loop_closure_region_size": 3}

        def tag(name, mode, gate, sim, row, **extra):
            row = dict(scenario=name, loop_search=mode, gate_scale=gate,
                       min_similarity=sim, **extra, **row)
            rows.append(row)
            print(json.dumps(row), flush=True)

        # The attribution run proved every baseline miss is barycenter
        # geometry (reverse-direction revisits); the dual-position search
        # with a per-arm budget closes it.  region 3 = accuracy-optimal,
        # region 5 = the closure-recall recipe.
        for rname, extra in (
                ("r4-baseline", {}),
                ("bothpos-region3", {"loop_search_positions": "both"}),
                ("bothpos-region5", {"loop_search_positions": "both",
                                     "loop_closure_region_size": 5})):
            tag("simlab", "radius", 1.0, None,
                run_simlab(1.0, "radius", 0.95, n_simlab,
                           recipe={**R3, **extra}, gm=N8), recipe=rname)

    if args.scenario == "round5drift":
        # Pruning-safety check on the 3x-drift case, where FAR rows are
        # the TRUE revisits (the opposite regime from the alias-heavy
        # office): the round-4 recipe with and without the round-5
        # pruning levers.  Done = recall/ATE hold.
        N8 = {"refine_iterations": 8}
        rb = {"loop_closure_region_size": 3, "loop_closure_accept": "best",
              "loop_closure_max_separation": 1.5, "global_search_limit": 8}
        prune = {"loop_closure_far_dedup": 2.5,
                 "loop_closure_reject_cache_margin": 0.10,
                 "loop_closure_max_far_rows": 16}

        def tag(name, mode, gate, sim, row, **extra):
            row = dict(scenario=name, loop_search=mode, gate_scale=gate,
                       min_similarity=sim, **extra, **row)
            rows.append(row)
            print(json.dumps(row), flush=True)

        n_drift = 300  # the round-4 quick drift bag (round4e scenario)
        for rname, extra in (("wide+best+sep1.5+k8", {}),
                             ("wide+best+sep1.5+k8+prune", prune)):
            tag("office_drift", "both", 0.85, 0.80,
                run_office("both", 0.85, 0.80, 3.0, n_drift,
                           recipe={**rb, **extra}, gm=N8), recipe=rname)

    if args.scenario == "round5prune":
        # The descriptor-mode wall.  A/B the far-row
        # pruning levers on the config-6-shaped office descriptor recipe;
        # the full-size result lands in run_benchmarks config 6.
        N8 = {"refine_iterations": 8}
        base = {"loop_closure_region_size": 3,
                "loop_closure_accept": "best",
                "loop_closure_max_separation": 1.5}

        def tag(name, mode, gate, sim, row, **extra):
            row = dict(scenario=name, loop_search=mode, gate_scale=gate,
                       min_similarity=sim, **extra, **row)
            rows.append(row)
            print(json.dumps(row), flush=True)

        for rname, extra in (
                ("noprune", {}),
                ("dedup1.5", {"loop_closure_far_dedup": 1.5}),
                ("dedup1.5+cache.05",
                 {"loop_closure_far_dedup": 1.5,
                  "loop_closure_reject_cache_margin": 0.05}),
                ("dedup2.5+cache.10+cap16",
                 {"loop_closure_far_dedup": 2.5,
                  "loop_closure_reject_cache_margin": 0.10,
                  "loop_closure_max_far_rows": 16})):
            tag("office", "descriptor", 0.85, 0.90,
                run_office("descriptor", 0.85, 0.90, 1.0, n_office,
                           recipe={**base, **extra}, gm=N8), recipe=rname)

    existing = []
    if os.path.exists(RESULTS):
        with open(RESULTS) as f:
            existing = json.load(f)
    stamp = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
    for r in rows:
        r["ts"] = stamp
    existing.extend(rows)
    with open(RESULTS, "w") as f:
        json.dump(existing, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
