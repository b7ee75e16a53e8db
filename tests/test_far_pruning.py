"""Far-candidate pruning mechanics (config.loop_closure_far_dedup /
loop_closure_reject_cache_margin / loop_closure_max_far_rows).

The descriptor-mode wall is spent coarse-confirming repeated appearance
aliases; these pin the pruning levers that remove the redundant rows —
the per-pass spatial dedup, the similarity-ranked cap, and the cross-pass
negative cache — at the mechanism level (benchmarks/run_benchmarks.py
config 6 measures the effect).
"""

import dataclasses

import numpy as np

from ndt_2d_tpu.config import MapperConfig, ScanMatcherConfig
from ndt_2d_tpu.graph import pose_graph
from ndt_2d_tpu.mapping.mapper import Mapper

MCFG = ScanMatcherConfig(grid_cells_x=96, grid_cells_y=96)


def make_mapper(**over):
    cfg = MapperConfig(local_scan_matcher=MCFG, global_scan_matcher=MCFG,
                       max_points_per_scan=64, loop_search="descriptor",
                       global_search_size=1.0, loop_closure_every=10**9,
                       **over)
    mapper = Mapper(cfg)
    mapper.range_max = 10.0
    mapper._ensure_matchers(10.0)
    g = mapper.graph
    pts = np.zeros((64, 2), np.float32)
    mask = np.zeros(64, bool)
    mask[:8] = True
    # 40 keyframes on a line at 1 m spacing.
    for k in range(40):
        g.add_scan(np.asarray([float(k), 0.0, 0.0]), pts, mask)
        if k:
            pose_graph.make_constraint_np(g, k - 1, k,
                                          np.diag([1e-3, 1e-3, 1e-4]))
    return mapper


class TestPruneFarPass:
    def test_off_by_default(self):
        mapper = make_mapper()
        pending = [(30, [2, 3]), (31, [2])]
        for (j, cands) in pending:
            for i in cands:
                mapper._desc_sim[(j, i)] = 0.9
        assert mapper._prune_far_pass(pending) == pending
        assert mapper.stats.far_rows_pruned == 0

    def test_dedup_keeps_one_row_per_site_pair(self):
        mapper = make_mapper(loop_closure_far_dedup=1.5)
        # Queries 30/31 (1 m apart) both propose candidates 2/3 (1 m
        # apart): one site pair -> one surviving row, the highest-sim one.
        pending = [(30, [2, 3]), (31, [2])]
        sims = {(30, 2): 0.90, (30, 3): 0.95, (31, 2): 0.85}
        mapper._desc_sim.update(sims)
        out = mapper._prune_far_pass(pending)
        assert out == [(30, [3])]
        assert mapper.stats.far_rows_pruned == 2

    def test_near_rows_always_survive(self):
        mapper = make_mapper(loop_closure_far_dedup=1.5)
        # Candidate 29 is within sqrt(global_search_size)=1 m of query 30
        # -> near row, untouched by the far dedup.
        pending = [(30, [29, 2]), (31, [2])]
        mapper._desc_sim.update({(30, 2): 0.9, (31, 2): 0.95})
        out = mapper._prune_far_pass(pending)
        assert out == [(30, [29]), (31, [2])]

    def test_cap_ranks_by_similarity(self):
        mapper = make_mapper(loop_closure_max_far_rows=1)
        # Far site pairs: (30, 2) and (30, 20) are distinct candidate
        # sites; the cap keeps only the highest-similarity row.
        pending = [(30, [2, 20])]
        mapper._desc_sim.update({(30, 2): 0.80, (30, 20): 0.99})
        out = mapper._prune_far_pass(pending)
        assert out == [(30, [20])]

    def test_distinct_sites_survive_dedup(self):
        mapper = make_mapper(loop_closure_far_dedup=1.5)
        # Candidates 2 and 20 are 18 m apart: both survive.
        pending = [(30, [2, 20])]
        mapper._desc_sim.update({(30, 2): 0.9, (30, 20): 0.9})
        out = mapper._prune_far_pass(pending)
        assert out == [(30, [2, 20])]


class TestRejectCache:
    def test_clear_rejection_populates_and_accept_clears(self):
        mapper = make_mapper(loop_closure_reject_cache_margin=0.05)
        g = mapper.graph
        idx, far_i = g.num_scans - 1, 2
        start = g.poses[idx].copy()
        # Clear rejection: score far above the (negative) gate.
        assert not mapper._apply_gate(idx, far_i, start, -0.01,
                                      np.zeros(3), np.eye(3) * 1e-3)
        key = mapper._far_key(idx, far_i)
        assert key in mapper._reject_cache
        # A near rejection must NOT populate (only far rows are cached).
        assert not mapper._apply_gate(idx, idx - 1, start, -0.01,
                                      np.zeros(3), np.eye(3) * 1e-3)
        assert len(mapper._reject_cache) == 1
        # An acceptance invalidates the cache (graph moved).
        assert mapper._apply_gate(idx, 3, start, -10.0,
                                  np.zeros(3), np.eye(3) * 1e-3)
        assert not mapper._reject_cache

    def test_borderline_rejection_not_cached(self):
        mapper = make_mapper(loop_closure_reject_cache_margin=0.10)
        g = mapper.graph
        idx = g.num_scans - 1
        gate = mapper.typical_matcher_response  # gate_scale = 1.0
        # Missed the gate by less than 10% of |gate|: not a clear miss.
        score = gate + 0.05 * abs(gate)
        assert not mapper._apply_gate(idx, 2, g.poses[idx].copy(), score,
                                      np.zeros(3), np.eye(3) * 1e-3)
        assert not mapper._reject_cache

    def test_cached_site_skipped_in_candidates(self):
        mapper = make_mapper(loop_closure_reject_cache_margin=0.05,
                             descriptor_min_similarity=0.0)
        g = mapper.graph
        idx = g.num_scans - 1
        mapper._reject_cache[mapper._far_key(idx, 2)] = -0.01
        import jax.numpy as jnp
        # Descriptor table where candidate 2 would rank first.
        desc = np.zeros((g.points_padded.shape[0], 8), np.float32)
        desc[idx] = 1.0
        desc[2] = 1.0
        desc[20, 0] = 1.0
        valid = np.arange(len(desc)) < g.num_scans
        before = mapper.stats.far_rows_cache_skipped
        out = mapper._loop_candidates(idx, jnp.asarray(desc),
                                      jnp.asarray(valid))
        assert 2 not in out
        assert mapper.stats.far_rows_cache_skipped == before + 1


class TestRadiusArmInteractions:
    """Round-5 review fixes: the pruning machinery must treat
    radius-sourced far rows correctly (they carry precise start poses and
    no descriptor similarity)."""

    def test_radius_far_rows_rank_first_in_prune(self):
        # Far rows without a _desc_sim entry (radius-sourced) must survive
        # the cap ahead of descriptor rows with real similarities.
        mapper = make_mapper(loop_closure_max_far_rows=1)
        pending = [(30, [2]), (31, [3])]
        mapper._desc_sim[(31, 3)] = 0.99    # descriptor row
        # (30, 2) has NO sim entry -> radius-sourced -> ranks first.
        out = mapper._prune_far_pass(pending)
        kept = [(j, i) for j, cands in out for i in cands]
        assert (30, 2) in kept
        assert (31, 3) not in kept

    def test_radius_candidates_consult_reject_cache(self):
        # A cached clearly-rejected far site must be skipped when the
        # RADIUS arm re-proposes it, not only the descriptor arm.  The
        # radius arm can propose a FAR row exactly in the facing-each-other
        # geometry: barycenters meet in the middle (within the search
        # radius) while the poses are far apart.
        cfg = MapperConfig(local_scan_matcher=MCFG, global_scan_matcher=MCFG,
                           max_points_per_scan=64, loop_search="both",
                           global_search_size=25.0,    # squared: 5 m
                           loop_closure_every=10**9, global_search_limit=40,
                           loop_closure_reject_cache_margin=0.05)
        mapper = Mapper(cfg)
        mapper.range_max = 30.0
        mapper._ensure_matchers(30.0)
        g = mapper.graph
        fwd = np.zeros((64, 2), np.float32)
        fwd[:8] = [20.0, 0.0]          # beams 20 m ahead in scan frame
        mask = np.zeros(64, bool)
        mask[:8] = True
        empty = np.zeros((64, 2), np.float32)
        # Candidate 0 at x=2 facing +x: barycenter at x=22.
        g.add_scan(np.asarray([2.0, 0.0, 0.0]), fwd, mask)
        # Filler keyframes far away in y (outside every search).
        for k in range(1, 12):
            g.add_scan(np.asarray([100.0 + k, 50.0, 0.0]), empty, mask)
        # Query at x=39 facing -x: barycenter at x=19 (3 m from the
        # candidate barycenter; pose distance 37 m => far row).
        g.add_scan(np.asarray([39.0, 0.0, np.pi]), fwd, mask)
        idx = g.num_scans - 1
        assert mapper._is_far(idx, 0)
        # Without the cache the radius arm proposes it...
        assert 0 in mapper._loop_candidates(idx, None, None)
        # ...and with a cached clear rejection it must not.
        mapper._reject_cache[mapper._far_key(idx, 0)] = -0.01
        before = mapper.stats.far_rows_cache_skipped
        out = mapper._loop_candidates(idx, None, None)
        assert 0 not in out
        assert mapper.stats.far_rows_cache_skipped > before

    def test_prune_counts_each_row_once_across_restarts(self):
        mapper = make_mapper(loop_closure_max_far_rows=1)
        pending = [(30, [2]), (31, [3])]
        mapper._desc_sim[(30, 2)] = 0.9
        mapper._desc_sim[(31, 3)] = 0.8
        mapper._prune_far_pass(pending)
        first = mapper.stats.far_rows_pruned
        assert first == 1
        # A pass restart re-prunes the same rows: no double count.
        mapper._prune_far_pass(pending)
        assert mapper.stats.far_rows_pruned == first


class TestLoopSearchPositionsPose:
    def test_pose_mode_searches_pose_space(self):
        # Two scans whose BARYCENTERS are far apart but POSES adjacent:
        # positions="pose" must find the candidate, barycenter mode not.
        import dataclasses as _dc

        from ndt_2d_tpu.config import MapperConfig
        for positions, expect in (("barycenter", False), ("pose", True)):
            cfg = MapperConfig(local_scan_matcher=MCFG,
                               global_scan_matcher=MCFG,
                               max_points_per_scan=64,
                               global_search_size=4.0,   # squared: 2 m
                               loop_closure_every=10**9,
                               rolling_depth=2,
                               loop_search_positions=positions)
            mapper = Mapper(cfg)
            mapper.range_max = 30.0
            mapper._ensure_matchers(30.0)
            g = mapper.graph
            pts = np.zeros((64, 2), np.float32)
            pts[:8] = [20.0, 0.0]    # beams 20 m ahead
            mask = np.zeros(64, bool)
            mask[:8] = True
            # Candidate faces +x, query (much later scan) faces -x from
            # nearly the same position: pose distance ~0.5 m, barycenter
            # distance ~40 m.
            g.add_scan(np.asarray([0.0, 0.0, 0.0]), pts, mask)
            for k in range(1, 8):
                g.add_scan(np.asarray([100.0 + k, 50.0, 0.0]), pts, mask)
            g.add_scan(np.asarray([0.5, 0.0, np.pi]), pts, mask)
            idx = g.num_scans - 1
            out = mapper._loop_candidates(idx, None, None)
            assert (0 in out) == expect, (positions, out)
