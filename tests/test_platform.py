"""Device placement, precision and process hygiene for the GPU build.

CPU checks of what the card relies on: the compile cache goes where
JAX_COMPILATION_CACHE_DIR says and starts no backend, client commands never
open the device, descriptor and blur products run at full f32 precision
(TF32 would move similarity scores), distributed processes each take one
card, and chip_smoke.py refuses to report success without a GPU.
"""

import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ndt_2d_tpu.utils import jax_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _python(code: str, env_extra=None, drop=(), timeout=120):
    env = dict(os.environ)
    for k in drop:
        env.pop(k, None)
    env.update(env_extra or {})
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=timeout)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


_CACHE_PROBE = """
import json, jax
from jax._src import xla_bridge
from ndt_2d_tpu.utils import jax_cache
d = jax_cache.enable_compilation_cache()
print(json.dumps({"dir": d, "config": jax.config.jax_compilation_cache_dir,
                  "backends": list(xla_bridge._backends)}))
"""


class TestCompilationCache:
    @pytest.mark.parametrize("case", ["env_dir", "default_dir", "cpu_only"])
    def test_cache_location_and_no_backend(self, case, tmp_path):
        drop = ["JAX_COMPILATION_CACHE_DIR"]
        env = {"JAX_PLATFORMS": "cuda,cpu"}
        if case == "env_dir":
            env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "xla")
            drop = []
        elif case == "cpu_only":
            env["JAX_PLATFORMS"] = "cpu"
        got = _python(_CACHE_PROBE, env, drop)
        assert got["backends"] == [], "enabling the cache started a backend"
        if case == "env_dir":
            assert got["dir"] == got["config"] == str(tmp_path / "xla")
            assert os.path.isdir(tmp_path / "xla")
        elif case == "default_dir":
            want = os.path.join(REPO, ".jax_cache")
            assert jax_cache.DEFAULT_DIR == want
            assert got["dir"] == got["config"] == want
        else:
            assert got["dir"] == "" and got["config"] is None


_CLIENT_PROBE = """
import json, os, sys
from jax._src import xla_bridge
from ndt_2d_tpu import cli
from ndt_2d_tpu.graph.pose_graph import Graph
from ndt_2d_tpu.io import bag as bag_mod, serialization
tmp = sys.argv[1]
serialization.save_graph(Graph(512, True), os.path.join(tmp, "map.npz"))
bag_mod.save_bag(bag_mod.record_synthetic("box", 3, n_beams=60),
                 os.path.join(tmp, "bag.npz"))
sock = os.path.join(tmp, "absent.sock")
argv = {"info": ["info", "--map", os.path.join(tmp, "map.npz")],
        "feed": ["feed", "--bag", os.path.join(tmp, "bag.npz"),
                 "--socket", sock],
        "save-map": ["save-map", "--socket", sock, "--filename",
                     os.path.join(tmp, "out.npz")]}[sys.argv[2]]
try:
    rc = cli.main(argv)
except OSError as e:   # no server on the socket
    rc = type(e).__name__
print(json.dumps({"rc": rc, "backends": list(xla_bridge._backends)}))
"""


class TestClientCommandsStayOffDevice:
    @pytest.mark.parametrize("cmd", ["feed", "info", "save-map"])
    def test_client_command_starts_no_backend(self, cmd, tmp_path):
        env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
                   + os.environ.get("PYTHONPATH", ""),
                   JAX_PLATFORMS="cuda,cpu")
        out = subprocess.run(
            [sys.executable, "-c", _CLIENT_PROBE, str(tmp_path), cmd],
            capture_output=True, text=True, env=env, cwd=REPO, timeout=120)
        assert out.returncode == 0, out.stderr[-3000:]
        got = json.loads(out.stdout.strip().splitlines()[-1])
        assert got["backends"] == [], f"{cmd} started a JAX backend"
        if cmd == "info":
            assert got["rc"] == 0


def _contractions(jaxpr):
    """Every dot_general / conv_general_dilated in a jaxpr, sub-jaxprs
    (jit, shard_map, vmap bodies) included."""
    found = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name in ("dot_general", "conv_general_dilated"):
            found.append(eqn)
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    found += _contractions(inner)
    return found


def _is_highest(precision) -> bool:
    ps = precision if isinstance(precision, tuple) else (precision,)
    return bool(ps) and all(p == jax.lax.Precision.HIGHEST for p in ps)


def _precision_cases():
    from ndt_2d_tpu.config import ScanMatcherConfig
    from ndt_2d_tpu.matching import correlative
    from ndt_2d_tpu.parallel import loop_search
    from ndt_2d_tpu.parallel.mesh import make_mesh

    rng = np.random.default_rng(0)
    pts = jnp.asarray(rng.uniform(-5, 5, (8, 64, 2)), jnp.float32)
    msk = jnp.ones((8, 64), bool)
    desc = jnp.asarray(rng.normal(size=(8, 192)), jnp.float32)
    valid = jnp.ones(8, bool)
    cfg = ScanMatcherConfig(grid_cells_x=32, grid_cells_y=32)
    return {
        "descriptors": lambda: loop_search.descriptors(pts, msk, 10.0),
        "search_dense": lambda: loop_search.search_dense(
            desc, valid, 7, k=2, rolling_exclude=1),
        "search_all_pairs": lambda: loop_search.search_all_pairs(
            desc, valid, k=2, rolling_exclude=1),
        "search_all_pairs_multichip": lambda:
            loop_search.search_all_pairs_multichip(
                make_mesh(4), desc, valid, k=2, rolling_exclude=1),
        "merge_similarity": lambda: loop_search.cross_similarity(desc, desc),
        "correlative_blur": lambda: correlative.build_field(
            cfg, jnp.zeros((8, 3)), pts, msk, valid, 10.0),
    }


class TestFullPrecisionProducts:
    @pytest.mark.parametrize("name", [
        "descriptors", "search_dense", "search_all_pairs",
        "search_all_pairs_multichip", "merge_similarity",
        "correlative_blur"])
    def test_contractions_are_highest_precision(self, name):
        jaxpr = jax.make_jaxpr(_precision_cases()[name])().jaxpr
        ops = _contractions(jaxpr)
        assert ops, f"{name}: no matrix product or convolution traced"
        loose = [str(e.params.get("precision")) for e in ops
                 if not _is_highest(e.params.get("precision"))]
        assert not loose, f"{name}: products below HIGHEST: {loose}"


class TestDistributedDevicePlacement:
    @pytest.mark.parametrize("platforms,want", [
        ("cuda,cpu", [2]), (None, [2]), ("cpu", None)])
    def test_one_card_per_process(self, platforms, want, monkeypatch):
        from ndt_2d_tpu.parallel import distributed
        calls = []
        monkeypatch.setattr(jax.distributed, "initialize",
                            lambda **kw: calls.append(kw))
        flags = "--xla_force_host_platform_device_count=8"
        monkeypatch.setenv("XLA_FLAGS", flags)
        old = jax.config.jax_platforms
        jax.config.update("jax_platforms", platforms)
        try:
            distributed.initialize("localhost:1234", 4, 2)
        finally:
            jax.config.update("jax_platforms", old)
        assert calls == [dict(coordinator_address="localhost:1234",
                              num_processes=4, process_id=2,
                              local_device_ids=want)]
        # GPU processes get the two XLA flags; other flags are kept.
        assert os.environ["XLA_FLAGS"] == flags + (
            "" if want is None else " --xla_gpu_shard_autotuning=false"
            " --xla_gpu_deterministic_ops=true")

    @pytest.mark.parametrize("given", [
        "--xla_gpu_deterministic_ops=false",
        "--xla_gpu_shard_autotuning=true"])
    def test_gpu_flags_left_to_the_caller(self, given, monkeypatch):
        from ndt_2d_tpu.parallel import distributed
        monkeypatch.setattr(jax.distributed, "initialize", lambda **kw: None)
        monkeypatch.setenv("XLA_FLAGS", given)
        old = jax.config.jax_platforms
        jax.config.update("jax_platforms", "cuda,cpu")
        try:
            distributed.initialize("localhost:1234", 4, 0)
        finally:
            jax.config.update("jax_platforms", old)
        flags = os.environ["XLA_FLAGS"].split()
        assert flags[0] == given and len(flags) == 2
        assert {f.split("=")[0] for f in flags} == {
            "--xla_gpu_deterministic_ops", "--xla_gpu_shard_autotuning"}


class TestChipSmokeNeedsAGpu:
    @pytest.mark.parametrize("where", ["checkout", "alone"])
    def test_fails_without_gpu(self, where, tmp_path):
        script = os.path.join(REPO, "chip_smoke.py")
        if where == "alone":
            shutil.copy(script, tmp_path / "chip_smoke.py")
            script = str(tmp_path / "chip_smoke.py")
        # No nvidia-smi on PATH: the device phase must fail, not fall back.
        env = dict(os.environ, PATH=os.path.dirname(sys.executable))
        out = subprocess.run([sys.executable, script], capture_output=True,
                             text=True, env=env, cwd=tmp_path, timeout=120)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout


def _bench_window():
    """bench.py's headline match: a 10-scan window of 512-point scans in a
    box world, and a query scan with its start pose."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import bench
    return bench.make_fixture(15.0)


@pytest.mark.gpu
class TestOnCard:
    def test_window_match_on_gpu_agrees_with_cpp(self, gpu):
        """The scoring program on the card, on a grid built on the CPU
        backend (the GPU's float scatter sums in an order that changes
        from run to run, which moves a build's covariances), against the
        float64 C++ matcher."""
        from ndt_2d_tpu.config import ScanMatcherConfig
        from ndt_2d_tpu.io import native
        from ndt_2d_tpu.matching import matcher

        cfg = ScanMatcherConfig(grid_cells_x=160, grid_cells_y=160)
        poses, wpts, wmask, qpts, qmask, n, pose = _bench_window()
        cpu = jax.devices("cpu")[0]
        grid = matcher.build_window_ndt(
            cfg, *jax.device_put((poses, wpts, wmask), cpu),
            jnp.ones(10, bool), jnp.float32(15.0))
        grid, q, qm, p = jax.device_put((grid, qpts, qmask, pose), gpu)
        res = matcher.match_scan(cfg, grid, q, qm, jnp.int32(n), p,
                                 jnp.float32(15.0))
        assert res.score.devices() == {gpu}
        score, corr, _ = native.match_baseline(
            poses, wpts, wmask, qpts, qmask, n, pose, 15.0, cfg)
        assert float(res.score) == pytest.approx(score, rel=4e-3)
        np.testing.assert_allclose(corr, np.asarray(res.correction),
                                   atol=1e-6)
