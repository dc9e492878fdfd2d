"""Entry-point set-up: compile cache, GPU requirement, seeded missions."""

import os

import jax
import numpy as np
import pytest

from lsc_dr_planner_tpu import runtime


@pytest.fixture
def cache_config():
    """Restore JAX's compile-cache setting after a test changes it."""
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_follows_env(monkeypatch, tmp_path, cache_config):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert runtime.setup_compile_cache() == str(tmp_path)
    # JAX reads the variable itself; nothing else is set in code
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_repo(monkeypatch, cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = runtime.setup_compile_cache()
    assert got == os.path.join(runtime.REPO_ROOT, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == got


def test_require_gpu_fails_on_cpu():
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(SystemExit) as e:
        runtime.require_gpu()
    assert e.value.code not in (0, None)


def test_device_info_reports_jax_view():
    info = runtime.device_info()
    assert info == {"platform": "cpu", "kind": jax.devices()[0].device_kind,
                    "count": len(jax.devices())}


@pytest.mark.parametrize("entry", ["sim_run", "bench"])
def test_gpu_entry_points_refuse_cpu(entry, monkeypatch, tmp_path):
    """`sim/run.py --platform gpu` (the default) and `bench.py` exit
    non-zero on a host without a GPU instead of falling back."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    with pytest.raises(SystemExit) as e:
        if entry == "sim_run":
            from lsc_dr_planner_tpu.sim import run

            run.main(["--platform", "gpu", "--mission", "none.json"])
        else:
            import bench

            bench.main()
    assert e.value.code not in (0, None)
    assert "no GPU" in str(e.value.code)


@pytest.mark.parametrize("kind", ["forest", "maze"])
def test_seeded_missions_are_deterministic(kind):
    from lsc_dr_planner_tpu.mission import make_mission, random_world

    def draw(seed):
        rng = np.random.default_rng(seed)
        for _ in range(20):
            boxes = random_world(rng, kind, 5.0)
            m = make_mission(rng, 6, boxes, 5.0)
            if m is not None:
                return m
        raise AssertionError("no mission drawn")

    a, b, c = draw(3), draw(3), draw(4)
    np.testing.assert_array_equal(a.world_boxes, b.world_boxes)
    for x, y in zip(a.agents, b.agents):
        np.testing.assert_array_equal(x.start, y.start)
        np.testing.assert_array_equal(x.goal, y.goal)
    starts = np.stack([x.start for x in a.agents])
    assert not np.array_equal(starts, np.stack([x.start for x in c.agents]))
    # starts and goals sit on the 0.5 m grid inside the world, 0.7 m apart
    assert np.all(np.abs(starts[:, :2]) <= 5.0 - 0.3)
    np.testing.assert_allclose(starts[:, :2] / 0.5,
                               np.round(starts[:, :2] / 0.5))
    d = np.linalg.norm(starts[:, None, :2] - starts[None, :, :2], axis=-1)
    assert np.all(d[np.triu_indices(len(starts), 1)] >= 0.7)


def test_lattice_forest_mission_matches_bench_fleet():
    from lsc_dr_planner_tpu.mission import lattice_forest, lattice_forest_mission

    A = 20
    starts, goals, boxes, half = lattice_forest(A, seed=1)
    again = lattice_forest(A, seed=1)
    np.testing.assert_array_equal(starts, again[0])
    np.testing.assert_array_equal(boxes, again[2])
    m = lattice_forest_mission(A, seed=1)
    assert m.qn == A
    np.testing.assert_array_equal(m.world_boxes, boxes)
    np.testing.assert_allclose(m.stacked()["start"][:, :2], starts)
    np.testing.assert_allclose(m.stacked()["goal"][:, :2], goals)
    np.testing.assert_allclose(m.world_max[:2], [half, half])
    # columns keep 0.6 m clear of every start and goal
    keep = np.concatenate([starts, goals])
    gap = np.linalg.norm(keep[:, None] - boxes[None, :, :2], axis=-1)
    assert gap.min() > 0.6
