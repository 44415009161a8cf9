"""chip_smoke.py and bench.py on a machine without a GPU, the smoke's
comparison helpers at small sizes, and the compile-cache helper."""

import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from dj_brdf_tpu import config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, script], capture_output=True,
                          text=True, env=env, cwd=cwd, timeout=300)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_no_gpu_exits_nonzero_without_result(script):
    r = _run(os.path.join(REPO, script), REPO)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert not r.stdout.strip()
    assert "no GPU" in r.stderr


def test_smoke_alone_exits_nonzero(tmp_path):
    """chip_smoke.py in a directory without the package prints no
    result (on a GPU machine it stops at the import instead)."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode != 0 and '"ok": true' not in r.stdout


def test_compile_cache_env_is_honoured(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert config.setup_compile_cache() == str(tmp_path)
    # JAX reads the variable itself: nothing is set in code
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_repo_dir(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        got = config.setup_compile_cache()
        assert got == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == got
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    ignored = subprocess.run(["git", "check-ignore", "-q", ".jax_cache/x"],
                             cwd=REPO)
    if ignored.returncode != 128:   # 128: not a git checkout
        assert ignored.returncode == 0


def test_rel_and_traj_err():
    a = {"x": np.asarray([1.0, -2.0]), "y": np.float64(4.0)}
    b = {"x": np.asarray([1.0, -2.0]), "y": np.float64(4.004)}
    assert chip_smoke.rel_err(a, a) == 0.0
    np.testing.assert_allclose(chip_smoke.rel_err(a, b), 0.004 / 4.004,
                               rtol=1e-5)
    assert chip_smoke.traj_err([1.0, 2.0], [1.0, 2.01], 1e-2, 1e-5) < 1.0
    assert chip_smoke.traj_err([1.0, 2.0], [1.0, 2.5], 1e-2, 1e-5) > 1.0


def test_pixel_mismatch_counts_pixels_not_channels():
    ref = np.ones((4, 4, 3), np.float32)
    img = ref.copy()
    img[0, 0, :] = 2.0           # one pixel off in all channels
    img[1, 1, 2] = 1.0 + 1e-5    # within tolerance
    assert chip_smoke.pixel_mismatch(img, ref, 2e-3, 1e-4) == 1 / 16


def test_params_and_pinned(tmp_path):
    path = tmp_path / "params.txt"
    path.write_text("# MERL Beckmann GGX\nmat-a 0.466 0.137\n")
    got = chip_smoke.parse_params(path)
    assert got == {"mat-a": (0.466, 0.137)}
    from tools.validate_merl_fits import PINNED_RTOL

    pinned = {"mat-a": {"beckmann": 0.4657129645, "ggx": 0.1368172765}}
    assert chip_smoke.pinned_err(got, pinned) < PINNED_RTOL
    with pytest.raises(AssertionError):
        chip_smoke.pinned_err(got, {**pinned, "mat-b": pinned["mat-a"]})


def test_camera_dirs_match_render_sky_corners():
    """The smoke's sky-corner reference: a constant-sky render's
    corner pixels see only the sky, and the camera rays through them
    point above the horizon."""
    from dj_brdf_tpu import fresnel
    from dj_brdf_tpu.microfacet.ndf import GGX
    from dj_brdf_tpu.microfacet.params import MicrofacetParams
    from dj_brdf_tpu.render import materials, pathtrace

    mat = materials.MicrofacetMaterial(
        dist=GGX(), fres=fresnel.Schlick(f0=jnp.full(3, 0.5, jnp.float32)),
        params=MicrofacetParams.isotropic(0.3))
    sky = jnp.asarray([0.3, 0.38, 0.5], jnp.float32)
    img = np.asarray(pathtrace.render(mat, mat, (0.3, 0.4, 0.8),
                                      (3.0, 3.0, 3.0), sky, res=16, spp=2,
                                      max_bounces=2))
    for r, c in ((0, 0), (0, 15)):
        np.testing.assert_allclose(img[r, c], sky, rtol=1e-6)
    d = chip_smoke.camera_dirs(16, [(0, 0), (0, 15), (15, 8)])
    np.testing.assert_allclose(np.linalg.norm(d, axis=-1), 1.0, rtol=1e-6)
    assert (d[:2, 2] > 0).all() and d[2, 2] < 0


def test_db_tables_and_fit_problem_shapes():
    bases = [np.full((3, 90, 90, 180), v, np.float32) for v in (1.0, 3.0)]
    t = chip_smoke.db_tables(4, bases, jax.random.PRNGKey(0))
    assert t.shape == (4, 3, 90, 90, 180)
    t = np.asarray(t)
    assert (t > 0.9).all() and (t < 3.3).all()
    targets, i, o, alphas = chip_smoke.db_fit_problem(3, 64)
    assert targets.shape == (3, 64, 3) and i.shape == (64, 3)
    assert np.isfinite(np.asarray(targets)).all()
    np.testing.assert_allclose(alphas, [0.15, 0.375, 0.6], rtol=1e-6)


def test_phase_check_records_failures(capsys):
    ph = chip_smoke.Phase()
    ph.check("good", 1e-6, 1e-4)
    ph.check("bad", 1e-2, 1e-4)
    ph.check("nan", float("nan"), 1.0)
    ph.require("cond", False, "why")
    assert ph.failed == ["bad", "nan", "cond"]
    out = capsys.readouterr().out
    assert "(tol 1.0e-04) ok" in out and "FAIL" in out


def test_twice_splits_compile_from_steady(capsys):
    """The smoke's timing helper: the cold call's compile seconds come
    from JAX's compile events, the warm calls compile nothing."""
    jax.monitoring.register_event_duration_secs_listener(chip_smoke._on_event)
    try:
        f = jax.jit(lambda x: jnp.sin(x) * 3.0 + 1.0)
        x = jnp.arange(37.0)
        out = chip_smoke.twice(lambda: f(x), "demo", reps=3)
        _, _, comp = chip_smoke.timed(lambda: f(x))
    finally:
        jax.monitoring.unregister_event_duration_listener(chip_smoke._on_event)
    np.testing.assert_allclose(np.asarray(out), np.sin(np.arange(37.0)) * 3.0
                               + 1.0, rtol=1e-6)
    assert comp == 0.0
    line = capsys.readouterr().out
    assert line.startswith("    demo: compile ") and "(median of 3)" in line
    assert float(line.split("compile ")[1].split(" s")[0]) > 0.0


def test_fit_adjoint_timing_routes_agree(monkeypatch):
    """tools/fit_adjoint_timing.py times the same fit step on both
    routes: at a tiny size (kernel in interpret mode) their first-step
    losses and gradients agree and the scanned run is finite."""
    import functools
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "fit_adjoint_timing", os.path.join(REPO, "tools",
                                           "fit_adjoint_timing.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    monkeypatch.setattr(tool, "lsq_value_and_grad_batched",
                        functools.partial(tool.lsq_value_and_grad_batched,
                                          interpret=True))
    for family, m in (("ggx", 1), ("beck", 3)):
        data = tool.make_data(family, m, 700)
        got = {}
        for route in ("xla", "kernel"):
            first, run, raw, st = tool.make_run(route, family, m, 700, 2)
            got[route] = first(raw, *data)
            losses = run(raw, st, *data)[2]
            assert losses.shape == (2, m)
            assert np.isfinite(np.asarray(losses)).all()
        np.testing.assert_allclose(np.asarray(got["kernel"][0]),
                                   np.asarray(got["xla"][0]), rtol=1e-5)
        np.testing.assert_allclose(np.asarray(got["kernel"][1]),
                                   np.asarray(got["xla"][1]),
                                   rtol=5e-4, atol=1e-6)
