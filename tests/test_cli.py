"""CLI tool tests: run each tool as a subprocess on synthetic data
(the user-facing equivalents of the reference's examples/, tests/ and
utils/ programs)."""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax.numpy as jnp

from dj_brdf_tpu import fresnel
from dj_brdf_tpu.fit import tabular
from dj_brdf_tpu.io import synth
from dj_brdf_tpu.io.merl_io import save_merl
from dj_brdf_tpu.io.utia_io import save_utia
from dj_brdf_tpu.microfacet import brdf as mf
from dj_brdf_tpu.microfacet.ndf import GGX
from dj_brdf_tpu.microfacet.params import MicrofacetParams

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_cli(module, *args):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, "-m", module, *map(str, args)],
                          capture_output=True, text=True, env=env, cwd=REPO)


@pytest.fixture(scope="module")
def merl_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cli") / "testmat.binary")
    eval_fn = tabular.microfacet_eval_fn(
        GGX(), fresnel.Schlick(f0=jnp.asarray([0.9, 0.6, 0.3], jnp.float32)),
        MicrofacetParams.isotropic(0.3))
    save_merl(path, synth.bake_merl(eval_fn))
    return path


def test_merl_params_cli(merl_file, tmp_path):
    out = str(tmp_path / "params.txt")
    r = run_cli("dj_brdf_tpu.cli.merl_params", merl_file, "-o", out)
    assert r.returncode == 0, r.stderr
    lines = open(out).read().splitlines()
    assert lines[0].startswith("#")
    name, beck, ggx_a = lines[1].split()
    assert name == "testmat"
    assert 0.2 < float(ggx_a) < 0.6
    assert float(beck) > 0


def test_plot_cdf_cli(tmp_path):
    r = run_cli("dj_brdf_tpu.cli.plot_cdf", "--res", 64, "--outdir",
                str(tmp_path))
    assert r.returncode == 0, r.stderr
    for f in ["eval_cdf_beckmann.txt", "eval_cdf_beckmann_tab.txt",
              "eval_cdf_ggx.txt", "eval_cdf_ggx_tab.txt"]:
        rows = np.loadtxt(tmp_path / f)
        assert rows.shape[0] == 89
        # cdf monotone in [0, 1]
        assert (np.diff(rows[:, 1]) >= -1e-6).all()
        assert rows[:, 1].max() <= 1.0 + 1e-5
    # analytic and tabulated curves agree (the pipeline has a known
    # small bias — the same one the C++ oracle shows — so this is a
    # curve-overlap check, not exact parity)
    a = np.loadtxt(tmp_path / "eval_cdf_ggx.txt")[:, 1]
    b = np.loadtxt(tmp_path / "eval_cdf_ggx_tab.txt")[:, 1]
    assert np.abs(a - b).max() < 0.1
    assert np.median(np.abs(a - b)) < 0.06


def test_nrm_utia_cli(tmp_path):
    # an energy-conserving synthetic UTIA: scaled lambert
    from dj_brdf_tpu.models.lambert import Lambert
    lam = Lambert(reflectance=jnp.asarray([0.7, 0.7, 0.7], jnp.float32))
    good = str(tmp_path / "good.bin")
    save_utia(good, synth.bake_utia(lam.eval))
    r = run_cli("dj_brdf_tpu.cli.nrm_utia", good, "--ntheta", 8, "--nphi", 16)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "ok" in r.stdout

    # a violating one
    hot = Lambert(reflectance=jnp.asarray([3.0, 3.0, 3.0], jnp.float32))
    bad = str(tmp_path / "bad.bin")
    save_utia(bad, synth.bake_utia(hot.eval))
    r = run_cli("dj_brdf_tpu.cli.nrm_utia", bad, "--ntheta", 8, "--nphi", 16)
    assert r.returncode == 1
    assert "FAILURE" in r.stdout


def test_dmap_nmap_lean_cli(tmp_path):
    from PIL import Image
    h = w = 32
    y, x = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    dmap = (127.5 + 127.5 * np.sin(2 * np.pi * x / w)).astype(np.uint8)
    dpath = str(tmp_path / "dmap.png")
    Image.fromarray(dmap, "L").save(dpath)

    npath = str(tmp_path / "nmap.png")
    r = run_cli("dj_brdf_tpu.cli.dmap2nmap", dpath, "--scale", 0.05,
                "-o", npath)
    assert r.returncode == 0, r.stderr
    nmap = np.asarray(Image.open(npath))
    assert nmap.shape == (h, w, 3)
    assert nmap[..., 2].min() > 100  # z mostly up

    out1 = str(tmp_path / "lean1.npy")
    out2 = str(tmp_path / "lean2.npy")
    r = run_cli("dj_brdf_tpu.cli.nmap2leanmap", npath,
                "--base-roughness", 0.1, "--out1", out1, "--out2", out2)
    assert r.returncode == 0, r.stderr
    l1 = np.load(out1)
    l2 = np.load(out2)
    assert l1.shape == (h, w, 4) and l2.shape == (h, w, 4)
    # E3 >= E1^2 (variance non-negative w/ base roughness)
    assert (l2[..., 0] - l1[..., 0] ** 2 > 0).all()


def test_render_cli(tmp_path, merl_file):
    out = str(tmp_path / "r.png")
    r = run_cli("dj_brdf_tpu.cli.render", "--model", "ggx",
                "--alpha1", 0.3, "--alpha2", 0.1, "--res", 64, "-o", out)
    assert r.returncode == 0, r.stderr
    from PIL import Image
    img = np.asarray(Image.open(out))
    assert img.shape == (64, 64, 3)
    assert img.max() > 30

    r = run_cli("dj_brdf_tpu.cli.render", "--model", "merl", "--file",
                merl_file, "--res", 48, "-o", out)
    assert r.returncode == 0, r.stderr

    r = run_cli("dj_brdf_tpu.cli.render", "--model", "sgd", "--material",
                "chrome", "--res", 48, "-o", out)
    assert r.returncode == 0, r.stderr


def test_render_cli_tab_and_fit(tmp_path, merl_file):
    out = str(tmp_path / "r.png")
    # distribution="tabular" path (dj_brdf.cpp:208-233)
    r = run_cli("dj_brdf_tpu.cli.render", "--model", "merl_tab", "--file",
                merl_file, "--fit-res", 32, "--res", 48, "-o", out)
    assert r.returncode == 0, r.stderr
    from PIL import Image
    img = np.asarray(Image.open(out))
    assert img.shape == (48, 48, 3) and img.max() > 10

    # UTIA anisotropic fit path (dj_brdf.cpp:234-259)
    from dj_brdf_tpu.models.lambert import Lambert
    lam = Lambert(reflectance=jnp.asarray([0.6, 0.6, 0.6], jnp.float32))
    upath = str(tmp_path / "u.bin")
    save_utia(upath, synth.bake_utia(lam.eval))
    r = run_cli("dj_brdf_tpu.cli.render", "--model", "utia_fit", "--file",
                upath, "--fit-res", 8, "--res", 32, "-o", out)
    assert r.returncode == 0, r.stderr

    # conductor Fresnel on top (dj_brdf.cpp:366)
    r = run_cli("dj_brdf_tpu.cli.render", "--model", "ggx", "--alpha1", 0.2,
                "--conductor", "--res", 32, "-o", out)
    assert r.returncode == 0, r.stderr


def test_render_cli_lean(tmp_path):
    # build lean maps from a procedural normal map, then shade with them
    from PIL import Image
    h = w = 32
    y, x = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    dmap = (127.5 + 127.5 * np.sin(2 * np.pi * x / w)).astype(np.uint8)
    dpath = str(tmp_path / "d.png")
    Image.fromarray(dmap, "L").save(dpath)
    npath = str(tmp_path / "n.png")
    assert run_cli("dj_brdf_tpu.cli.dmap2nmap", dpath, "--scale", 0.08,
                   "-o", npath).returncode == 0
    l1, l2 = str(tmp_path / "l1.npy"), str(tmp_path / "l2.npy")
    assert run_cli("dj_brdf_tpu.cli.nmap2leanmap", npath,
                   "--base-roughness", 0.15, "--out1", l1,
                   "--out2", l2).returncode == 0

    out = str(tmp_path / "lean.png")
    r = run_cli("dj_brdf_tpu.cli.render", "--model", "lean",
                "--leanmap1", l1, "--leanmap2", l2, "--alpha1", 0.1,
                "--mip", 1, "--res", 32, "-o", out)
    assert r.returncode == 0, r.stderr
    img = np.asarray(Image.open(out))
    assert img.shape == (32, 32, 3) and img.max() > 10


def test_render_cli_textured_roughness(tmp_path, merl_file):
    """Textured alpha1/alpha2/alphaAngle front-end
    (mitsuba/dj_brdf.cpp:166-288, 353-357)."""
    from PIL import Image
    out = str(tmp_path / "t.png")
    h = w = 16
    y, x = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    a1 = (0.05 + 0.5 * ((x + y) % 2)).astype(np.float32)    # checker
    ang = (np.pi / 4 * (x % 2)).astype(np.float32)
    a1p, angp = str(tmp_path / "a1.npy"), str(tmp_path / "ang.npy")
    np.save(a1p, a1)
    np.save(angp, ang)

    r = run_cli("dj_brdf_tpu.cli.render", "--model", "ggx",
                "--alpha1-map", a1p, "--alpha-angle-map", angp,
                "--alpha2", 0.1, "--res", 64, "-o", out)
    assert r.returncode == 0, r.stderr
    img = np.asarray(Image.open(out)).astype(np.float32)
    assert img.shape == (64, 64, 3) and img.max() > 10
    # the checker must show: rough vs smooth texels shade differently
    r2 = run_cli("dj_brdf_tpu.cli.render", "--model", "ggx",
                 "--alpha1", 0.05, "--alpha2", 0.1, "--res", 64, "-o", out)
    assert r2.returncode == 0, r2.stderr
    img_u = np.asarray(Image.open(out)).astype(np.float32)
    assert np.abs(img - img_u).max() > 8.0

    # textured roughness modulating a tabulated NDF (baseRoughness = 1)
    r = run_cli("dj_brdf_tpu.cli.render", "--model", "merl_tab", "--file",
                merl_file, "--fit-res", 24, "--alpha1-map", a1p,
                "--res", 48, "-o", out)
    assert r.returncode == 0, r.stderr

    # ...and the same textured tabular under the PATH TRACER (the
    # dj_brdf plugin's distribution="tabular" textures work inside any
    # integrator; here via UVMappedMaterial + the generic loop)
    outn = str(tmp_path / "t_pt.npy")
    r = run_cli("dj_brdf_tpu.cli.render", "--model", "merl_tab", "--file",
                merl_file, "--fit-res", 16, "--alpha1-map", a1p,
                "--pathtrace", "--res", 16, "--spp", 2, "--bounces", 2,
                "-o", outn)
    assert r.returncode == 0, r.stderr
    img_pt = np.load(outn)
    assert img_pt.shape == (16, 16, 3) and np.isfinite(img_pt).all()


def test_render_cli_utia_tab(tmp_path):
    """distribution="tabular" over UTIA: render + sample the extracted
    anisotropic table itself (mitsuba/dj_brdf.cpp:234-259)."""
    from PIL import Image
    from dj_brdf_tpu.models.lambert import Lambert
    lam = Lambert(reflectance=jnp.asarray([0.6, 0.6, 0.6], jnp.float32))
    upath = str(tmp_path / "u.bin")
    save_utia(upath, synth.bake_utia(lam.eval))
    out = str(tmp_path / "ut.png")
    r = run_cli("dj_brdf_tpu.cli.render", "--model", "utia_tab", "--file",
                upath, "--fit-res", 8, "--res", 32, "-o", out)
    assert r.returncode == 0, r.stderr
    img = np.asarray(Image.open(out))
    assert img.shape == (32, 32, 3) and img.max() > 5

    # multi-bounce path trace samples the aniso table's nmap sampler
    r = run_cli("dj_brdf_tpu.cli.render", "--model", "utia_tab", "--file",
                upath, "--fit-res", 8, "--res", 24, "--pathtrace",
                "--spp", 2, "--bounces", 2, "-o", out)
    assert r.returncode == 0, r.stderr


def test_render_cli_npy_output(tmp_path):
    """--output *.npy writes the raw HDR radiance array."""
    import numpy as np

    out = str(tmp_path / "img.npy")
    r = run_cli("dj_brdf_tpu.cli.render", "--model", "ggx",
                "--alpha1", "0.3", "--alpha2", "0.15",
                "--res", "16", "-o", out)
    assert r.returncode == 0, r.stderr
    assert "wrote" in r.stdout
    a = np.load(out)
    assert a.shape == (16, 16, 3)
    assert np.isfinite(a).all() and a.max() > 0


def test_validate_merl_fits_tool(merl_file, tmp_path):
    """tools/validate_merl_fits.py (the real-data validation recipe,
    reference README:20-22): given a directory of MERL binaries it must
    fit them, agree with the C++ oracle when present, and exit 0."""
    import tests.oracle as orc

    data_dir = os.path.dirname(merl_file)
    args = [sys.executable, os.path.join(REPO, "tools",
                                         "validate_merl_fits.py"),
            "--data", data_dir, "--res", "32"]
    if not orc.available():
        args.append("--no-oracle")
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run(args, capture_output=True, text=True, env=env,
                       cwd=REPO)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "testmat" in r.stdout
    if orc.available():
        assert "oracle" in r.stdout and "MISMATCH" not in r.stdout


def test_render_cli_matpreview_composition(tmp_path):
    """The matpreview done-criterion: ONE CLI command renders a
    matpreview-style scene — textured-alpha GGX sphere + LEAN-mapped
    Beckmann-conductor floor + .hdr envmap MIS lighting + rotation —
    all composed under --pathtrace."""
    from dj_brdf_tpu.io.hdr import write_hdr
    rng = np.random.default_rng(0)

    # probe .hdr with a bright sun patch
    env = np.abs(rng.normal(1.0, 0.4, (16, 32, 3))).astype(np.float32)
    env[4:6, 8:11] *= 50.0
    envp = str(tmp_path / "probe.hdr")
    write_hdr(envp, env)

    # sphere roughness texture
    a1p = str(tmp_path / "a1.npy")
    np.save(a1p, rng.uniform(0.05, 0.6, (12, 12)).astype(np.float32))

    # floor LEAN maps (E1,E2) / (E3,E4,E5)
    e1 = rng.normal(0, 0.2, (8, 8)).astype(np.float32)
    e2 = rng.normal(0, 0.2, (8, 8)).astype(np.float32)
    l1 = np.stack([e1, e2], -1)
    l2 = np.stack([e1 * e1 + 0.02, e2 * e2 + 0.02, e1 * e2], -1)
    l1p, l2p = str(tmp_path / "l1.npy"), str(tmp_path / "l2.npy")
    np.save(l1p, l1)
    np.save(l2p, l2)

    out = str(tmp_path / "matpreview.npy")
    r = run_cli("dj_brdf_tpu.cli.render", "--model", "ggx",
                "--alpha1-map", a1p, "--alpha2", 0.2,
                "--pathtrace", "--envmap", envp, "--envmap-rot-z", 45,
                "--floor-model", "lean", "--floor-leanmap1", l1p,
                "--floor-leanmap2", l2p, "--floor-alpha", 0.1,
                "--lean-lod",
                "--res", 24, "--spp", 2, "--bounces", 2, "-o", out)
    assert r.returncode == 0, r.stderr
    img = np.load(out)
    assert img.shape == (24, 24, 3) and np.isfinite(img).all()
    assert img.mean() > 0.01


def test_render_cli_envmap(tmp_path):
    rng = np.random.default_rng(0)
    env = np.abs(rng.normal(1.0, 0.4, (8, 16, 3))).astype(np.float32)
    envp = str(tmp_path / "env.npy")
    np.save(envp, env)
    out = str(tmp_path / "env_render.npy")
    r = run_cli("dj_brdf_tpu.cli.render", "--model", "ggx",
                "--alpha1", 0.3, "--pathtrace", "--envmap", envp,
                "--res", 24, "--spp", 2, "--bounces", 2, "-o", out)
    assert r.returncode == 0, r.stderr
    img = np.load(out)
    assert img.shape == (24, 24, 3) and np.isfinite(img).all()
    assert img.mean() > 0.01
