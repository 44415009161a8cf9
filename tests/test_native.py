"""Native djbio library: parity with the numpy/jnp fallbacks."""

import numpy as np
import pytest
import jax.numpy as jnp

from dj_brdf_tpu.io import native
from dj_brdf_tpu.io.merl_io import load_merl, save_merl
from dj_brdf_tpu.io.utia_io import load_utia, save_utia
from dj_brdf_tpu.lean import maps

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="no native toolchain")


def test_native_merl_parser_matches_numpy(tmp_path, rng):
    table = rng.uniform(0, 2, (3, 90, 90, 180))
    path = str(tmp_path / "t.binary")
    save_merl(path, table)
    a = native.load_merl(path)
    b = load_merl(path, use_native=False)
    np.testing.assert_array_equal(a, b)


def test_builds_serially_without_openmp_link(tmp_path, rng):
    """A toolchain that cannot link OpenMP (a GCC without libgomp's
    spec file) still builds the library, serially, and it parses MERL
    files like the numpy loader."""
    import ctypes
    import os
    import shutil
    import subprocess

    for f in ("Makefile", "djbio.cpp"):
        shutil.copy(os.path.join(os.path.dirname(native._SO), f), tmp_path)
    cxx = tmp_path / "cxx"
    cxx.write_text('#!/bin/sh\nfor a in "$@"; do\n'
                   '  [ "$a" = -fopenmp ] && exit 1\ndone\n'
                   'exec g++ "$@"\n')
    cxx.chmod(0o755)
    subprocess.run(["make", "-C", str(tmp_path), f"CXX={cxx}"], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(tmp_path / "libdjbio.so"))
    lib.djbio_load_merl.argtypes = [
        ctypes.c_char_p,
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")]
    path = str(tmp_path / "t.binary")
    save_merl(path, rng.uniform(0, 2, (3, 90, 90, 180)))
    out = np.empty(3 * 90 * 90 * 180, np.float32)
    assert lib.djbio_load_merl(path.encode(), out) == 0
    np.testing.assert_array_equal(out.reshape(3, 90, 90, 180),
                                  load_merl(path, use_native=False))


def test_native_utia_parser_matches_numpy(tmp_path, rng):
    table = rng.uniform(-0.5, 3, (3, 6, 48, 6, 48))
    path = str(tmp_path / "u.bin")
    save_utia(path, table)
    a = native.load_utia(path)
    b = load_utia(path, use_native=False)
    np.testing.assert_allclose(a, b, rtol=1e-6)
    assert a.min() >= 0.0  # clamp applied


def test_native_dmap_nmap_matches_jnp(rng):
    dmap = rng.uniform(0, 1, (64, 64)).astype(np.float32)
    a = native.dmap_to_nmap(dmap, scale=0.05)
    b = np.asarray(maps.dmap_to_nmap(jnp.asarray(dmap), scale=0.05))
    np.testing.assert_allclose(a, b, atol=1e-6)
    a = native.dmap_to_nmap(dmap, scale=0.05, clamp_to_border=True)
    b = np.asarray(maps.dmap_to_nmap(jnp.asarray(dmap), scale=0.05,
                                     clamp_to_border=True))
    np.testing.assert_allclose(a, b, atol=1e-6)


def test_native_lean_matches_jnp(rng):
    dmap = rng.uniform(0, 1, (32, 32)).astype(np.float32)
    nmap = native.dmap_to_nmap(dmap, scale=0.1)
    a = native.nmap_to_lean(nmap, base_roughness=0.05, bias=25.0)
    lean = maps.nmap_to_lean(jnp.asarray(nmap), base_roughness=0.05,
                             bias=25.0)
    for k, plane in enumerate([lean.E1, lean.E2, lean.E3, lean.E4, lean.E5]):
        np.testing.assert_allclose(a[k], np.asarray(plane), rtol=1e-5,
                                   atol=1e-5)

    red = native.lean_mip_reduce(a)
    want = maps.mip_reduce(lean)
    for k, plane in enumerate([want.E1, want.E2, want.E3, want.E4, want.E5]):
        np.testing.assert_allclose(red[k], np.asarray(plane), rtol=1e-5,
                                   atol=1e-5)
