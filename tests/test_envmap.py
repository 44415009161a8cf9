"""Environment-map lighting: importance-sampler statistics, MIS
path-tracer consistency, energy conservation, and inverse-lighting
gradients. (The reference is rendered under Mitsuba envmap emitters —
mitsuba/README's matpreview scene; this is the JAX analogue.)"""

import jax
import jax.numpy as jnp
import numpy as np

from dj_brdf_tpu import fresnel
from dj_brdf_tpu.microfacet.ndf import GGX, Beckmann
from dj_brdf_tpu.microfacet.params import MicrofacetParams
from dj_brdf_tpu.models.lambert import Lambert
from dj_brdf_tpu.render import materials, pathtrace
from dj_brdf_tpu.render.envmap import EnvMap, power_heuristic


def _sun_sky(h=16, w=32, sun=40.0):
    rng = np.random.default_rng(0)
    img = np.abs(rng.normal(1.0, 0.5, (h, w, 3))).astype(np.float32)
    img[3:5, 10:13] *= sun
    return jnp.asarray(img)


def test_sampler_statistics(rng):
    """sample() is exact for its own density: E[L/pdf] reproduces the
    Riemann integral of the map, pdf() agrees with the returned pdf,
    and E[1/pdf] = 4pi for any map."""
    em = EnvMap.build(_sun_sky())
    n = 1 << 18
    u1 = jnp.asarray(rng.uniform(0, 1, n), jnp.float32)
    u2 = jnp.asarray(rng.uniform(0, 1, n), jnp.float32)
    u3 = jnp.asarray(rng.uniform(0, 1, n), jnp.float32)
    dx, dy, dz, pdf = jax.jit(em.sample)(u1, u2, u3)
    pdf = np.asarray(pdf)
    assert np.isfinite(pdf).all() and (pdf > 0).all()
    np.testing.assert_allclose(np.asarray(dx * dx + dy * dy + dz * dz),
                               1.0, atol=1e-5)

    pdf2 = np.asarray(jax.jit(em.pdf)(dx, dy, dz))
    assert (np.abs(pdf2 - pdf) / pdf < 1e-4).mean() > 0.998  # bin edges

    r, g, b = jax.jit(em.eval)(dx, dy, dz)
    est = np.asarray(jnp.stack([r, g, b], -1))
    est = (est / pdf[:, None]).mean(0)
    img = np.asarray(em.radiance)
    h, w = img.shape[:2]
    theta_c = (np.arange(h) + 0.5) * np.pi / h
    riemann = (img * np.sin(theta_c)[:, None, None]).sum((0, 1)) \
        * (np.pi / h) * (2 * np.pi / w)
    np.testing.assert_allclose(est, riemann, rtol=0.03)

    np.testing.assert_allclose(float((1.0 / jnp.asarray(pdf)).mean()),
                               4 * np.pi, rtol=0.03)


def test_power_heuristic_partition():
    a = jnp.asarray([0.0, 1.0, 2.0, 1e-8])
    b = jnp.asarray([1.0, 1.0, 0.5, 1e8])
    s = power_heuristic(a, b) + power_heuristic(b, a)
    np.testing.assert_allclose(np.asarray(s[a + b > 0]), 1.0, atol=1e-6)


def _scene():
    sphere = materials.MicrofacetMaterial(
        dist=GGX(), fres=fresnel.Schlick(f0=jnp.asarray([0.9, 0.6, 0.3])),
        params=MicrofacetParams.elliptic(0.35, 0.2, 0.7))
    floor = materials.CosineMaterial(
        model=Lambert(reflectance=jnp.asarray([0.4, 0.4, 0.4])))
    return sphere, floor


def test_uniform_envmap_matches_constant_sky():
    """A uniform envmap must reproduce the constant-sky render: the
    MIS estimator and the existing BSDF-only sky estimator integrate
    the same transport, so images agree statistically."""
    sphere, floor = _scene()
    sky = jnp.asarray([0.8, 0.7, 0.6], jnp.float32)
    kw = dict(res=32, spp=32, max_bounces=3)
    img_sky = np.asarray(pathtrace.render(
        sphere, floor, jnp.asarray([0.0, 0.0, 1.0]),
        jnp.zeros(3), sky, **kw))
    em = EnvMap.build(jnp.broadcast_to(sky, (16, 32, 3)))
    img_env = np.asarray(pathtrace.render(
        sphere, floor, jnp.asarray([0.0, 0.0, 1.0]),
        jnp.zeros(3), sky, envmap=em, **kw))
    # direct-sky pixels are exact; lit pixels agree to MC noise
    np.testing.assert_allclose(img_env[0, 0], img_sky[0, 0], rtol=1e-3)
    np.testing.assert_allclose(img_env.mean(), img_sky.mean(), rtol=0.02)
    rel = np.abs(img_env - img_sky) / (img_sky + 0.05)
    assert np.median(rel) < 0.05
    assert rel.mean() < 0.12


def test_envmap_furnace_bound():
    """White furnace under a unit uniform envmap: the MIS estimator is
    unbiased, so the IMAGE MEAN cannot exceed the furnace value (the
    per-pixel estimate fluctuates around it — unlike the BSDF-only
    sky path whose per-path weights are deterministically <= 1, NEE
    divides by a binned pdf, so pointwise excursions above 1 are
    expected MC behavior, bounded by the bin discretization)."""
    white = materials.CosineMaterial(
        model=Lambert(reflectance=jnp.asarray([1.0, 1.0, 1.0])))
    em = EnvMap.build(jnp.ones((8, 16, 3), jnp.float32))
    img = pathtrace.render(white, white, jnp.asarray([0.0, 0.0, 1.0]),
                           jnp.zeros(3), jnp.ones(3), envmap=em,
                           res=32, spp=16, max_bounces=4)
    assert float(img.mean()) <= 1.0 + 1e-2
    assert float(img.max()) <= 1.5  # half-bin sin-ratio excursions only
    assert float(jnp.median(img)) > 0.6


def test_envmap_mis_beats_bsdf_only_on_sun():
    """With a small bright sun, the MIS render is far less noisy than
    the same-budget estimate without NEE (here approximated by the
    variance across spp groups): sanity that NEE actually engages."""
    sphere, floor = _scene()
    em = EnvMap.build(_sun_sky(sun=200.0))
    kw = dict(res=24, max_bounces=2)
    img_a = np.asarray(pathtrace.render(
        sphere, floor, jnp.asarray([0.0, 0.0, 1.0]), jnp.zeros(3),
        jnp.zeros(3), envmap=em, key=jax.random.PRNGKey(1), spp=4, **kw))
    img_b = np.asarray(pathtrace.render(
        sphere, floor, jnp.asarray([0.0, 0.0, 1.0]), jnp.zeros(3),
        jnp.zeros(3), envmap=em, key=jax.random.PRNGKey(2), spp=4, **kw))
    assert np.isfinite(img_a).all() and img_a.mean() > 0
    # two independent 4-spp MIS renders of a hard-light (200x sun)
    # scene agree in the mean and reasonably per-pixel — without NEE
    # this scene is firefly-dominated at this budget
    np.testing.assert_allclose(img_a.mean(), img_b.mean(), rtol=0.1)
    lit = img_a.mean(-1) > 0.05
    rel = np.abs(img_a - img_b)[lit] / (img_a[lit] + 0.05)
    assert np.median(rel) < 0.35, np.median(rel)


def test_envmap_gradient_inverse_lighting():
    """Pixel gradients flow to the envmap radiance (and are finite):
    the inverse-lighting capability. ``build`` runs once on the host;
    ``rebind`` swaps in the differentiable radiance under the frozen
    sampler (the detached-sampler estimator)."""
    sphere, floor = _scene()
    em0 = EnvMap.build(jnp.ones((8, 16, 3), jnp.float32))

    def loss(radiance):
        em = em0.rebind(radiance)
        img = pathtrace.render(sphere, floor, jnp.asarray([0.0, 0.0, 1.0]),
                               jnp.zeros(3), jnp.zeros(3), envmap=em,
                               res=16, spp=2, max_bounces=2)
        return img.mean()

    g = jax.grad(loss)(jnp.ones((8, 16, 3), jnp.float32))
    g = np.asarray(g)
    assert np.isfinite(g).all()
    assert np.abs(g).max() > 0


def test_envmap_build_rejects_nonfinite():
    """A NaN texel fails loudly at build (the native builder's mass
    validation must not be swallowed into a silent NaN sampler)."""
    import pytest
    img = np.ones((4, 8, 3), np.float32)
    img[1, 2, 0] = np.nan
    with pytest.raises(ValueError, match="non-finite"):
        EnvMap.build(jnp.asarray(img))


def test_alias_index_bitcast_exact(rng):
    """Alias partner indices ride as int32 BIT PATTERNS in the f32
    row (float values would round above 2^24 bins); the stored bits
    recover the exact index, including denormal-range patterns."""
    img = (rng.uniform(0.01, 1.0, (64, 128, 3)) ** 4).astype(np.float32)
    em = EnvMap.build(jnp.asarray(img))
    got = np.asarray(em.alias[:, 1]).view(np.int32)
    n = 64 * 128
    assert got.min() >= 0 and got.max() < n
    # re-derive the table on the host and compare exactly
    from dj_brdf_tpu.io import native
    lum = np.maximum(img, 0).mean(-1) + 1e-12
    sin_rows = np.sin((np.arange(64) + 0.5) * np.pi / 64)
    mass = lum * sin_rows[:, None]
    _, alias_idx = native.build_alias(mass / mass.sum())
    np.testing.assert_array_equal(got, alias_idx)


def test_envmap_build_rejects_tracer():
    """build inside a trace points the user at rebind."""
    import pytest
    with pytest.raises(TypeError, match="rebind"):
        jax.jit(EnvMap.build)(jnp.ones((4, 8, 3)))


def test_envmap_rebind_identity():
    """rebind with the build radiance reproduces the original map's
    renders exactly (frozen sampler == original sampler)."""
    sphere, floor = _scene()
    img = _sun_sky()
    em = EnvMap.build(img)
    em2 = em.rebind(img)
    kw = dict(res=16, spp=4, max_bounces=2)
    args = (sphere, floor, jnp.asarray([0.0, 0.0, 1.0]),
            jnp.zeros(3), jnp.zeros(3))
    a = np.asarray(pathtrace.render(*args, envmap=em, **kw))
    b = np.asarray(pathtrace.render(*args, envmap=em2, **kw))
    np.testing.assert_array_equal(a, b)


def test_sampler_statistics_production_scale(rng):
    """The alias sampler is exact and memory-light at a production
    1024x2048 map (the old compare-reduce sampler
    materialized (n, H)+(n, W) masks and could not scale)."""
    h, w = 1024, 2048
    img = (rng.uniform(0.1, 1.0, (h, w, 3)) ** 2).astype(np.float32)
    img[100:104, 500:508] *= 500.0   # a small sun
    em = EnvMap.build(jnp.asarray(img))
    n = 1 << 18
    u1 = jnp.asarray(rng.uniform(0, 1, n), jnp.float32)
    u2 = jnp.asarray(rng.uniform(0, 1, n), jnp.float32)
    u3 = jnp.asarray(rng.uniform(0, 1, n), jnp.float32)
    dx, dy, dz, pdf = jax.jit(em.sample)(u1, u2, u3)
    pdf = np.asarray(pdf)
    assert np.isfinite(pdf).all() and (pdf > 0).all()
    np.testing.assert_allclose(np.asarray(dx * dx + dy * dy + dz * dz),
                               1.0, atol=1e-5)
    pdf2 = np.asarray(jax.jit(em.pdf)(dx, dy, dz))
    assert (np.abs(pdf2 - pdf) / pdf < 1e-3).mean() > 0.995  # bin edges

    r, g, b = jax.jit(em.eval)(dx, dy, dz)
    est = np.asarray(jnp.stack([r, g, b], -1))
    est = (est / pdf[:, None]).mean(0)
    theta_c = (np.arange(h) + 0.5) * np.pi / h
    riemann = (img * np.sin(theta_c)[:, None, None]).sum((0, 1)) \
        * (np.pi / h) * (2 * np.pi / w)
    np.testing.assert_allclose(est, riemann, rtol=0.03)


def test_nearest_filter_mode(rng):
    """filter="nearest" (auto-selected for production maps: 16-byte
    packed rows, 2x the HBM gather rate): sampler statistics stay
    exact, eval returns the texel values, rebind preserves the
    layout."""
    img = np.asarray(_sun_sky())
    em_n = EnvMap.build(jnp.asarray(img), filter="nearest")
    em_b = EnvMap.build(jnp.asarray(img), filter="bilinear")
    assert em_n.packed.shape[-1] == 4 and em_b.packed.shape[-1] == 16
    # auto: small maps bilinear, big maps nearest
    assert EnvMap.build(jnp.asarray(img)).packed.shape[-1] == 16
    big = jnp.ones((512, 1024, 3), jnp.float32)
    assert EnvMap.build(big).packed.shape[-1] == 4

    n = 1 << 16
    u = [jnp.asarray(rng.uniform(0, 1, n), jnp.float32) for _ in range(3)]
    dx, dy, dz, pdf = jax.jit(em_n.sample)(*u)
    # same draws as bilinear mode (the sampler is filter-independent)
    dxb, dyb, dzb, pdfb = jax.jit(em_b.sample)(*u)
    np.testing.assert_array_equal(np.asarray(dx), np.asarray(dxb))
    np.testing.assert_array_equal(np.asarray(pdf), np.asarray(pdfb))

    # E[L/pdf] with nearest eval == the Riemann sum exactly in
    # expectation (texel value x exact bin density)
    r, g, b = jax.jit(em_n.eval)(dx, dy, dz)
    est = (np.stack([np.asarray(r), np.asarray(g), np.asarray(b)], -1)
           / np.asarray(pdf)[:, None]).mean(0)
    h, w = img.shape[:2]
    theta_c = (np.arange(h) + 0.5) * np.pi / h
    riemann = (img * np.sin(theta_c)[:, None, None]).sum((0, 1)) \
        * (np.pi / h) * (2 * np.pi / w)
    np.testing.assert_allclose(est, riemann, rtol=0.03)

    # renders agree statistically with the bilinear-mode map
    sphere, floor = _scene()
    kw = dict(res=24, spp=8, max_bounces=2)
    args = (sphere, floor, jnp.asarray([0.0, 0.0, 1.0]),
            jnp.zeros(3), jnp.zeros(3))
    a = np.asarray(pathtrace.render(*args, envmap=em_n, **kw))
    bimg = np.asarray(pathtrace.render(*args, envmap=em_b, **kw))
    np.testing.assert_allclose(a.mean(), bimg.mean(), rtol=0.05)

    # rebind keeps the nearest layout + gradients flow
    em2 = em_n.rebind(jnp.asarray(img) * 2.0)
    assert em2.packed.shape[-1] == 4
    g = jax.grad(lambda rad: sum(
        jnp.sum(x) for x in em_n.rebind(rad).eval(dx, dy, dz)))(
            jnp.asarray(img))
    assert np.isfinite(np.asarray(g)).all() and np.abs(np.asarray(g)).max() > 0


def test_envmap_rotation_matches_rolled_map(rng):
    """Rotating the emitter about +z by k column widths equals rolling
    the map k columns (the reference scenes orient their emitters via
    toWorld transforms, mitsuba/README): radiance/pdf queries agree
    exactly at every direction, and sampling commutes with the
    rotation (same u -> rotated direction, same pdf)."""
    img = np.asarray(_sun_sky())
    h, w = img.shape[:2]
    k = 7
    ang = k * 2.0 * np.pi / w
    em0 = EnvMap.build(jnp.asarray(img))
    em_rot = EnvMap.build(jnp.asarray(img), rotation=EnvMap.rotation_z(ang))
    em_rolled = EnvMap.build(jnp.asarray(np.roll(img, k, axis=1)))

    n = 4096
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    dx, dy, dz = (jnp.asarray(d[:, i]) for i in range(3))
    qa = jax.jit(em_rot.eval_with_pdf)(dx, dy, dz)
    qb = jax.jit(em_rolled.eval_with_pdf)(dx, dy, dz)
    for a, b in zip(qa, qb):
        # fp in the rotated phi can flip a bilinear cell at texel
        # boundaries; tolerance covers that, not a systematic offset
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=5e-4, atol=5e-4)

    # sampling commutes: sample(rotated map) == R @ sample(base map)
    u1 = jnp.asarray(rng.uniform(0, 1, n), jnp.float32)
    u2 = jnp.asarray(rng.uniform(0, 1, n), jnp.float32)
    u3 = jnp.asarray(rng.uniform(0, 1, n), jnp.float32)
    sx, sy, sz, sp = jax.jit(em0.sample)(u1, u2, u3)
    rx, ry, rz, rp = jax.jit(em_rot.sample)(u1, u2, u3)
    R = np.asarray(EnvMap.rotation_z(ang))
    want = np.stack([np.asarray(sx), np.asarray(sy), np.asarray(sz)],
                    -1) @ R.T
    got = np.stack([np.asarray(rx), np.asarray(ry), np.asarray(rz)], -1)
    np.testing.assert_allclose(got, want, atol=2e-6)
    np.testing.assert_array_equal(np.asarray(rp), np.asarray(sp))

    # and the renders agree statistically (different u -> bin maps
    # mean different noise, so only the means are comparable)
    sphere, floor = _scene()
    kw = dict(res=24, spp=8, max_bounces=2)
    args = (sphere, floor, jnp.asarray([0.0, 0.0, 1.0]),
            jnp.zeros(3), jnp.zeros(3))
    a = np.asarray(pathtrace.render(*args, envmap=em_rot, **kw))
    b = np.asarray(pathtrace.render(*args, envmap=em_rolled, **kw))
    np.testing.assert_allclose(a.mean(), b.mean(), rtol=0.05)


def test_envmap_hdr_ingestion(tmp_path):
    """.hdr files round-trip through both the native decoder and the
    numpy fallback and feed EnvMap.build."""
    from dj_brdf_tpu.io import hdr as hdrio
    rng = np.random.default_rng(3)
    img = (rng.uniform(0, 1, (16, 32, 3)).astype(np.float32) ** 2) * 30.0
    path = str(tmp_path / "probe.hdr")
    hdrio.write_hdr(path, img)
    via_np = hdrio.load_hdr(path)
    via_any = hdrio.load_radiance_any(path)
    try:
        from dj_brdf_tpu.io import native
        via_native = native.load_hdr(path)
        np.testing.assert_array_equal(via_native, via_np)
    except Exception:
        pass
    # shared-exponent RGBE: error bounded by max-channel/128
    bound = img.max(-1, keepdims=True) / 128.0 + 1e-9
    assert (np.abs(via_any - img) <= bound).all()
    em = EnvMap.build(jnp.asarray(via_any))
    d = jax.jit(em.sample)(jnp.asarray([0.25]), jnp.asarray([0.5]),
                           jnp.asarray([0.75]))
    assert all(np.isfinite(np.asarray(x)).all() for x in d)


def test_envmap_soa_matches_generic(monkeypatch):
    """The fused SoA envmap loop (_render_envmap_soa: one kernel for
    NEE eval + MIS counter-pdf + BSDF sample) renders the same image
    as the generic layered loop, for mixed-family and same-family
    scenes."""
    em = EnvMap.build(_sun_sky(sun=30.0))

    def scene(floor_dist):
        sphere = materials.MicrofacetMaterial(
            dist=GGX(), fres=fresnel.Schlick(f0=jnp.asarray([0.9, 0.6, 0.3])),
            params=MicrofacetParams.elliptic(0.3, 0.15, 0.7))
        floor = materials.MicrofacetMaterial(
            dist=floor_dist,
            fres=fresnel.Schlick(f0=jnp.asarray([0.3, 0.3, 0.3])),
            params=MicrofacetParams.isotropic(0.5))
        return (sphere, floor, jnp.asarray([0.3, 0.4, 0.8], jnp.float32),
                jnp.zeros(3), jnp.zeros(3))

    for floor_dist in (Beckmann(), GGX()):
        args = scene(floor_dist)
        img_fast = pathtrace.render(*args, res=24, spp=4, max_bounces=2,
                                    envmap=em)
        with monkeypatch.context() as mp:
            mp.setattr(pathtrace, "_fused_info", lambda m: None)
            jax.clear_caches()
            img_generic = pathtrace.render(*args, res=24, spp=4,
                                           max_bounces=2, envmap=em)
        np.testing.assert_allclose(np.asarray(img_fast),
                                   np.asarray(img_generic),
                                   rtol=2e-3, atol=2e-3)
    jax.clear_caches()


def test_envmap_sharded_matches_unsharded():
    """Envmap MIS transport under a data-axis mesh sharding == the
    unsharded render (rays shard, emitter tables replicate)."""
    from dj_brdf_tpu.parallel.mesh import make_mesh

    em = EnvMap.build(_sun_sky())
    sphere = materials.MicrofacetMaterial(
        dist=GGX(), fres=fresnel.Schlick(f0=jnp.asarray([0.9, 0.6, 0.3])),
        params=MicrofacetParams.elliptic(0.3, 0.15, 0.7))
    floor = materials.MicrofacetMaterial(
        dist=Beckmann(), fres=fresnel.Schlick(f0=jnp.asarray([0.3, 0.3, 0.3])),
        params=MicrofacetParams.isotropic(0.5))
    args = (sphere, floor, jnp.asarray([0.3, 0.4, 0.8], jnp.float32),
            jnp.zeros(3), jnp.zeros(3))
    img0 = pathtrace.render(*args, res=16, spp=8, max_bounces=2, envmap=em)
    img1 = pathtrace.render(*args, res=16, spp=8, max_bounces=2, envmap=em,
                            mesh=make_mesh(8))
    np.testing.assert_allclose(np.asarray(img1), np.asarray(img0),
                               rtol=1e-5, atol=1e-6)
