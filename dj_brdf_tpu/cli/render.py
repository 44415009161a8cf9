"""Render a directly lit sphere with any model in the framework — the
JAX replacement for the reference's Mitsuba matpreview scenes
(mitsuba/*.cpp expose the same six material families as BSDF plugins).

Usage examples:
  python -m dj_brdf_tpu.cli.render --model ggx --alpha1 0.3 --alpha2 0.1
  python -m dj_brdf_tpu.cli.render --model merl --file brass.binary
  python -m dj_brdf_tpu.cli.render --model sgd --material gold-metallic-paint
  python -m dj_brdf_tpu.cli.render --model merl_fit --file brass.binary
"""

from __future__ import annotations

import argparse


def _tab_material(args, tab, tab_fres, tab_textured_params):
    """A tabulated-NDF material for the chosen renderer: uniform
    standard frame, pre-sampled per-pixel textures (sphere renderer),
    or per-hit uv fetch via UVMappedMaterial (--pathtrace)."""
    import jax.numpy as jnp
    import numpy as np
    from dj_brdf_tpu.microfacet.params import MicrofacetParams
    from dj_brdf_tpu.render.materials import (MicrofacetMaterial,
                                              UVMappedMaterial)

    textured = args.alpha1_map or args.alpha2_map or args.alpha_angle_map
    if not textured:
        return MicrofacetMaterial(dist=tab, fres=tab_fres,
                                  params=MicrofacetParams.standard())
    if not args.pathtrace:
        return MicrofacetMaterial(dist=tab, fres=tab_fres,
                                  params=tab_textured_params)

    def map_or(path, const):
        if not path:
            return jnp.float32(const)
        return jnp.asarray(np.load(path), jnp.float32)

    # unmapped components default to the table's unit base roughness
    return UVMappedMaterial(dist=tab, fres=tab_fres,
                            alpha1=map_or(args.alpha1_map, 1.0),
                            alpha2=map_or(args.alpha2_map, 1.0),
                            alpha_angle=map_or(args.alpha_angle_map, 0.0))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model", required=True,
                    choices=["ggx", "beckmann", "lambert", "merl", "utia",
                             "sgd", "abc", "merl_fit", "merl_tab",
                             "utia_fit", "utia_tab", "lean"])
    ap.add_argument("--file", help="MERL/UTIA binary "
                                   "(merl/utia/merl_fit/merl_tab/utia_fit)")
    ap.add_argument("--material", help="material name (sgd/abc)")
    ap.add_argument("--alpha1", type=float, default=0.3)
    ap.add_argument("--alpha2", type=float, default=None)
    ap.add_argument("--alpha-angle", type=float, default=0.0)
    ap.add_argument("--alpha1-map", help=".npy (H,W) texture driving "
                    "alpha1 per shading point (mitsuba/dj_brdf.cpp:353-357)")
    ap.add_argument("--alpha2-map", help=".npy (H,W) texture for alpha2")
    ap.add_argument("--alpha-angle-map",
                    help=".npy (H,W) texture for alphaAngle (radians)")
    ap.add_argument("--f0", type=float, nargs=3, default=[1.0, 1.0, 1.0])
    ap.add_argument("--fit-res", type=int, default=90,
                    help="tabulation resolution for *_fit/merl_tab "
                         "(reference uses 90)")
    ap.add_argument("--conductor", action="store_true",
                    help="multiply exact conductor Fresnel on top "
                         "(the dj_brdf plugin's Mitsuba-Fresnel path, "
                         "mitsuba/dj_brdf.cpp:366)")
    ap.add_argument("--eta", type=float, nargs=3,
                    default=[0.143, 0.375, 1.442],  # gold
                    help="conductor ior (lean/--conductor)")
    ap.add_argument("--k", type=float, nargs=3,
                    default=[3.983, 2.386, 1.603],
                    help="conductor extinction (lean/--conductor)")
    ap.add_argument("--leanmap1", help="E1,E2 map .npy (lean)")
    ap.add_argument("--leanmap2", help="E3,E4,E5 map .npy (lean)")
    ap.add_argument("--dmap-scale", type=float, default=1.0)
    ap.add_argument("--naive-mip", action="store_true",
                    help="disable LEAN filtering (leanFiltering=false)")
    ap.add_argument("--biased", action="store_true",
                    help="maps carry the +25/+625 storage bias")
    ap.add_argument("--mip", type=int, default=0,
                    help="LEAN mip level to shade with")
    ap.add_argument("--lean-lod", action="store_true",
                    help="with --pathtrace: select the LEAN mip level "
                         "per hit from the ray-cone footprint "
                         "(automatic minification filtering; the role "
                         "of Mitsuba's mip machinery)")
    ap.add_argument("--light", type=float, nargs=3, default=[0.3, 0.4, 0.8])
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--exposure", type=float, default=1.0)
    ap.add_argument("--pathtrace", action="store_true",
                    help="multi-bounce sphere-on-plane path trace "
                         "instead of the direct-light sphere")
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--bounces", type=int, default=3)
    ap.add_argument("--floor-model", default="lambert",
                    choices=["lambert", "ggx", "beckmann", "lean"],
                    help="ground-plane material for --pathtrace; 'lean' "
                         "uses --floor-leanmap1/--floor-leanmap2 (full "
                         "maps fetched per hit, the matpreview floor)")
    ap.add_argument("--floor-alpha", type=float, default=0.4,
                    help="floor roughness (ggx/beckmann) or LEAN base "
                         "roughness (lean)")
    ap.add_argument("--floor-f0", type=float, nargs=3,
                    default=[0.35, 0.35, 0.35])
    ap.add_argument("--floor-leanmap1", help="floor E1,E2 map .npy "
                    "(--floor-model lean)")
    ap.add_argument("--floor-leanmap2", help="floor E3,E4,E5 map .npy")
    ap.add_argument("--envmap", help=".npy (H,W,3) or Radiance .hdr "
                    "lat-long radiance: environment lighting with "
                    "importance sampling + MIS (replaces --light and the "
                    "constant sky; needs --pathtrace)")
    ap.add_argument("--envmap-rot-z", type=float, default=0.0,
                    help="rotate the environment emitter about +z "
                         "(degrees; the scenes' toWorld orientation)")
    ap.add_argument("-o", "--output", default="render.png")
    args = ap.parse_args(argv)

    import numpy as np
    import jax
    import jax.numpy as jnp
    from dj_brdf_tpu import fresnel
    from dj_brdf_tpu.config import setup_compile_cache
    from dj_brdf_tpu.microfacet import brdf as mf
    from dj_brdf_tpu.microfacet.ndf import GGX, Beckmann
    from dj_brdf_tpu.microfacet.params import MicrofacetParams
    from dj_brdf_tpu.render.sphere import render_sphere

    from dj_brdf_tpu.models.lambert import Lambert
    from dj_brdf_tpu.render.materials import (CosineMaterial,
                                              MeasuredMaterial,
                                              MicrofacetMaterial)

    setup_compile_cache()
    a2 = args.alpha2 if args.alpha2 is not None else args.alpha1
    params = MicrofacetParams.elliptic(args.alpha1, a2, args.alpha_angle)
    fres = fresnel.Schlick(f0=jnp.asarray(args.f0, jnp.float32))

    textured = args.alpha1_map or args.alpha2_map or args.alpha_angle_map
    tab_textured_params = None
    if args.pathtrace and args.floor_model == "lambert" and (
            (textured and args.model in ("ggx", "beckmann"))
            or args.model == "lean"):
        # textured analytic / LEAN materials run only in the fused SoA
        # loop, and the default lambert floor is not fused-capable —
        # fail at parse time with the fix, not mid-trace (textured
        # TABULAR materials go through the generic loop and accept any
        # floor)
        ap.error("textured roughness / LEAN maps under --pathtrace need "
                 "a fused-capable floor: add --floor-model "
                 "{ggx,beckmann,lean}")
    if textured:
        if args.pathtrace:
            # per-hit texture fetch inside the bounce loop (the
            # integrator-orthogonal path, mitsuba/dj_brdf.cpp:353-357):
            # analytic families via the fused SoA kernels, tabular
            # NDFs via the generic loop's at_uv specialization
            if args.model not in ("ggx", "beckmann", "merl_tab",
                                  "utia_tab"):
                ap.error("textured roughness under --pathtrace supports "
                         "the microfacet models "
                         "(ggx/beckmann/merl_tab/utia_tab)")
            if (args.model in ("merl_tab", "utia_tab")
                    and args.floor_model == "lean"):
                ap.error("textured tabular models render through the "
                         "generic loop and cannot pair with the "
                         "fused-only LEAN floor; use --floor-model "
                         "{lambert,ggx,beckmann}")
        else:
            # sphere renderer: sample the maps at the preview sphere's
            # UVs and build per-pixel elliptic params
            # (mitsuba/dj_brdf.cpp:166-288, 353-357)
            if args.model not in ("ggx", "beckmann", "merl_tab",
                                  "utia_tab"):
                ap.error(f"--alpha*-map textures apply to the microfacet "
                         f"models (ggx/beckmann/merl_tab/utia_tab), not "
                         f"{args.model}")
            from dj_brdf_tpu.render.sphere import (sample_texture,
                                                   sphere_normals,
                                                   sphere_uv)
            n_tex, _ = sphere_normals(args.res)
            uu, vv = sphere_uv(n_tex)

            def tex_or(path, const):
                if not path:
                    return jnp.full(uu.shape, jnp.float32(const))
                t = jnp.asarray(np.load(path), jnp.float32)
                return sample_texture(t, uu, vv)

            params = MicrofacetParams.elliptic(
                tex_or(args.alpha1_map, args.alpha1),
                tex_or(args.alpha2_map, a2),
                tex_or(args.alpha_angle_map, args.alpha_angle))
            # for the tabulated-NDF models the untextured base
            # roughness is the standard unit frame, so unmapped
            # components default to 1.0 / 0.0 rather than the
            # analytic-model defaults
            tab_textured_params = MicrofacetParams.elliptic(
                tex_or(args.alpha1_map, 1.0),
                tex_or(args.alpha2_map, 1.0),
                tex_or(args.alpha_angle_map, 0.0))

    if args.model in ("ggx", "beckmann"):
        dist = GGX() if args.model == "ggx" else Beckmann()
        if textured and args.pathtrace:
            from dj_brdf_tpu.render.materials import \
                TexturedMicrofacetMaterial

            def tex_or_scalar(path, const):
                if not path:
                    return jnp.float32(const)
                return jnp.asarray(np.load(path), jnp.float32)

            mat = TexturedMicrofacetMaterial(
                dist=dist, fres=fres,
                alpha1=tex_or_scalar(args.alpha1_map, args.alpha1),
                alpha2=tex_or_scalar(args.alpha2_map, a2),
                alpha_angle=tex_or_scalar(args.alpha_angle_map,
                                          args.alpha_angle))
        else:
            mat = MicrofacetMaterial(dist=dist, fres=fres, params=params)
    elif args.model == "lambert":
        mat = CosineMaterial(model=Lambert(
            reflectance=jnp.asarray(args.f0, jnp.float32)))
    elif args.model == "merl":
        from dj_brdf_tpu.io.merl_io import load_merl
        mat = MeasuredMaterial.from_merl(jnp.asarray(load_merl(args.file)))
    elif args.model == "utia":
        from dj_brdf_tpu.io.utia_io import load_utia
        from dj_brdf_tpu.models.utia import Utia
        mat = CosineMaterial(model=Utia(
            table=jnp.asarray(load_utia(args.file))))
    elif args.model == "sgd":
        from dj_brdf_tpu.models.sgd import SGD
        mat = MeasuredMaterial.from_model(SGD.from_name(args.material))
    elif args.model == "abc":
        from dj_brdf_tpu.models.abc_model import ABC
        mat = MeasuredMaterial.from_model(ABC.from_name(args.material))
    elif args.model == "merl_fit":
        # the dj_merl plugin path: fit a GGX proxy, render the proxy
        # parameters with the extracted Fresnel (mitsuba/dj_merl.cpp:29-33)
        from dj_brdf_tpu.fit import moments, tabular
        from dj_brdf_tpu.io.merl_io import load_merl
        from dj_brdf_tpu.models.merl import Merl
        m = Merl(table=jnp.asarray(load_merl(args.file)))
        tab, tab_fres = tabular.build_tabular(m, args.fit_res,
                                              shadow=False)
        p = moments.fit_ggx_parameters(tab)
        mat = MicrofacetMaterial(dist=GGX(), fres=tab_fres, params=p)
    elif args.model == "merl_tab":
        # the dj_brdf plugin with distribution="tabular" + merl: render
        # the extracted tabulated NDF itself with the extracted Fresnel
        # (mitsuba/dj_brdf.cpp:208-233)
        from dj_brdf_tpu.fit import tabular
        from dj_brdf_tpu.io.merl_io import load_merl
        from dj_brdf_tpu.models.merl import Merl
        m = Merl(table=jnp.asarray(load_merl(args.file)))
        tab, tab_fres = tabular.build_tabular(m, args.fit_res)
        # textured alphas modulate around the tabulated NDF's unit
        # base roughness (dj_brdf.cpp:353-357 with baseRoughness = 1)
        mat = _tab_material(args, tab, tab_fres, tab_textured_params)
    elif args.model == "utia_fit":
        # the dj_brdf plugin's UTIA path: anisotropic tabulation at
        # scene load, base roughness from the anisotropic moment fit
        # (mitsuba/dj_brdf.cpp:234-259)
        from dj_brdf_tpu.fit import moments, tabular_aniso
        from dj_brdf_tpu.io.utia_io import load_utia
        from dj_brdf_tpu.models.utia import Utia
        u = Utia.build(jnp.asarray(load_utia(args.file)))
        tab, tab_fres = tabular_aniso.build_tabular_anisotropic(
            u, args.fit_res, args.fit_res)
        p = moments.fit_beckmann_parameters_anisotropic(tab)
        mat = MicrofacetMaterial(dist=Beckmann(), fres=tab_fres, params=p)
    elif args.model == "utia_tab":
        # the dj_brdf plugin with distribution="tabular" + utia: render
        # and sample the extracted anisotropic table itself
        # (mitsuba/dj_brdf.cpp:234-259)
        from dj_brdf_tpu.fit import tabular_aniso
        from dj_brdf_tpu.io.utia_io import load_utia
        from dj_brdf_tpu.models.utia import Utia
        u = Utia.build(jnp.asarray(load_utia(args.file)))
        tab, tab_fres = tabular_aniso.build_tabular_anisotropic(
            u, args.fit_res, args.fit_res)
        mat = _tab_material(args, tab, tab_fres, tab_textured_params)
    elif args.model == "lean":
        # the dj_beckmannconductor plugin: LEAN maps + base roughness +
        # exact conductor Fresnel (mitsuba/dj_beckmannconductor.cpp)
        if not (args.leanmap1 and args.leanmap2):
            ap.error("--model lean requires --leanmap1 and --leanmap2")
        from dj_brdf_tpu.lean.lrep import Lrep
        from dj_brdf_tpu.lean.maps import build_mip_pyramid
        from dj_brdf_tpu.lean.filtered import FilteredBeckmannMaterial
        from dj_brdf_tpu.render.sphere import (sample_texture,
                                               sphere_normals, sphere_uv)
        m1 = jnp.asarray(np.load(args.leanmap1), jnp.float32)
        m2 = jnp.asarray(np.load(args.leanmap2), jnp.float32)
        lean = Lrep(E1=m1[..., 0], E2=m1[..., 1], E3=m2[..., 0],
                    E4=m2[..., 1], E5=m2[..., 2])
        if args.mip > 0:
            pyramid = build_mip_pyramid(lean)
            lean = pyramid[min(args.mip, len(pyramid) - 1)]
        if not args.pathtrace:
            # sphere renderer: per-pixel moments sampled at its UVs;
            # the path tracer instead keeps the full maps and fetches
            # per hit inside the bounce loop
            n, _ = sphere_normals(args.res)
            uu, vv = sphere_uv(n)
            lean = jax.tree.map(lambda t: sample_texture(t, uu, vv), lean)
        mat = FilteredBeckmannMaterial(
            lean=lean, base_params=params,
            eta=jnp.asarray(args.eta, jnp.float32),
            k=jnp.asarray(args.k, jnp.float32),
            dmap_scale=jnp.float32(args.dmap_scale),
            lean_filtering=not args.naive_mip, biased=args.biased,
            mip_lod=args.lean_lod and args.pathtrace)

    if args.conductor and isinstance(mat, MicrofacetMaterial):
        # fresnelConductorExact multiplied on top (dj_brdf.cpp:366, 430)
        from dj_brdf_tpu.render.materials import ConductorWrap
        mat = ConductorWrap(inner=mat,
                            eta=jnp.asarray(args.eta, jnp.float32),
                            k=jnp.asarray(args.k, jnp.float32))

    if args.pathtrace:
        from dj_brdf_tpu.render.pathtrace import render as pt_render
        if args.floor_model == "lambert":
            floor = CosineMaterial(model=Lambert(
                reflectance=jnp.asarray([0.42, 0.42, 0.45], jnp.float32)))
        elif args.floor_model in ("ggx", "beckmann"):
            floor = MicrofacetMaterial(
                dist=GGX() if args.floor_model == "ggx" else Beckmann(),
                fres=fresnel.Schlick(
                    f0=jnp.asarray(args.floor_f0, jnp.float32)),
                params=MicrofacetParams.isotropic(args.floor_alpha))
        else:  # lean: the matpreview floor — full LEAN maps, fetched
            #        per hit inside the bounce loop
            if not (args.floor_leanmap1 and args.floor_leanmap2):
                ap.error("--floor-model lean requires --floor-leanmap1 "
                         "and --floor-leanmap2")
            from dj_brdf_tpu.lean.lrep import Lrep
            from dj_brdf_tpu.lean.filtered import FilteredBeckmannMaterial
            m1 = jnp.asarray(np.load(args.floor_leanmap1), jnp.float32)
            m2 = jnp.asarray(np.load(args.floor_leanmap2), jnp.float32)
            floor = FilteredBeckmannMaterial(
                lean=Lrep(E1=m1[..., 0], E2=m1[..., 1], E3=m2[..., 0],
                          E4=m2[..., 1], E5=m2[..., 2]),
                base_params=MicrofacetParams.isotropic(args.floor_alpha),
                eta=jnp.asarray(args.eta, jnp.float32),
                k=jnp.asarray(args.k, jnp.float32),
                dmap_scale=jnp.float32(args.dmap_scale),
                lean_filtering=not args.naive_mip, biased=args.biased,
                mip_lod=args.lean_lod)
        em = None
        if args.envmap:
            from dj_brdf_tpu.io.hdr import load_radiance_any
            from dj_brdf_tpu.render.envmap import EnvMap
            rot = (EnvMap.rotation_z(np.deg2rad(args.envmap_rot_z))
                   if args.envmap_rot_z else None)
            em = EnvMap.build(
                jnp.asarray(load_radiance_any(args.envmap), jnp.float32),
                rotation=rot)
        img = pt_render(mat, floor, tuple(args.light),
                        (3.0, 3.0, 3.0), (0.3, 0.38, 0.5),
                        res=args.res, spp=args.spp,
                        max_bounces=args.bounces, envmap=em)
    elif args.envmap:
        ap.error("--envmap needs --pathtrace")
    else:
        # the material is a pytree jit ARGUMENT: closing over it would
        # embed measured tables as XLA constants (DESIGN.md §6)
        img = jax.jit(lambda mat: render_sphere(
            mat.evalp, tuple(args.light), res=args.res))(mat)
    if args.output.endswith(".npy"):
        # raw HDR radiance (pre-exposure/-gamma) for numeric use
        np.save(args.output, np.asarray(img))
    else:
        arr = np.asarray(jnp.clip(img * args.exposure, 0.0, 1.0) ** (1 / 2.2))
        from PIL import Image
        Image.fromarray((arr * 255).astype(np.uint8)).save(args.output)
    print(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
