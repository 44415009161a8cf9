"""dj_brdf_tpu — a differentiable BRDF renderer/fitter in JAX.

A from-scratch JAX/XLA/Pallas framework with the capabilities of the
dj_brdf C++ toolkit (reference: jdupuy/dj_brdf, ``dj_brdf.h``): Smith
microfacet BRDFs (Beckmann/GGX with full elliptic anisotropy and
non-central mean normals), VNDF importance sampling, measured MERL/UTIA
dataset evaluation, SGD/ABC analytic fits, power-iteration NDF
extraction and roughness fitting, LEAN/LEADR filtered normal mapping —
all as differentiable, vmappable, shardable JAX programs.

Conventions (match the reference, dj_brdf.h:23-26):
  * ``i`` is the direction toward the light, ``o`` toward the viewer.
  * Directions are arrays of shape ``(..., 3)`` in the local shading
    frame with ``z`` the geometric normal.
  * All functions broadcast over leading batch dimensions and are safe
    under ``jit``/``vmap``/``grad``.
"""

from dj_brdf_tpu import config
from dj_brdf_tpu.core import math as vecmath
from dj_brdf_tpu.core import special, spline
from dj_brdf_tpu import fresnel
from dj_brdf_tpu.microfacet.params import MicrofacetParams
from dj_brdf_tpu.microfacet.ndf import (
    GGX, GGXSphericalCaps, Beckmann, Tabular, TabularAnisotropic)
from dj_brdf_tpu.microfacet import brdf as microfacet
from dj_brdf_tpu.models.lambert import Lambert
from dj_brdf_tpu.models.merl import Merl
from dj_brdf_tpu.models.utia import Utia
from dj_brdf_tpu.models.sgd import SGD
from dj_brdf_tpu.models.abc_model import ABC
from dj_brdf_tpu.render.materials import (
    MicrofacetMaterial, MeasuredMaterial, CosineMaterial,
    TexturedMicrofacetMaterial, UVMappedMaterial)
from dj_brdf_tpu.lean.lrep import Lrep
from dj_brdf_tpu.lean.filtered import FilteredBeckmannMaterial
from dj_brdf_tpu import io

__version__ = "0.1.0"
