"""GGX and Beckmann roughness extraction for MERL BRDFs.

Equivalent of ``examples/merl_params.cpp``: for each MERL binary, run
the tabulation pipeline at res 90 and append
``name beckmann_alpha ggx_alpha`` to params.txt
(merl_params.cpp:53-68).

Unlike the reference's one-file-at-a-time loop, all materials stack on
a leading axis and tabulate in ONE vmapped device program
(fit/batch.py::tabulate_merl_batch); ``--mesh N`` additionally shards
the material axis over an N-device mesh.

Usage: python -m dj_brdf_tpu.cli.merl_params merl1.binary merl2.binary ...
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("files", nargs="+", help="MERL .binary files")
    ap.add_argument("-o", "--output", default="params.txt")
    ap.add_argument("--res", type=int, default=90)
    ap.add_argument("--mesh", type=int, default=0,
                    help="shard materials over an N-device mesh")
    args = ap.parse_args(argv)

    import numpy as np
    from dj_brdf_tpu.config import setup_compile_cache
    from dj_brdf_tpu.fit.batch import tabulate_merl_batch
    from dj_brdf_tpu.io.merl_io import load_merl

    setup_compile_cache()
    tables = np.stack([load_merl(path) for path in args.files])
    mesh = None
    if args.mesh:
        from dj_brdf_tpu.parallel.mesh import make_mesh
        mesh = make_mesh(args.mesh)

    t0 = time.perf_counter()
    _, _, ab, ag = tabulate_merl_batch(tables, args.res, mesh=mesh)
    ab, ag = np.asarray(ab), np.asarray(ag)
    print(f"# tabulated {len(args.files)} materials in "
          f"{time.perf_counter() - t0:.2f}s", file=sys.stderr)

    with open(args.output, "w") as pf:
        pf.write("# MERL Beckmann GGX\n")
        for k, path in enumerate(args.files):
            name = os.path.splitext(os.path.basename(path))[0]
            pf.write(f"{name} {ab[k]:.3f} {ag[k]:.3f}\n")
            print(f"{name}: beckmann={ab[k]:.3f} ggx={ag[k]:.3f}",
                  file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
