"""Second-order scalar-disparity stereo (the ojw_stereo pipeline core).

Runs the SecondOrderStereo model — scalar disparity per pixel, triple-clique
truncated second-derivative prior (4- or 8-connect), QPBO fusion with cubic
reduction and the geometric visibility model — through the
ojw_stereo_optim-style proposal schedule on a crop of a bundled pair.
(Fusion solves on the native host QPBO, so a crop keeps runtime interactive.)

Two modes:
  default    — one optimize() call over a mixed schedule (quick);
  --full     — the complete ojw_stereo proposal_method pipeline
               (SameUni → SegPln → Smooth*, ojw_stereo.m:144-192).
"""

import argparse
import sys
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from stereo_tpu.utils import compile_cache
from stereo_tpu.config import CVPR08Options
from stereo_tpu.models.second_order import SecondOrderStereo, ojw_stereo
from stereo_tpu.utils import io, viz


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--pair", default="teddy")
    ap.add_argument("--crop", type=int, nargs=4, default=[120, 240, 100, 280],
                    metavar=("Y0", "Y1", "X0", "X1"))
    ap.add_argument("--max-disp", type=int, default=14)
    ap.add_argument("--iters", type=int, default=12)
    ap.add_argument("--connect", type=int, default=4, choices=(4, 8))
    ap.add_argument("--kernel", type=int, default=1, choices=(1, 2))
    ap.add_argument("--no-visibility", action="store_true")
    ap.add_argument("--full", action="store_true",
                    help="run the full proposal_method pipeline")
    ap.add_argument("--out", default="/tmp/second_order_disp.png")
    args = ap.parse_args()
    compile_cache.enable()

    pair = io.load_pair(args.pair)
    y0, y1, x0, x1 = args.crop
    crop = lambda im: im[y0:y1, x0:x1]
    P = pair.P.copy()
    P[1, 0, 3] = -0.25  # quarter-pixel shift per disparity unit (teddy)

    opts = CVPR08Options(
        connect=args.connect, smoothness_kernel=args.kernel,
        visibility=not args.no_visibility,
        max_iters=args.iters, average_over=min(4, args.iters),
        converge=0.0,
    )

    if args.full:
        t0 = time.perf_counter()
        model, info = ojw_stereo(
            [crop(pair.images[0]), crop(pair.images[1])], P,
            (0, args.max_disp), 1, opts, seed=0, verbose=True,
            save_progress=lambda it, d: np.save("/tmp/second_order_D.npy", d),
        )
        dt = time.perf_counter() - t0
        for name, st in info["stages"].items():
            es = st["energy"]
            print(f"stage {name}: E {es[0]:.6g} -> {es[-1]:.6g} "
                  f"({len(es)-1} fusions)")
        print(f"total: {dt:.1f}s")
        viz.save_dispmap(args.out, np.asarray(model.disp),
                         energy=info["stages"]["smooth_star"]["energy"][-1])
        print("disparity render:", args.out)
        return

    t0 = time.perf_counter()
    dm = SecondOrderStereo(
        [crop(pair.images[0]), crop(pair.images[1])], P,
        (0, args.max_disp), 1, opts, seed=0,
    )
    print(f"setup: {time.perf_counter()-t0:.1f}s; initial E = {dm.energy():.6g}")

    t0 = time.perf_counter()
    energies = dm.optimize(
        schedule=("sweep_ftb", "smooth", "fronto", "random"),
        max_iters=args.iters, verbose=True,
    )
    dt = time.perf_counter() - t0
    print(f"final E = {energies[-1]:.6g} after {len(energies)-1} fusions "
          f"({dt:.1f}s, {(len(energies)-1)/dt:.2f} moves/s)")
    viz.save_dispmap(args.out, np.asarray(dm.disp), energy=energies[-1])
    print("disparity render:", args.out)


if __name__ == "__main__":
    main()
