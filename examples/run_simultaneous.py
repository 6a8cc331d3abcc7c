"""Simultaneous fusion on baby2 — the example_simultaneous.m equivalent
(reproduces Fig. 4 of "Simultaneous Fusion Moves for 3D-Label Stereo"):
iterative binary fusion to convergence, then simultaneous TRW-S fusion of the
same 14 SegPln proposals from a restart; simultaneous should reach a lower or
equal energy."""

import argparse
import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import numpy as np

from stereo_tpu.utils import compile_cache  # noqa: E402
from examples.run_global import build_model


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--pair", default="baby2")
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--maxiter", type=int, default=3000)
    ap.add_argument("--schedule", default="banded",
                    choices=["checkerboard", "scanline", "wavefront",
                             "banded"])
    ap.add_argument("--band", type=int, default=128,
                    help="block size for --schedule banded")
    ap.add_argument("--max-relgap", type=float, default=1e-5)
    args = ap.parse_args()
    compile_cache.enable()

    dm = build_model(args.pair, args.dtype, args.seed)
    dm.schedule = args.schedule
    dm.band = args.band

    t0 = time.perf_counter()
    segplns = dm.segpln(seed=args.seed)
    print(f"{len(segplns)} SegPln proposals in {time.perf_counter()-t0:.2f}s")

    # iterative binary fusion until no proposal improves (example_simultaneous.m:38)
    t0 = time.perf_counter()
    iters = dm.binary_fuse_until_convergence(segplns, seed=args.seed)
    e_iter = dm.energy()
    print(f"iterative fusion: E = {e_iter:.6g} "
          f"({iters} fusions, {time.perf_counter()-t0:.2f}s)")

    # simultaneous fusion from a restart (example_simultaneous.m:49-52)
    dm.restart()
    dm.maxiter = args.maxiter
    dm.max_relgap = args.max_relgap
    t0 = time.perf_counter()
    e_sim, lb, trws_iters = dm.simultaneous_fusion(segplns, verbose=True)
    dt = time.perf_counter() - t0
    print(f"simultaneous fusion: E = {e_sim:.6g} (lb {lb:.6g}, "
          f"{trws_iters} TRW-S iters, {dt:.2f}s)")
    print(f"simultaneous/iterative energy ratio: {e_sim/e_iter:.4f}")
    return dm


if __name__ == "__main__":
    main()
