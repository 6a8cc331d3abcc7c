"""NCC-unary demo on teddy — the example_ncc.m equivalent.

Builds the NCC model, generates RANSAC plane proposals on a 50-px grid plus a
fronto-parallel ladder, runs iterative binary fusion and then simultaneous
fusion from a restart, and reports both energies (example_ncc.m:13-64).
"""

import argparse
import sys
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import jax.numpy as jnp

from stereo_tpu.utils import compile_cache
from stereo_tpu import geometry
from stereo_tpu.models.ncc import DispMapNCC
from stereo_tpu.utils import io


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--pair", default="teddy")
    ap.add_argument("--max-disp", type=int, default=50)
    ap.add_argument("--grid-step", type=int, default=50)
    ap.add_argument("--skip-simultaneous", action="store_true")
    ap.add_argument("--schedule", default="banded",
                    help="TRW-S schedule for the simultaneous phase "
                         "(banded|checkerboard|wavefront|scanline)")
    ap.add_argument("--dtype", default="float32")
    args = ap.parse_args()
    compile_cache.enable()

    pair = io.load_pair(args.pair, dtype=np.dtype(args.dtype))
    disparities = np.arange(0, args.max_disp + 1)
    tol = 8.0 * (disparities[1] - disparities[0])
    t0 = time.perf_counter()
    dm = DispMapNCC(pair.images, disparities, kernel=1, unary_weight=40.0, tol=tol)
    H, W = dm.sz
    print(f"setup + NCC volume: {time.perf_counter()-t0:.2f}s; "
          f"initial energy {dm.energy():.6g}")

    # proposals: plane fits on a coarse grid (example_ncc.m:24-32)
    t0 = time.perf_counter()
    proposals = []
    for x in range(10, W + 1, args.grid_step):
        for y in range(10, H + 1, args.grid_step):
            proposals.append(dm.generate_new_plane_RANSAC(x, y, 5.0))
    # fronto-parallel ladder (example_ncc.m:34-41)
    for d in range(0, args.max_disp + 1, 10):
        proposals.append(geometry.fronto_parallel(H, W, float(d), dm.dtype))
    print(f"{len(proposals)} proposals in {time.perf_counter()-t0:.2f}s")

    # iterative binary fusion (example_ncc.m:44-49) — the whole proposal
    # stream scans inside one device program (identical math to per-move
    # binary_fusion; no host round-trips between moves)
    t0 = time.perf_counter()
    dm.binary_fusion_sweep(proposals, chunk=len(proposals))
    t_fuse = time.perf_counter() - t0
    single_energy = dm.energy()
    print(f"iterative fusion: E = {single_energy:.6g} "
          f"({len(proposals)} moves in {t_fuse:.2f}s, "
          f"{len(proposals)/t_fuse:.1f} moves/s)")

    if not args.skip_simultaneous:
        # simultaneous fusion from restart (example_ncc.m:57-60)
        dm.schedule = args.schedule
        dm.restart()
        t0 = time.perf_counter()
        e, lb, iters = dm.simultaneous_fusion(proposals)
        print(f"simultaneous fusion: E = {e:.6g} (lb {lb:.6g}, "
              f"{iters} TRW-S iters, {time.perf_counter()-t0:.2f}s)")
        print(f"energy ratio simultaneous/iterative: {e/single_energy:.4f}")

    return dm


if __name__ == "__main__":
    main()
