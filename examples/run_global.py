"""Binary fusion of SegPln proposals on teddy — the example_global.m equivalent
(reproduces Fig. 4b of "In Defense of 3D-Label Stereo")."""

import argparse
import sys
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from stereo_tpu.utils import compile_cache
from stereo_tpu.config import CVPR08Options
from stereo_tpu.models.global_stereo import DispMapGlobalStereo
from stereo_tpu.utils import io


def build_model(pair_name, dtype, seed=0, kernel=1):
    pair = io.load_pair(pair_name, dtype=np.dtype(dtype))
    options = CVPR08Options(smoothness_kernel=kernel)
    t0 = time.perf_counter()
    dm = DispMapGlobalStereo(
        pair.images, pair.P, pair.disp_range, pair.disparity_factor, options,
        seed=seed,
    )
    print(f"setup (incl. segmentation weights): {time.perf_counter()-t0:.2f}s; "
          f"initial energy {dm.energy():.6g}")
    return dm


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--pair", default="teddy")
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    compile_cache.enable()

    dm = build_model(args.pair, args.dtype, args.seed)

    t0 = time.perf_counter()
    segplns = dm.segpln(seed=args.seed)
    print(f"{len(segplns)} SegPln proposals in {time.perf_counter()-t0:.2f}s")

    t0 = time.perf_counter()
    for i, P in enumerate(segplns):
        e, lb = dm.binary_fusion(P)
        print(f"  SegPln {i+1}/{len(segplns)}: E = {e:.6g}")
    dt = time.perf_counter() - t0
    print(f"final energy {dm.energy():.6g} "
          f"({len(segplns)} fusions in {dt:.2f}s, {len(segplns)/dt:.2f} moves/s)")

    # Middlebury bad-pixel regression (BASELINE.md metric 1) — GT can't be
    # downloaded in this environment (download_stereo.m needs egress), so the
    # metric activates when GT files are provided via data dir or env var.
    gt = io.load_ground_truth(args.pair)
    if gt is not None:
        from stereo_tpu import geometry
        from stereo_tpu.utils import metrics

        d = np.asarray(geometry.own_disparity(dm.assignment))
        d = d / dm.disparity_factor
        rate = metrics.bad_pixel_rate(d, gt, threshold=1.0)
        print(f"bad-pixel rate (|err| > 1): {100 * rate:.2f}%")
    else:
        print("no GT disparities found (set STEREO_TPU_GT_DIR to enable "
              "bad-pixel %)")
    return dm


if __name__ == "__main__":
    main()
