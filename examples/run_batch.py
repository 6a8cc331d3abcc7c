"""Multi-pair batched simultaneous fusion over a device mesh.

The "high-res multi-pair batch" configuration (BASELINE.json configs[4]):
several same-shaped stereo problems fused in ONE jit over a ('batch', 'x')
mesh — stereo pairs data-parallel over 'batch', the pixel grid spatially
partitioned over 'x' with XLA-inserted halo exchanges.

On a single real chip this runs with a (1, 1) mesh; on a virtual CPU mesh
(JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8) it
demonstrates the full multi-device path.
"""

import argparse
import sys
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import jax

from stereo_tpu.utils import compile_cache
from stereo_tpu import geometry
from stereo_tpu.models.ncc import DispMapNCC
from stereo_tpu.parallel import batch as batch_mod, mesh as mesh_mod
from stereo_tpu.utils import io


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", nargs="+", default=["teddy", "teddy"])
    ap.add_argument("--max-disp", type=int, default=30)
    ap.add_argument("--maxiter", type=int, default=200)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--cpu", type=int, default=0, metavar="N",
                    help="force an N-virtual-device CPU mesh")
    args = ap.parse_args()
    compile_cache.enable()

    if args.cpu:
        import os

        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.cpu}")
        jax.config.update("jax_platforms", "cpu")

    n_dev = len(jax.devices())
    batch = args.batch or (len(args.pairs) if n_dev % len(args.pairs) == 0 else 1)
    # the spatial axis must divide the image width (mesh.sharded_solve keeps
    # the sharded == single-device bitwise invariant, so no padding): use the
    # largest x <= n_dev/batch that divides W
    pair0 = io.load_pair(args.pairs[0], dtype=np.float32)
    W0 = pair0.images[0].shape[1]
    x = n_dev // batch
    while x > 1 and W0 % x != 0:
        x -= 1
    mesh = mesh_mod.make_mesh(batch * x, batch=batch)
    print(f"mesh: {dict(zip(mesh.axis_names, mesh.devices.shape))}")

    disparities = np.arange(0, args.max_disp + 1)
    models = []
    for name in args.pairs:
        pair = io.load_pair(name, dtype=np.float32)
        models.append(DispMapNCC(pair.images, disparities, kernel=1,
                                 unary_weight=40.0, tol=8.0))
    H, W = models[0].sz
    props = [
        [geometry.fronto_parallel(H, W, float(d), m.dtype)
         for d in range(0, args.max_disp + 1, 6)]
        for m in models
    ]

    t0 = time.perf_counter()
    out = batch_mod.simultaneous_fusion_pool(
        models, props, mesh, maxiter=args.maxiter, max_relgap=1e-4,
        check_every=25,
        on_progress=lambda i, r: print(
            f"  pair {i} ({args.pairs[i]}): {r['status']} after "
            f"{r['iterations']} sweeps, E = {r['energy']:.6g}"),
    )
    dt = time.perf_counter() - t0
    total_iters = 0
    for name, r in zip(args.pairs, out):
        print(f"{name}: E = {r['energy']:.6g}, lb = {r['lower_bound']:.6g}, "
              f"iters = {r['iterations']} ({r['status']})")
        total_iters += r["iterations"]
    npx = H * W
    print(f"pooled fusion: {dt:.2f}s for {len(models)} pairs "
          f"({npx * total_iters / dt / 1e6:.1f} Mpixel-iters/s)")


if __name__ == "__main__":
    main()
