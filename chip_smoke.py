"""Smoke run of the stereo_tpu main path on one GPU.

Drives, in one process and through the public API (``stereo_tpu.models``,
``.solvers``, ``.utils.io``), the two bundled end-to-end runs at full size:

  ncc_teddy     DispMapNCC on teddy (375x450, disparities 0..50): one binary
                fusion sweep over the 78-proposal stream of
                examples/run_ncc.py, a repeated move checked for identical
                take-masks, then simultaneous fusion at K=79 under the
                checkerboard and the banded (B=128) schedules;
  global_baby2  DispMapGlobalStereo on baby2 (370x413): mean-shift
                segmentation (its filter also run on the CPU as the
                reference), 14 SegPln proposals, fusion to convergence, then
                simultaneous fusion at K=15 under both schedules;
  kernels       the Triton phase kernel against the plain XLA compacted
                phase at baby2 K=15 and teddy K=79 widths, and the banded
                send formulation against a numpy min-plus at K=79 over the
                lanes of teddy at B=128.

Every phase checks its results (finite energies, a non-increasing fusion
trace, lb <= E, errors within tolerance) and a failed check ends the script
with a non-zero exit.  ``--multi`` instead runs only the several-device paths
(``__graft_entry__.dryrun_multichip(4)`` at teddy height) and their
single-device comparison.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
Without a GPU the script exits non-zero and prints no such line.

Usage: python chip_smoke.py [--multi]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

EPS32 = float(np.finfo(np.float32).eps)
NCC_SWEEPS = 200  # TRW-S sweeps per schedule at K=79
GLOBAL_SWEEPS = 300  # TRW-S sweeps per schedule at K=15
BAND = 128  # banded block size of the examples (run_ncc.py, run_simultaneous.py)


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str):
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str):
    print(msg, flush=True)


def _crop(images, crop):
    if crop is None:
        return images
    h, w = crop
    return [np.asarray(im)[:h, :w] for im in images]


def card_line() -> str:
    """``nvidia-smi`` name and power limit, from a child that stays off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip()


# ------------------------------------------------------------------ phases
def phase_device() -> dict:
    import jax

    from stereo_tpu.utils import compile_cache

    cache = compile_cache.enable()
    devs = jax.devices()
    d = devs[0]
    if d.platform != "gpu":
        raise SmokeFailure(f"no GPU: JAX's first device is {d.platform!r}")
    log(f"[device] kind={d.device_kind} count={len(devs)} "
        f"jax={jax.__version__} compile_cache={cache}")
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(devs)}


def _check_trace(name: str, energies):
    es = np.asarray(energies, np.float64)
    check(np.isfinite(es).all(), f"{name}: non-finite fusion energy")
    # each move's energy is a fresh float32 sum over the image; allow the
    # roundoff of re-summing one configuration (8 ulp of the total)
    rise = float(np.max(np.diff(es), initial=0.0))
    check(rise <= 8 * EPS32 * float(np.max(np.abs(es))),
          f"{name}: fusion trace increased by {rise}")
    return rise


def _simultaneous(dm, proposals, schedule: str, sweeps: int, tag: str):
    dm.schedule = schedule
    dm.band = BAND
    dm.maxiter = sweeps
    dm.max_relgap = 0.0
    dm.restart()
    t0 = time.perf_counter()
    e, lb, iters = dm.simultaneous_fusion(proposals)
    dt = time.perf_counter() - t0
    check(np.isfinite(e) and np.isfinite(lb),
          f"{tag}/{schedule}: non-finite E={e} lb={lb}")
    check(lb <= e, f"{tag}/{schedule}: lower bound {lb} above energy {e}")
    log(f"[{tag}] simultaneous {schedule}: K={len(proposals) + 1} "
        f"E={e:.9g} lb={lb:.9g} sweeps={iters} wall={dt:.3f}s")
    return e, lb


def build_ncc(pair: str = "teddy", max_disp: int = 50, grid_step: int = 50,
              crop=None):
    """DispMapNCC and the proposal stream of examples/run_ncc.py: RANSAC
    plane fits on a grid plus a fronto-parallel ladder."""
    from stereo_tpu import geometry
    from stereo_tpu.models.ncc import DispMapNCC
    from stereo_tpu.utils import io

    images = _crop(io.load_pair(pair, dtype=np.float32).images, crop)
    dm = DispMapNCC(images, np.arange(0, max_disp + 1), kernel=1,
                    unary_weight=40.0, tol=8.0)
    H, W = dm.sz
    proposals = [dm.generate_new_plane_RANSAC(x, y, 5.0)
                 for x in range(10, W + 1, grid_step)
                 for y in range(10, H + 1, grid_step)]
    proposals += [geometry.fronto_parallel(H, W, float(d), dm.dtype)
                  for d in range(0, max_disp + 1, 10)]
    return dm, proposals


def build_global(pair: str = "baby2", crop=None):
    """DispMapGlobalStereo with the cvpr08 options (mean-shift weights run
    at construction) and the pair's images."""
    from stereo_tpu.config import CVPR08Options
    from stereo_tpu.models.global_stereo import DispMapGlobalStereo
    from stereo_tpu.utils import io

    p = io.load_pair(pair, dtype=np.float32)
    images = _crop(p.images, crop)
    dm = DispMapGlobalStereo(images, p.P, p.disp_range, p.disparity_factor,
                             CVPR08Options(), seed=0)
    return dm, images


def phase_ncc_teddy(pair: str = "teddy", max_disp: int = 50,
                    grid_step: int = 50, sweeps: int = NCC_SWEEPS,
                    crop=None) -> dict:
    import jax.numpy as jnp

    t0 = time.perf_counter()
    dm, proposals = build_ncc(pair, max_disp, grid_step, crop)
    H, W = dm.sz
    log(f"[ncc_teddy] {H}x{W}, {len(proposals)} proposals, "
        f"set-up {time.perf_counter() - t0:.3f}s, E0={dm.energy():.9g}")

    start, e0 = dm.assignment, dm.energy()
    t0 = time.perf_counter()
    es = dm.binary_fusion_sweep(proposals, chunk=len(proposals))
    dt = time.perf_counter() - t0
    rise = _check_trace("ncc_teddy", [e0] + es)
    log(f"[ncc_teddy] fusion sweep: {len(es)} moves in {dt:.3f}s, "
        f"E {es[0]:.9g} -> {es[-1]:.9g} (largest step-up {rise:.3g})")

    # the same move twice from the same state: identical take-masks
    fused = dm.assignment
    prop = proposals[len(proposals) // 2]
    masks = []
    for _ in range(2):
        dm.assignment = start
        dm.binary_fusion(prop)
        masks.append(np.asarray(jnp.any(dm.assignment != start, axis=0)))
    check(np.array_equal(masks[0], masks[1]),
          "ncc_teddy: a repeated move gave different take-masks")
    log(f"[ncc_teddy] repeated move: identical take-masks "
        f"({int(masks[0].sum())} px taken)")
    dm.assignment = fused

    out = {"fusion_E": es[-1]}
    for schedule in ("checkerboard", "banded"):
        out[schedule] = _simultaneous(dm, proposals, schedule, sweeps,
                                      "ncc_teddy")
    return out


def _same_segment_edges(labels):
    """[2, ...] booleans: does each pixel share a segment with its right
    resp. lower neighbour (what the smoothness weights read)."""
    return (labels[:, 1:] == labels[:, :-1]).ravel(), \
        (labels[1:, :] == labels[:-1, :]).ravel()


def _mean_shift_reference(images, opts) -> dict:
    """Mean-shift segmentation's device stages on the default device and on
    the CPU (the reference), from the same input: fractions of pixels whose
    LUV input and filtered modes differ, and of neighbour pairs whose
    same-segment flag (the smoothness-weight switch) differs after the
    shared native merge."""
    import jax
    import jax.numpy as jnp

    from stereo_tpu.proposals import segmentation

    im = np.asarray(jnp.clip(jnp.asarray(images[0]), 0, 255)).astype(
        np.uint8).astype(np.float64)
    h_s, h_r, min_reg = (int(opts.seg_params[0]), float(opts.seg_params[1]),
                         int(opts.seg_params[2]))

    def stages():
        luv = segmentation.rgb_to_luv(jnp.asarray(im, jnp.float32))
        modes = segmentation.mean_shift_filter(luv, h_s, h_r)
        return np.asarray(luv), np.asarray(modes, np.float32)

    luv_dev, dev = stages()
    with jax.default_device(jax.devices("cpu")[0]):
        luv_ref, ref = stages()
    edges_dev = _same_segment_edges(segmentation.connect_modes(dev, h_r,
                                                               min_reg))
    edges_ref = _same_segment_edges(segmentation.connect_modes(ref, h_r,
                                                               min_reg))
    n_edges = sum(e.size for e in edges_ref)
    return {
        "luv_px": float(np.mean(np.any(luv_dev != luv_ref, axis=-1))),
        "modes_px": float(np.mean(np.any(dev != ref, axis=-1))),
        # beyond float32 roundoff of the mode values (|LUV| <= ~200)
        "modes_px_moved": float(np.mean(
            np.max(np.abs(dev - ref), axis=-1) > 1e-3)),
        "modes_max_diff": float(np.max(np.abs(dev - ref))),
        "edges": sum(int(np.sum(a != b)) for a, b in
                     zip(edges_dev, edges_ref)) / n_edges,
    }


def phase_global_baby2(pair: str = "baby2", sweeps: int = GLOBAL_SWEEPS,
                       crop=None) -> dict:
    t0 = time.perf_counter()
    dm, images = build_global(pair, crop)
    H, W = dm.sz
    log(f"[global_baby2] {H}x{W} set-up (mean-shift + merge) "
        f"{time.perf_counter() - t0:.3f}s, E0={dm.energy():.9g}")

    t0 = time.perf_counter()
    ms = _mean_shift_reference(images, dm.options)
    log(f"[global_baby2] mean-shift vs the same stages on the CPU "
        f"({time.perf_counter() - t0:.3f}s): LUV input differs at "
        f"{ms['luv_px']:.6f} of pixels; filtered modes differ at "
        f"{ms['modes_px']:.6f} of pixels, beyond 1e-3 at "
        f"{ms['modes_px_moved']:.6f} (max |diff| {ms['modes_max_diff']:.3g}); "
        f"same-segment flags differ on {ms['edges']:.6f} of neighbour pairs")
    if ms["modes_px"]:
        log("[global_baby2]   why: the GPU compiler contracts a*b+c into "
            "FMAs and evaluates cbrt/division with other roundings than "
            "XLA:CPU, so values differ in their last bits; the filter's "
            "window tests (dsp < 1, dr < 1) are knife-edge comparisons, so "
            "a last-bit change can move a point in or out of a window and "
            "send its mode elsewhere")

    t0 = time.perf_counter()
    segplns = dm.segpln(seed=0)
    log(f"[global_baby2] {len(segplns)} SegPln proposals in "
        f"{time.perf_counter() - t0:.3f}s")
    check(len(segplns) == 14, f"expected 14 SegPln proposals, got "
          f"{len(segplns)}")

    e0 = dm.energy()
    t0 = time.perf_counter()
    n = dm.binary_fuse_until_convergence(segplns, seed=0)
    dt = time.perf_counter() - t0
    e1 = dm.energy()
    _check_trace("global_baby2", [e0, e1])
    log(f"[global_baby2] fusion to convergence: {n} fusions in {dt:.3f}s, "
        f"E {e0:.9g} -> {e1:.9g}")

    out = {"fusion_E": e1}
    for schedule in ("checkerboard", "banded"):
        out[schedule] = _simultaneous(dm, segplns, schedule, sweeps,
                                      "global_baby2")
    return out


def _compact_problem(K, H, W, seed):
    """A [K, H, W] problem in the compacted layout and one phase's kernel
    inputs (trws._compact_phase_args)."""
    import jax.numpy as jnp

    from stereo_tpu import geometry
    from stereo_tpu.ops import checker
    from stereo_tpu.solvers import trws

    rng = np.random.default_rng(seed)
    f = jnp.float32
    theta = rng.uniform(0, 5, (K, H, W))
    D0 = rng.uniform(0, 10, (K, H, W))
    Q = D0[None] + rng.normal(0, 0.4, (4, K, H, W))
    valid = jnp.stack([geometry.valid_mask(H, W, d, dtype=f)
                       for d in range(4)])
    alphas = jnp.asarray(rng.uniform(0.5, 2.0, (4, H, W)), f) * valid
    M = rng.normal(0, 1, (4, K, H, W))
    gamma = trws.node_gamma(H, W, f)
    ch = lambda a: (checker.compact_h(jnp.asarray(a, f), 0),  # noqa: E731
                    checker.compact_h(jnp.asarray(a, f), 1))
    theta2, D02, Q2, a2, v2, g2, M2 = map(
        ch, (theta, D0, Q, alphas, valid, gamma, M))
    pix = jnp.ones((H, W), f)
    pix2 = (checker.compact_h(pix, 0), checker.compact_h(pix, 1), H)
    args, _ = trws._compact_phase_args(theta2, M2, D02, Q2, a2, v2, g2, pix2,
                                       0, 1, 2.0, True)
    return args


def check_phase_kernel(K, H, W, seed=0, interpret=False) -> dict:
    """Triton phase kernel vs the plain XLA compacted phase on one
    half-iteration of a [K, H, W] problem.  The min-plus itself is exact;
    h + a*TR(.) may differ by FMA contraction, so the tolerance is 8 float32
    ulp of the largest magnitude entering the sum."""
    import jax

    from stereo_tpu.ops import phase_kernel
    from stereo_tpu.solvers import trws

    args = _compact_problem(K, H, W, seed)
    arrays, (tol, kern) = args[:-2], args[-2:]
    got = jax.jit(lambda *a: phase_kernel.phase_messages_compact(
        *a, tol, kern, interpret=interpret))(*arrays)
    want = jax.jit(lambda *a: trws._compact_messages_xla(*a, tol, kern))(
        *arrays)
    amax = lambda i: float(np.max(np.abs(np.asarray(arrays[i]))))  # noqa
    # |h| = |g - M| plus the largest pairwise term a * tol
    scale = max(amax(0), amax(1)) + max(amax(2), amax(3)) \
        + float(tol) * max(amax(8), amax(9))
    err = max(float(np.max(np.abs(np.asarray(g, np.float64)
                                  - np.asarray(w, np.float64))))
              for g, w in zip(got, want))
    ref = max(float(np.max(np.abs(np.asarray(w)))) for w in want)
    tolerance = 8 * EPS32 * scale
    return {"max_abs_err": err, "max_rel_err": err / ref,
            "tolerance": tolerance, "ok": err <= tolerance}


def check_send(K, L, seed=0) -> dict:
    """Banded send formulation (wavefront._send_head/_send_tail) vs a numpy
    float64 min-plus over K x K per lane; same tolerance rule."""
    import jax
    import jax.numpy as jnp

    from stereo_tpu.solvers import wavefront

    rng = np.random.default_rng(seed)
    f = np.float32
    gD = rng.normal(0, 3, (2, K, L)).astype(f)
    M = rng.normal(0, 1, (2, K, L)).astype(f)
    Q = rng.uniform(0, 10, (2, K, L)).astype(f)
    D0 = rng.uniform(0, 10, (1, K, L)).astype(f)
    alpha = rng.uniform(0.5, 2.0, (2, L)).astype(f)
    tol = 2.0
    out = {}
    for name, fn in (("send_head", wavefront._send_head),
                     ("send_tail", wavefront._send_tail)):
        msg, vmin = jax.jit(fn, static_argnums=(5, 6))(
            *map(jnp.asarray, (gD, M, Q, D0, alpha)), 1, tol)
        h = (gD - M).astype(np.float64)
        diff = (Q[:, :, None, :] - D0[:, None, :, :]) if name == \
            "send_head" else (Q[:, None, :, :] - D0[:, :, None, :])
        cost = alpha[:, None, None, :].astype(np.float64) * np.minimum(
            np.abs(diff.astype(np.float64)), tol)
        # send_head: target k_t (axis 1 of diff) over sources k_h (axis 2);
        # send_tail: target k_h over sources k_t — both reduce axis 2 after
        # putting the source axis there
        ref = np.min(h[:, None, :, :] + cost, axis=2)
        ref = ref - ref.min(axis=1, keepdims=True)
        err = float(np.max(np.abs(np.asarray(msg, np.float64) - ref)))
        scale = float(np.max(np.abs(h))) + tol * float(alpha.max())
        tolerance = 8 * EPS32 * scale
        out[name] = {"max_abs_err": err,
                     "max_rel_err": err / float(np.max(np.abs(ref))),
                     "tolerance": tolerance, "ok": err <= tolerance}
    return out


def phase_kernels(phase_sizes=((15, 370, 413), (79, 375, 450)),
                  send=(79, 1536), interpret=False) -> dict:
    out = {}
    for K, H, W in phase_sizes:
        r = check_phase_kernel(K, H, W, interpret=interpret)
        log(f"[kernels] phase K={K} {H}x{W} (float32): max abs err "
            f"{r['max_abs_err']:.3g}, max rel err {r['max_rel_err']:.3g}, "
            f"tolerance {r['tolerance']:.3g} (8 ulp of the sum's scale)")
        check(r["ok"], f"phase kernel K={K}: error {r['max_abs_err']} "
              f"above tolerance {r['tolerance']}")
        out[f"phase_K{K}"] = r
    K, L = send
    for name, r in check_send(K, L).items():
        log(f"[kernels] {name} K={K} L={L} (float32 vs float64 numpy): max "
            f"abs err {r['max_abs_err']:.3g}, max rel err "
            f"{r['max_rel_err']:.3g}, tolerance {r['tolerance']:.3g}")
        check(r["ok"], f"{name}: error {r['max_abs_err']} above tolerance "
              f"{r['tolerance']}")
        out[name] = r
    return out


def phase_multi(n_devices: int = 4):
    import __graft_entry__ as entry

    t0 = time.perf_counter()
    entry.dryrun_multichip(n_devices, H=375, W=450)
    log(f"[multi] {n_devices}-device paths label-checked against single "
        f"device in {time.perf_counter() - t0:.3f}s")


# -------------------------------------------------------------------- main
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the 4-device paths (needs 4 GPUs)")
    args = ap.parse_args(argv)

    t_all = time.perf_counter()
    device = phase_device()
    card = card_line()
    if args.multi:
        check(device["count"] >= 4, f"--multi needs 4 GPUs, have "
              f"{device['count']}")
        phase_multi(4)
    else:
        for name, fn in (("ncc_teddy", phase_ncc_teddy),
                         ("global_baby2", phase_global_baby2),
                         ("kernels", phase_kernels)):
            t0 = time.perf_counter()
            fn()
            log(f"[{name}] ok in {time.perf_counter() - t0:.3f}s")
    log(f"total {time.perf_counter() - t_all:.3f}s")
    log(f"card: {card}")
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
