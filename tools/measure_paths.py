"""Measure the alternatives the GPU port chose between, on one card.

Each part prints one JSON line; run them all (the default) or name some:

  kernel   Triton phase kernel vs the XLA compacted phase, one half-iteration
           at real widths (baby2 K=15, teddy K=79): error and time.
  sweep    TRWSRun sweeps for the three checkerboard paths (Triton compact,
           XLA compact, XLA full grid) at both sizes.
  accept   teddy NCC fusion sweep (78 moves) with accept_components' 'sort'
           and 'scatter' methods; take-masks of a repeated move compared.
  banded   the banded scan path at B=128: time per sweep, device operations
           per sweep from a profiler trace, and the compiled step's
           temporary memory against a [K, K, L] send intermediate.
  fusion   end to end through the models: checkerboard simultaneous fusion
           of a fixed number of sweeps on the real teddy NCC (K=79) and
           baby2 SegPln (K=15) problems, Triton compact vs XLA compact vs
           XLA full grid, in turns.
  send     the compiled K=79 banded chunk's HLO: fusions whose result holds
           a K x K per-lane buffer.

Usage: python tools/measure_paths.py [part ...] [--out DIR]
Requires a GPU; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SIZES = {"baby2": (15, 370, 413), "teddy": (79, 375, 450)}


def emit(**kw):
    print(json.dumps(kw), flush=True)


def synthetic(K, H, W, seed=0):
    import jax.numpy as jnp
    from stereo_tpu import geometry

    rng = np.random.default_rng(seed)
    f = np.float32
    theta = rng.uniform(0, 5, (K, H, W)).astype(f)
    D0 = rng.uniform(0, 10, (K, H, W)).astype(f)
    Q = (D0[None] + rng.normal(0, 0.4, (4, K, H, W))).astype(f)
    valid = np.stack([np.asarray(geometry.valid_mask(H, W, d)) for d in
                      range(4)]).astype(f)
    alphas = (rng.uniform(0.5, 2.0, (4, H, W)) * valid).astype(f)
    return tuple(map(jnp.asarray, (theta, D0, Q, alphas)))


def timed(fn, reps):
    import jax

    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2]


def part_kernel():
    import jax

    from chip_smoke import _compact_problem
    from stereo_tpu.ops import phase_kernel
    from stereo_tpu.solvers import trws

    for name, (K, H, W) in SIZES.items():
        args = _compact_problem(K, H, W, seed=0)
        arrays, (tol, kern) = args[:-2], args[-2:]
        k_fn = jax.jit(lambda *a: phase_kernel.phase_messages_compact(
            *a, tol, kern))
        x_fn = jax.jit(lambda *a: trws._compact_messages_xla(*a, tol, kern))
        t0 = time.perf_counter()
        got = jax.block_until_ready(k_fn(*arrays))
        t_ck = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = jax.block_until_ready(x_fn(*arrays))
        t_cx = time.perf_counter() - t0
        errs = []
        for g, w in zip(got, want):
            g, w = np.asarray(g), np.asarray(w)
            errs.append((float(np.max(np.abs(g - w))),
                         float(np.max(np.abs(w)))))
        emit(part="kernel", cell=name, K=K, H=H, W=W,
             max_abs_err=max(e for e, _ in errs),
             max_abs_ref=max(m for _, m in errs),
             compile_s_kernel=t_ck, compile_s_xla=t_cx,
             ms_kernel=timed(lambda: k_fn(*arrays), 10) * 1e3,
             ms_xla=timed(lambda: x_fn(*arrays), 10) * 1e3)


def part_sweep(sweeps):
    import jax
    from stereo_tpu.solvers import trws

    enabled = trws._phase_kernel_enabled
    for name, (K, H, W) in SIZES.items():
        theta, D0, Q, alphas = synthetic(K, H, W)
        n = sweeps[name]
        for path in ("triton_compact", "xla_compact", "xla_full"):
            trws._phase_kernel_enabled = (
                enabled if path == "triton_compact" else (lambda: False))
            r = trws.TRWSRun(theta, D0, Q, alphas, kernel=1, tol=2.0,
                             compact=path != "xla_full")
            t0 = time.perf_counter()
            st, e, lb, _ = r.run(r.init_state(), n, n)
            jax.block_until_ready(e)
            t_first = time.perf_counter() - t0
            ts = []
            for _ in range(3):
                st = r.init_state()
                t0 = time.perf_counter()
                st, e, lb, _ = r.run(st, n, n)
                jax.block_until_ready(e)
                ts.append(time.perf_counter() - t0)
            emit(part="sweep", cell=name, K=K, path=path, sweeps=n,
                 first_call_s=t_first, ms_per_sweep=min(ts) / n * 1e3,
                 samples_s=ts, energy=float(e), lb=float(lb))
    trws._phase_kernel_enabled = enabled


def teddy_ncc():
    from chip_smoke import build_ncc

    return build_ncc()


def part_accept():
    import functools

    import jax
    import jax.numpy as jnp
    from stereo_tpu.solvers import binary

    dm, props = teddy_ncc()
    start = dm.assignment
    orig = binary.accept_components
    for method in ("sort", "scatter", "sort", "scatter"):
        binary.accept_components = functools.partial(orig, method=method)
        jax.clear_caches()
        dm.assignment = start
        t0 = time.perf_counter()
        es = dm.binary_fusion_sweep(props, chunk=len(props))
        t_first = time.perf_counter() - t0
        dm.assignment = start
        t0 = time.perf_counter()
        es2 = dm.binary_fusion_sweep(props, chunk=len(props))
        dt = time.perf_counter() - t0
        # repeated move: the same decoded mask accepted twice
        fn = jax.jit(lambda z, t0_, t1_, V: binary.accept_components(
            z, t0_, t1_, V))
        rng = np.random.default_rng(3)
        H, W = dm.sz
        z = jnp.asarray(rng.random((H, W)) < 0.5)
        t0_ = jnp.asarray(rng.normal(0, 1, (H, W)), jnp.float32)
        t1_ = jnp.asarray(rng.normal(0, 1, (H, W)), jnp.float32)
        V = jnp.asarray(rng.normal(0, 1, (4, 2, 2, H, W)), jnp.float32)
        masks = [np.asarray(fn(z, t0_, t1_, V)) for _ in range(5)]
        same = all(np.array_equal(masks[0], m) for m in masks[1:])
        emit(part="accept", method=method, moves=len(props),
             first_call_s=t_first, sweep_s=dt, moves_per_s=len(props) / dt,
             final_energy=es2[-1], same_as_first_run=es == es2,
             repeated_move_identical=same)
    binary.accept_components = orig


def baby2_global():
    from chip_smoke import build_global

    dm, _ = build_global()
    return dm, dm.segpln(seed=0)


def part_fusion(sweeps):
    import functools

    import jax
    from stereo_tpu.solvers import trws

    enabled, solve = trws._phase_kernel_enabled, trws.solve
    paths = {
        "triton_compact": (enabled, solve),
        "xla_compact": (lambda: False, solve),
        "xla_full": (lambda: False, functools.partial(solve, compact=False)),
    }
    for name, build in (("baby2", baby2_global), ("teddy", teddy_ncc)):
        dm, props = build()
        dm.schedule, dm.maxiter, dm.max_relgap = "checkerboard", \
            sweeps[name], 0.0
        order = ["triton_compact", "xla_compact", "xla_full",
                 "xla_full", "xla_compact", "triton_compact"]
        for i, path in enumerate(order):
            trws._phase_kernel_enabled, trws.solve = paths[path]
            if i == 0 or order[i - 1] != path:
                # the jitted step caches one trace per static signature:
                # drop it so the patched path is traced afresh
                jax.clear_caches()
                dm.restart()
                t0 = time.perf_counter()
                dm.simultaneous_fusion(props)
                t_first = time.perf_counter() - t0
            dm.restart()
            t0 = time.perf_counter()
            e, lb, iters = dm.simultaneous_fusion(props)
            dt = time.perf_counter() - t0
            emit(part="fusion", cell=name, K=len(props) + 1, path=path,
                 sweeps=iters, first_call_s=t_first, wall_s=dt,
                 ms_per_sweep=dt / iters * 1e3, energy=e, lb=lb)
    trws._phase_kernel_enabled, trws.solve = enabled, solve


def part_send():
    import re

    from stereo_tpu.solvers import banded

    K, H, W = SIZES["teddy"]
    theta, D0, Q, alphas = synthetic(K, H, W)
    r = banded.BandedRun(theta, D0, Q, alphas, kernel=1, tol=2.0, Bh=128,
                         Bw=128)
    st, e, _, _ = r.run(r.init_state(), 1, 1)
    fn = r._chunk_cache[(1, 1, "banded")]
    compiled = fn.lower(r.bp.tree(), None, r.init_state()).compile()
    text = compiled.as_text()
    kk = re.compile(rf"\b{K},{K},")
    big = [ln.strip()[:160] for ln in text.splitlines()
           if " fusion(" in ln and "=" in ln
           and kk.search(ln.split("=", 1)[1].split("fusion(")[0])]
    mem = compiled.memory_analysis()
    emit(part="send", K=K, lanes=r.spec.L,
         fusions_with_kxk_result=len(big), examples=big[:4],
         temp_bytes=getattr(mem, "temp_size_in_bytes", None))


def count_device_ops(trace_dir):
    import jax

    paths = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                      recursive=True)
    pd = jax.profiler.ProfileData.from_file(sorted(paths)[-1])
    lines, names = {}, {}
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            n, busy = lines.get(line.name, (0, 0.0))
            for ev in line.events:
                n += 1
                busy += ev.duration_ns
                if line.name.startswith("Stream"):
                    names[ev.name] = names.get(ev.name, 0) + 1
            lines[line.name] = (n, busy)
    top = sorted(names.items(), key=lambda kv: -kv[1])[:8]
    return lines, top


def part_banded(out_dir, sweeps):
    import jax
    from stereo_tpu.solvers import banded

    for name, (K, H, W) in SIZES.items():
        theta, D0, Q, alphas = synthetic(K, H, W)
        r = banded.BandedRun(theta, D0, Q, alphas, kernel=1, tol=2.0,
                             Bh=128, Bw=128)
        n = sweeps[name]
        t0 = time.perf_counter()
        st, e, _, _ = r.run(r.init_state(), n, n)
        jax.block_until_ready(e)
        t_first = time.perf_counter() - t0
        ts = []
        for _ in range(3):
            st = r.init_state()
            t0 = time.perf_counter()
            st, e, lb, _ = r.run(st, n, n)
            jax.block_until_ready(e)
            ts.append(time.perf_counter() - t0)
        fn = r._chunk_cache[(n, n, "banded")]
        mem = fn.lower(r.bp.tree(), None, r.init_state()).compile() \
            .memory_analysis()
        L = r.spec.L
        trace_dir = os.path.join(out_dir, f"trace_banded_{name}")
        st = r.init_state()
        jax.block_until_ready(r.run(st, n, n)[1])
        st = r.init_state()
        with jax.profiler.trace(trace_dir):
            jax.block_until_ready(r.run(st, n, n)[1])
        lines, top = count_device_ops(trace_dir)
        emit(part="banded", cell=name, K=K, B=128, sweeps=n,
             first_call_s=t_first, ms_per_sweep=min(ts) / n * 1e3,
             samples_s=ts,
             trace_lines={k: {"events_per_sweep": v[0] / n,
                              "busy_ms_per_sweep": v[1] / n / 1e6}
                          for k, v in lines.items()},
             temp_bytes=getattr(mem, "temp_size_in_bytes", None),
             kkl_send_bytes=2 * K * K * L * 4, lanes=L, top_ops=top)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("parts", nargs="*",
                    default=["kernel", "sweep", "accept", "banded"])
    ap.add_argument("--out", default="chiprun_out")
    args = ap.parse_args()

    import jax

    from stereo_tpu.utils import compile_cache

    compile_cache.enable()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"no GPU: JAX reports {dev.platform}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    emit(part="device", kind=dev.device_kind, smi=smi.strip(),
         jax=jax.__version__)
    os.makedirs(args.out, exist_ok=True)
    for part in args.parts:
        t0 = time.perf_counter()
        if part == "kernel":
            part_kernel()
        elif part == "sweep":
            part_sweep({"baby2": 100, "teddy": 20})
        elif part == "accept":
            part_accept()
        elif part == "banded":
            part_banded(args.out, {"baby2": 20, "teddy": 4})
        elif part == "fusion":
            part_fusion({"baby2": 304, "teddy": 104})
        elif part == "send":
            part_send()
        else:
            sys.exit(f"unknown part {part!r}")
        emit(part=part, wall_s=time.perf_counter() - t0)


if __name__ == "__main__":
    main()
