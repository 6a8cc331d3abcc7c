"""Device-mesh distribution of the fusion solvers.

The reference is a single MATLAB process (SURVEY §2.4); the scaling axis here
is *spatial partitioning* of the pixel grid (the sequence-parallel analog) plus
*batch partitioning* over stereo pairs (data parallel).  Design:

- a 2-D mesh ('batch', 'x'): stereo pairs over 'batch', image columns over 'x';
- fields are annotated with NamedSharding; every solver op is either
  elementwise, a static shift (jnp.roll -> XLA CollectivePermute of the 1-px
  halo, an NCCL send/receive between GPUs), a windowed reduction (halo exchange likewise), or a full
  reduction (psum tree) — so XLA's SPMD partitioner derives exactly the
  halo-exchange program the survey's plan calls for, and the result is
  *bitwise identical* to the single-device program (same fixed point, same
  iteration count).
- multi-host: the same annotations over a jax.distributed-initialized global
  mesh; NCCL over NVLink inside a host and over the network across hosts.
  Every GPU reaches every other at the same rate, so the mesh follows the
  algorithm alone.

Convergence semantics are unchanged because the checkerboard TRW-S phases are
data-parallel by construction (no cross-pixel sequential dependency inside a
phase) — partitioning never reorders the math, it only places it.
"""

from __future__ import annotations

import functools
from typing import Any

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from stereo_tpu.solvers import trws


def make_mesh(n_devices: int | None = None, batch: int = 1,
              devices=None) -> Mesh:
    """Build a ('batch', 'x') mesh from the first n_devices devices."""
    devices = list(devices if devices is not None else jax.devices())
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    if n % batch != 0:
        raise ValueError(f"{n} devices not divisible by batch={batch}")
    arr = np.asarray(devices).reshape(batch, n // batch)
    return Mesh(arr, ("batch", "x"))


def field_specs(batched: bool):
    """PartitionSpecs for solver fields; columns sharded over 'x'.

    unary/positions [.., K, H, W]: shard W; messages [4, K, H, W] likewise.
    With ``batched`` a leading stereo-pair axis maps to 'batch'.
    """
    b = ("batch",) if batched else ()
    return dict(
        unary=P(*b, None, None, "x"),
        positions=P(*b, None, None, "x"),
        nbr_positions=P(*b, None, None, None, "x"),
        alphas=P(*b, None, None, "x"),
        labels=P(*b, None, "x"),
        scalar=P(),
    )


def sharded_solve(
    mesh: Mesh,
    unary: jax.Array,
    positions: jax.Array,
    nbr_positions: jax.Array,
    alphas: jax.Array,
    *,
    kernel: int,
    tol,
    maxiter: int = 1000,
    max_relgap: float = 1e-4,
    messages: jax.Array | None = None,
    check_every: int = 1,
    compact: bool = False,
):
    """TRW-S solve with fields sharded over the mesh's 'x' axis.

    Batched inputs (leading stereo-pair axis) are vmapped over 'batch'.
    ``messages`` warm-starts the dual state (e.g. carried across pooled
    chunks); ``check_every`` amortizes the decode.  ``compact`` runs the
    checkerboard-compacted sweeps (ops/checker.py); its rolls/selects shard
    like the standard path (the compaction is along H, the sharded axis is
    W).  On GPUs its message update is the Triton kernel, which has no SPMD
    partitioning rule of its own: XLA partitions around the call, and the
    result still matches the single-device labels.  Sharded-vs-single-device
    stays bitwise *for matching compact settings*.  Returns a TRWSResult with
    device-sharded members.
    """
    batched = unary.ndim == 4
    specs = field_specs(batched)
    x_size = int(mesh.devices.shape[-1])
    W = int(unary.shape[-1])
    if W % x_size != 0:
        raise ValueError(
            f"image width {W} not divisible by the mesh 'x' axis ({x_size}); "
            f"pick an 'x' size dividing W (zero-padding would break the "
            f"sharded == single-device bitwise invariant)")

    def put(x, spec):
        return jax.device_put(x, NamedSharding(mesh, spec))

    unary = put(unary, specs["unary"])
    positions = put(positions, specs["positions"])
    nbr_positions = put(nbr_positions, specs["nbr_positions"])
    alphas = put(alphas, specs["alphas"])
    msg_spec = P(*(("batch",) if batched else ()), None, None, None, "x")
    if messages is not None:
        messages = put(messages, msg_spec)

    def single(u, d0, q, al, msg):
        return trws.solve(u, d0, q, al, kernel=kernel, tol=tol,
                          maxiter=maxiter, max_relgap=max_relgap,
                          messages=msg, check_every=check_every,
                          compact=compact)

    base = jax.vmap(single) if batched else single
    if messages is None:
        fn = lambda u, d0, q, al: base(u, d0, q, al, None)  # noqa: E731
        if batched:
            fn = jax.vmap(lambda u, d0, q, al: single(u, d0, q, al, None))
    else:
        fn = base
    out_specs = trws.TRWSResult(
        labels=NamedSharding(mesh, specs["labels"]),
        energy=NamedSharding(mesh, P(*(("batch",) if batched else ()))),
        lower_bound=NamedSharding(mesh, P(*(("batch",) if batched else ()))),
        iterations=NamedSharding(mesh, P(*(("batch",) if batched else ()))),
        messages=NamedSharding(mesh, msg_spec),
    )
    with mesh:
        jitted = jax.jit(fn, out_shardings=out_specs)
        if messages is None:
            return jitted(unary, positions, nbr_positions, alphas)
        return jitted(unary, positions, nbr_positions, alphas, messages)
