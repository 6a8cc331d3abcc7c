"""Multi-host distribution helpers.

Same sharding annotations as parallel/mesh.py, but over a
jax.distributed-initialized global mesh: each process contributes its local
devices, the pixel grid's 'x' axis spans processes (halo exchanges are
NCCL collectives: NVLink within a host, the network across hosts), and
inputs are materialized per-process
with jax.make_array_from_callback so no host ever holds remote shards.

Validated by tests/multihost/run_pair.py: two CPU processes (4 virtual
devices each) solve the same problem as a single process — energies, bounds
and labels must match exactly.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from stereo_tpu.solvers import trws


def initialize(coordinator: str, num_processes: int, process_id: int):
    """jax.distributed init (call before any jax computation; the per-process
    CPU device count comes from xla_force_host_platform_device_count)."""
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_mesh(batch: int = 1) -> Mesh:
    """('batch', 'x') mesh over ALL processes' devices."""
    devices = np.asarray(jax.devices())
    n = devices.size
    if n % batch:
        raise ValueError(f"{n} global devices not divisible by batch={batch}")
    return Mesh(devices.reshape(batch, n // batch), ("batch", "x"))


def make_global(mesh: Mesh, spec: P, host_value: np.ndarray) -> jax.Array:
    """Build a mesh-sharded global array from a host-replicated numpy value.

    Every process holds the same full ``host_value`` (cheap for problem
    inputs) and contributes only its addressable shards.
    """
    sharding = NamedSharding(mesh, spec)

    def cb(index):
        return host_value[index]

    return jax.make_array_from_callback(host_value.shape, sharding, cb)


def sharded_solve_global(
    mesh: Mesh, unary, positions, nbr_positions, alphas, *, kernel, tol,
    maxiter=100, max_relgap=1e-4,
):
    """trws.solve over a (possibly multi-process) global mesh.

    Inputs are host numpy arrays replicated on every process.
    Returns the TRWSResult with fully-replicated outputs gathered locally
    (labels included), so every process can read them.
    """
    u = make_global(mesh, P(None, None, "x"), np.asarray(unary))
    d0 = make_global(mesh, P(None, None, "x"), np.asarray(positions))
    q = make_global(mesh, P(None, None, None, "x"), np.asarray(nbr_positions))
    al = make_global(mesh, P(None, None, "x"), np.asarray(alphas))

    out_specs = trws.TRWSResult(
        labels=NamedSharding(mesh, P()),  # replicate outputs for local reads
        energy=NamedSharding(mesh, P()),
        lower_bound=NamedSharding(mesh, P()),
        iterations=NamedSharding(mesh, P()),
        messages=NamedSharding(mesh, P(None, None, None, "x")),
    )

    def fn(u, d0, q, al):
        return trws.solve(u, d0, q, al, kernel=kernel, tol=tol,
                          maxiter=maxiter, max_relgap=max_relgap)

    with mesh:
        res = jax.jit(fn, out_shardings=out_specs)(u, d0, q, al)
    return res


def sharded_banded_global(unary, positions, nbr_positions, alphas, *, kernel,
                          tol, Bh, Bw, sweeps, decode_every=None):
    """banded_dist.sharded_banded_run over ALL processes' devices.

    gy stripes span processes: the per-step seam-slab ppermutes ride NVLink
    within a host and the network across hosts.  Inputs are host numpy arrays
    replicated on every process; rows are pre-padded host-side so the
    solver's internal padding is a no-op on global arrays.  Labels are
    allgathered so every process can read the full field.
    """
    from jax.experimental import multihost_utils

    from stereo_tpu.solvers import banded_dist

    devices = np.asarray(jax.devices())
    mesh = Mesh(devices, ("y",))
    K, H, W = np.asarray(unary).shape
    Gy = -(-H // Bh)
    Hp = Gy * Bh

    def padH(a):
        pads = [(0, 0)] * (a.ndim - 2) + [(0, Hp - H), (0, 0)]
        return np.pad(np.asarray(a), pads)

    u = make_global(mesh, P(None, "y", None), padH(unary))
    d0 = make_global(mesh, P(None, "y", None), padH(positions))
    q = make_global(mesh, P(None, None, "y", None), padH(nbr_positions))
    al = make_global(mesh, P(None, "y", None), padH(alphas))
    msgs = make_global(mesh, P(None, None, "y", None),
                       np.zeros((4, K, Hp, W), np.asarray(unary).dtype))
    res = banded_dist.sharded_banded_run(
        mesh, u, d0, q, al, kernel=kernel, tol=tol, Bh=Bh, Bw=Bw,
        sweeps=sweeps, decode_every=decode_every, messages=msgs)
    labels = multihost_utils.process_allgather(res.labels, tiled=True)
    return labels[..., :H, :], float(res.energy), float(res.lower_bound)
