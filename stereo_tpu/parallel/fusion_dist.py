"""Distributed binary fusion: fusion moves sharded over a device mesh.

The reference's flagship move generator is the QPBO binary fusion
(rd.m:3-21, cpp/rd_mex.cpp:55-100, dispmap_super.m:61-84) — a serial
pointer-machine maxflow.  The device solver (solvers/binary.py) replaced it
with a K=2 checkerboard TRW-S + per-component acceptance built entirely from
elementwise ops, static shifts, segmented associative scans, a stable sort,
and unique-index scatters.  That closure is what makes distribution *free of
hand-written merge logic*: annotate the [.., H, W] fields with a
NamedSharding that splits image columns over the mesh's 'x' axis and XLA's
SPMD partitioner derives the program —

- the K=2 message phases and the decode partition like the multi-label
  solver (shifts -> CollectivePermute halo exchange, NCCL between GPUs);
- the connected-component flood's shift-doubling segmented scans become
  log2(W) strided permutes, so components *crossing shard boundaries are
  merged by construction* — each doubling round extends min-id propagation
  across the cut exactly as it does within a shard (the "cross-shard CC
  merge" is not a separate algorithm, it is the same scan partitioned);
- the per-component verdicts run on the sorted segmented-scan path
  (accept_components method='sort'), whose combine tree is fixed by shape —
  partitioning places the ops but never reassociates them, so the segment
  sums and therefore the accepted take-mask are **bitwise identical** to the
  single-device move (pinned in tests/test_sharding.py).  Only the scalar
  energy/lower-bound reductions are reassociated (~1 ulp).

The never-increase invariant survives sharding unchanged: the unconditional
backstop in binary_fuse compares two global reductions of identical
per-pixel maps, and the take-mask it guards is bitwise-equal to the
single-device one.

The proposal-stream driver (_fusion_sweep's lax.scan) shards the same way:
the carry (assignment, unary, positions) keeps its column sharding across
moves, so a whole randomized-sweep chunk runs distributed with zero host
round-trips between moves.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from stereo_tpu import energy, geometry
from stereo_tpu.solvers import binary

__all__ = ["sharded_fusion_step", "sharded_fusion_sweep"]


def _check_width(mesh: Mesh, W: int, axis: str):
    x_size = int(mesh.shape[axis])
    if W % x_size != 0:
        raise ValueError(
            f"image width {W} not divisible by the mesh '{axis}' axis "
            f"({x_size}); pick a size dividing W (zero-padding would break "
            f"the sharded == single-device bitwise invariant)")


def _norm_fn(normalize):
    def norm(x):
        if normalize is None:
            return x
        return (x - normalize[0]) / normalize[1]
    return norm


def _problem_of(planes, normalize):
    norm = _norm_fn(normalize)
    D0 = norm(geometry.own_disparity(planes))
    Q = jnp.stack(
        [norm(geometry.neighbor_plane_disparity(planes, d, fill=0.0))
         for d in range(geometry.NUM_DIRS)], axis=0,
    )
    return D0, Q


def sharded_fusion_step(
    mesh: Mesh,
    current: jax.Array,  # [4, H, W] incumbent plane field
    proposal: jax.Array,  # [4, H, W]
    unary0: jax.Array,  # [H, W] unary of the incumbent
    unary1: jax.Array,  # [H, W] unary of the proposal
    weights: jax.Array,  # [4, H, W] smoothness weights
    *,
    kernel: int,
    tol,
    normalize=None,
    improve: int = 0,
    maxiter: int = 50,
    max_relgap: float = 1e-6,
    axis: str = "x",
):
    """One fusion move with every pixel-grid field sharded over ``axis``.

    Returns (fused_planes, take, energy, lower_bound) — ``take`` and the
    fused assignment bitwise-equal to the single-device
    models.base._binary_fusion_step at a fixed iteration budget (use
    max_relgap=0.0 for strict determinism of the iteration count: the
    relgap stopping rule compares a reassociated scalar).
    """
    _check_width(mesh, int(current.shape[-1]), axis)
    planes_s = NamedSharding(mesh, P(None, None, axis))
    field_s = NamedSharding(mesh, P(None, axis))
    scalar_s = NamedSharding(mesh, P())

    current = jax.device_put(current, planes_s)
    proposal = jax.device_put(proposal, planes_s)
    unary0 = jax.device_put(unary0, field_s)
    unary1 = jax.device_put(unary1, field_s)
    weights = jax.device_put(weights, planes_s)

    def fn(cur, prop, U0, U1, w):
        D0, Q = binary.fusion_problem(cur, prop, normalize)
        res = binary.binary_fuse(
            U0, U1, D0, Q, w, kernel=kernel, tol=tol, maxiter=maxiter,
            max_relgap=max_relgap, improve=improve, accept_method="sort")
        fused = energy.fuse_labelling(cur, prop, res.take)
        return fused, res.take, res.energy, res.lower_bound

    with mesh:
        jitted = jax.jit(fn, out_shardings=(planes_s, field_s, scalar_s,
                                            scalar_s))
        return jitted(current, proposal, unary0, unary1, weights)


def sharded_fusion_sweep(
    mesh: Mesh,
    current: jax.Array,  # [4, H, W]
    prop_stack: jax.Array,  # [P, 4, H, W]
    weights: jax.Array,  # [4, H, W]
    unary_p,  # traceable unary callable (jax.tree_util.Partial)
    *,
    kernel: int,
    tol,
    normalize=None,
    improve: int = 0,
    live: jax.Array | None = None,  # [P] bool: identity-mask padded moves
    maxiter: int = 50,
    max_relgap: float = 1e-6,
    axis: str = "x",
):
    """A whole proposal stream of fusion moves, distributed.

    The sharded mirror of models.base._fusion_sweep: a lax.scan over the
    proposal stack whose carry (assignment + incremental unary/positions)
    keeps its column sharding between moves.  Returns (fused, energies,
    lower_bounds) with ``fused`` sharded over ``axis``.
    """
    _check_width(mesh, int(current.shape[-1]), axis)
    planes_s = NamedSharding(mesh, P(None, None, axis))
    stack_s = NamedSharding(mesh, P(None, None, None, axis))
    vec_s = NamedSharding(mesh, P())

    current = jax.device_put(current, planes_s)
    prop_stack = jax.device_put(prop_stack, stack_s)
    weights = jax.device_put(weights, planes_s)
    if live is None:
        live = jnp.ones((prop_stack.shape[0],), bool)
    live = jax.device_put(live, vec_s)

    def fn(cur, props, w, alive):
        def step(carry, xs):
            prop, a = xs
            cur, U0, D0c, Qc = carry
            U1 = unary_p(prop)
            D0p, Qp = _problem_of(prop, normalize)
            D0 = jnp.stack([D0c, D0p], axis=0)
            Q = jnp.stack([Qc, Qp], axis=1)
            res = binary.binary_fuse(U0, U1, D0, Q, w, kernel=kernel,
                                     tol=tol, improve=improve,
                                     maxiter=maxiter,
                                     max_relgap=max_relgap,
                                     accept_method="sort")
            take = res.take & a
            cur = energy.fuse_labelling(cur, prop, take)
            U0n = jnp.where(take, U1, U0)
            D0n = jnp.where(take, D0p, D0c)
            Qn = jnp.stack(
                [jnp.where(
                    geometry.shift_from_neighbor(take, d, fill=False),
                    Qp[d], Qc[d])
                 for d in range(geometry.NUM_DIRS)], axis=0,
            )
            return (cur, U0n, D0n, Qn), (res.energy, res.lower_bound)

        U0 = unary_p(cur)
        D0c, Qc = _problem_of(cur, normalize)
        (fused, _, _, _), (es, lbs) = jax.lax.scan(
            step, (cur, U0, D0c, Qc), (props, alive))
        return fused, es, lbs

    with mesh:
        jitted = jax.jit(fn, out_shardings=(planes_s, vec_s, vec_s))
        return jitted(current, prop_stack, weights, live)
