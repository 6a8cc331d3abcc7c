"""Model base: plane-label state + fusion drivers.

The array-program counterpart of dispmap_super.m: owns the plane-label field
[4, H, W], the per-direction smoothness weight maps [4, H, W], the cached
energy, and the two fusion drivers (binary_fusion / binary_fuse_until
convergence, dispmap_super.m:61-152; simultaneous_fusion :153-198).

Functional core / stateful shell: all device work happens in jitted functions
keyed by static (kernel, K, shapes); the class only sequences them and holds
HBM-resident state, so repeated fusions reuse one compiled program and the
label field never leaves the device.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from stereo_tpu import energy, geometry
from stereo_tpu.solvers import binary, trws
from stereo_tpu.utils.profiling import PhaseTimings


class DispMap:
    """Abstract base; subclasses provide ``unary_map`` and ``tol``."""

    # optional (d_min, d_step) disparity normalization applied inside all
    # pairwise terms (dispmap_globalstereo.m:336-345)
    normalize: tuple | None = None

    def __init__(self, images, kernel: int, *, maxiter: int = 1000,
                 max_relgap: float = 1e-4, improve: bool = False,
                 check_every: int = 8, schedule: str = "checkerboard",
                 fusion_backend: str = "device"):
        self.images = [jnp.asarray(im) for im in images]
        H, W = self.images[0].shape[:2]
        self.sz = (H, W)
        if kernel not in (1, 2):
            raise ValueError("Unknown kernel type")
        self.smoothness_kernel = kernel
        self.maxiter = maxiter
        self.max_relgap = max_relgap
        self.improve = improve
        # stopping-rule stride: decode/convergence-test every N TRW-S sweeps
        # (pure scheduling; the message math is unchanged)
        self.check_every = check_every
        # TRW-S sweep schedule: 'checkerboard' (max parallel), 'scanline'
        # (row-sequential chains), 'wavefront' (exact raster order via
        # anti-diagonals), or 'banded' (blocked wavefront, solvers/banded.py
        # — the fastest time-to-host-energy schedule; block size =
        # ``self.band``)
        if schedule not in ("checkerboard", "scanline", "wavefront",
                            "banded"):
            raise ValueError(f"unknown schedule {schedule!r}")
        self.schedule = schedule
        self.band = 128  # banded-schedule block size (Bh = Bw)
        # binary-fusion solver: 'device' (K=2 TRW-S + per-component
        # acceptance) or 'host' (exact QPBO roof duality through the native
        # lib — the bit-faithful rd_mex path, honoring ``improve``)
        if fusion_backend not in ("device", "host"):
            raise ValueError(f"unknown fusion backend {fusion_backend!r}")
        self.fusion_backend = fusion_backend
        self._edge_cache = None
        self.dtype = self.images[0].dtype
        self.smooth_weights = energy.default_weights(H, W, dtype=self.dtype)
        self._assignment = None
        self._stored_energy = float("inf")
        # cumulative per-phase wall clock (the info.timings equivalent,
        # ojw_stereo_optim.m:57-58)
        self.timings = PhaseTimings()

    # ------------------------------------------------------------- state
    @property
    def assignment(self) -> jax.Array:
        return self._assignment

    @assignment.setter
    def assignment(self, planes):
        self._assignment = jnp.asarray(planes, self.dtype)
        self._update_energy()

    def energy(self) -> float:
        return self._stored_energy

    def _update_energy(self):
        e = _total_energy(
            self._assignment, self.smooth_weights,
            self.unary_map(self._assignment),
            self.smoothness_kernel, self.tol, self.normalize,
        )
        self._stored_energy = float(e)

    # ---------------------------------------------------------- abstract
    def unary_map(self, planes: jax.Array) -> jax.Array:
        """Per-pixel unary cost of a plane field. [4,H,W] -> [H,W]."""
        raise NotImplementedError

    # ------------------------------------------------------------ fusion
    def binary_fusion(self, proposal) -> tuple[float, float]:
        """One fusion move (dispmap_super.m:61-84). Never increases energy.

        Returns (energy, lower_bound).
        """
        proposal = jnp.asarray(proposal, self.dtype)
        if proposal.shape != self._assignment.shape:
            raise ValueError("Binary fusion: proposal is of wrong size")
        if self.fusion_backend == "host":
            return self._binary_fusion_host(proposal)
        with self.timings.phase("binary_fusion"):
            fused, e, lb = _binary_fusion_step(
                self._assignment, proposal,
                self.unary_map(self._assignment), self.unary_map(proposal),
                self.smooth_weights, self.smoothness_kernel, self.tol,
                self.normalize, 4 if self.improve else 0,
            )
            jax.block_until_ready(e)
        self._assignment = fused
        self._stored_energy = float(e)
        return self._stored_energy, float(lb)

    def _edge_lists(self):
        """Directed edge lists (tails, heads, per-direction masks + weights)
        for the host QPBO path; cached (the weights are move-invariant)."""
        if self._edge_cache is None:
            H, W = self.sz
            w = np.asarray(self.smooth_weights, np.float64)
            nid = np.arange(H * W).reshape(H, W)
            tails, heads, wts, sel = [], [], [], []
            for d, (dy, dx) in enumerate(geometry.DIRS):
                ys, xs = np.nonzero(w[d] > 0)
                tails.append(nid[ys + dy, xs + dx])
                heads.append(nid[ys, xs])
                wts.append(w[d, ys, xs])
                sel.append((d, ys, xs))
            self._edge_cache = (
                np.concatenate(tails).astype(np.int32),
                np.concatenate(heads).astype(np.int32),
                wts, sel,
            )
        return self._edge_cache

    def _binary_fusion_host(self, proposal) -> tuple[float, float]:
        """Exact QPBO fusion on the host — the rd.m/rd_mex path: weak
        persistency + keep-current on unlabelled, QPBO-I when unlabelled
        remain and ``improve`` is set (rd_mex.cpp:68-92)."""
        from stereo_tpu.solvers import qpbo_host

        with self.timings.phase("binary_fusion"):
            H, W = self.sz
            cur = self._assignment
            tables = np.asarray(
                energy.binary_fusion_pairwise_tables(
                    cur, proposal, self.smoothness_kernel, self.tol,
                    self.normalize),
                np.float64)
            tails, heads, wts, sel = self._edge_lists()
            E = [np.concatenate([wts[i] * tables[d, t, ys, xs]
                                 for i, (d, ys, xs) in enumerate(sel)])
                 for t in range(4)]
            U0 = np.asarray(self.unary_map(cur), np.float64).ravel()
            U1 = np.asarray(self.unary_map(proposal), np.float64).ravel()
            labels, e, lb, n_unlab = qpbo_host.solve(
                U0, U1, tails, heads, *E)
            y = np.where(labels >= 0, labels, 0)
            if n_unlab > 0 and self.improve:
                y, e = qpbo_host.improve(labels, U0, U1, tails, heads, *E)
            take = jnp.asarray((y == 1).reshape(H, W))
        self._assignment = energy.fuse_labelling(cur, proposal, take)
        self._update_energy()
        return self._stored_energy, float(lb)

    def binary_fusion_sweep(self, proposals, chunk: int = 64) -> list[float]:
        """Fuse a whole proposal stream in one device program per chunk.

        Identical math to calling binary_fusion per proposal, but the
        proposal loop is a lax.scan: no host round-trips between moves
        (the reference pays a full MATLAB<->mex marshalling per rd call,
        rd.m:21).  Returns the per-move energy trace.
        """
        unary_p = self.unary_partial()
        energies = []
        for c0 in range(0, len(proposals), chunk):
            stack = jnp.stack(
                [jnp.asarray(p, self.dtype) for p in proposals[c0:c0 + chunk]], 0
            )
            with self.timings.phase("binary_fusion_sweep"):
                fused, es, lbs = _fusion_sweep(
                    self._assignment, stack, self.smooth_weights,
                    self.smoothness_kernel, self.tol, self.normalize, unary_p,
                    improve=4 if self.improve else 0,
                )
                jax.block_until_ready(es)
            self._assignment = fused
            energies.extend(float(e) for e in np.asarray(es))
        self._stored_energy = energies[-1] if energies else self.energy()
        return energies

    def unary_partial(self):
        """Traceable unary callable (jax.tree_util.Partial); see subclasses."""
        raise NotImplementedError

    def binary_fuse_until_convergence(self, proposals, seed: int = 0,
                                      verbose: bool = False,
                                      chunk: int = 32) -> int:
        """Randomized sweep until no proposal improves the energy
        (dispmap_super.m:85-152).  Deterministic given ``seed`` (the
        reference's MATLAB rand stream is replaced by an explicit PRNG).

        Device-backend moves run ``chunk`` at a time through the jitted
        _fusion_sweep scan (the binary_fusion_sweep fast path: no host
        round-trips between moves).  The visited-set bookkeeping is applied
        post-hoc from the chunk's energy trace, so skip decisions use
        chunk-start knowledge: a proposal whose earlier in-chunk twin already
        fused may be re-fused, and one visited mid-chunk is not retried
        until the next sweep.  The result is therefore *heuristically*
        equivalent to the per-move driver — energy-monotone (every move goes
        through binary_fuse's never-increase guard), same stopping criterion
        (no unvisited proposal improves) — but the exact move sequence, the
        iteration count, and near-tie labelings can differ from running the
        moves one at a time.  Chunk padding uses live-masked identity steps
        (see _fusion_sweep), so padded entries never touch the assignment.
        """
        n = len(proposals)
        rng = np.random.default_rng(seed)
        ids = np.concatenate([np.arange(n), rng.integers(0, n, self.maxiter * 5)])
        keep = np.ones(len(ids), dtype=bool)
        keep[1:] = np.diff(ids) != 0  # drop immediate repeats
        ids = ids[keep]

        visited = np.zeros(n, dtype=bool)
        energies = [self.energy()]

        if self.fusion_backend == "host":
            # exact QPBO path (honors ``improve``): per-move host solves
            for it in range(min(self.maxiter, len(ids))):
                pid = int(ids[it])
                if visited[pid]:
                    continue
                self.binary_fusion(proposals[pid])
                energies.append(self.energy())
                if energies[-1] != energies[-2]:
                    visited[:] = False
                else:
                    visited[pid] = True
                if verbose:
                    print(f"fuse #{it} proposal {pid}: E = {energies[-1]:.6g}")
                if visited.all():
                    break
            return len(energies)

        unary_p = self.unary_partial()
        stack_all = jnp.stack(
            [jnp.asarray(p, self.dtype) for p in proposals], 0)
        chunk = min(chunk, max(8, n))
        pos = 0
        moves = 0
        while (moves < self.maxiter and pos < len(ids)
               and not visited.all()):
            batch = []
            while pos < len(ids) and len(batch) < min(chunk,
                                                      self.maxiter - moves):
                pid = int(ids[pos])
                pos += 1
                if not visited[pid]:
                    batch.append(pid)
            if not batch:
                continue
            moves += len(batch)
            n_live = len(batch)
            # pad to the compiled chunk shape; padded entries are live=False
            # identity steps inside _fusion_sweep (take forced empty), so
            # they provably cannot touch the assignment
            batch += [batch[-1]] * (chunk - n_live)
            sub = stack_all[jnp.asarray(batch)]
            live = jnp.arange(chunk) < n_live
            with self.timings.phase("binary_fusion_sweep"):
                fused, es, _ = _fusion_sweep(
                    self._assignment, sub, self.smooth_weights,
                    self.smoothness_kernel, self.tol, self.normalize,
                    unary_p, live=live,
                    improve=4 if self.improve else 0)
                jax.block_until_ready(es)
            self._assignment = fused
            es = np.asarray(es, np.float64)
            for i in range(n_live):
                pid = batch[i]
                energies.append(float(es[i]))
                if energies[-1] != energies[-2]:
                    visited[:] = False
                else:
                    visited[pid] = True
                if verbose:
                    print(f"fuse proposal {pid}: E = {energies[-1]:.6g}")
        self._stored_energy = energies[-1]
        return len(energies)

    # device executions are chunked so no single XLA invocation runs for
    # minutes (long single executions can trip device watchdogs); messages
    # warm-start across chunks, so the trajectory is identical.  Scanline
    # and wavefront sweeps run H resp. H+W sequential steps, hence the
    # smaller chunks.
    solver_chunk: int = 300  # ~60s worst case at K~80 baby2 scale
    solver_chunk_scanline: int = 50
    solver_chunk_wavefront: int = 150
    solver_chunk_banded: int = 400

    def simultaneous_fusion(self, proposals, verbose: bool = False,
                            trace=None) -> tuple[float, float, int]:
        """Fuse all proposals at once with TRW-S (dispmap_super.m:153-198).

        The incumbent assignment joins as the last label (:158).
        Returns (energy, lower_bound, iterations).
        """
        all_props = [jnp.asarray(p, self.dtype) for p in proposals]
        all_props.append(self._assignment)
        stack = jnp.stack(all_props, axis=0)  # [K, 4, H, W]
        with self.timings.phase("data"):
            unary = jnp.stack([self.unary_map(p) for p in all_props], axis=0)
            jax.block_until_ready(unary)

        messages = None
        total_iters = 0
        lb = None
        # TRW-S greedy decodes oscillate around convergence (ROADMAP: banded
        # findings); keep the best labeling seen across chunk boundaries —
        # any decode is a feasible labeling, so reporting/applying the
        # incumbent is strictly no worse than the reference's keep-the-last
        # (dispmap_super.m:191-197)
        best_e = float("inf")
        best_labels = None
        chunk_size = {
            "scanline": self.solver_chunk_scanline,
            "wavefront": self.solver_chunk_wavefront,
            "banded": self.solver_chunk_banded,
        }.get(self.schedule, self.solver_chunk)
        while total_iters < self.maxiter:
            chunk = min(chunk_size, self.maxiter - total_iters)
            with self.timings.phase("simultaneous_fusion"):
                labels, e, lb, iters, messages = _simultaneous_fusion_step(
                    stack, unary, self.smooth_weights, self.smoothness_kernel,
                    self.tol, self.normalize, chunk, self.max_relgap,
                    self.check_every, messages, self.schedule, self.band,
                )
            total_iters += int(iters)
            ef, lbf = float(e), float(lb)
            if ef < best_e:
                best_e = ef
                best_labels = labels
            if trace is not None:
                trace.record(ef, lbf, iterations=total_iters)
            if verbose:
                print(f"  TRW-S iter {total_iters}: E = {ef:.6g}, "
                      f"lb = {lbf:.6g}, relgap = {(ef-lbf)/ef:.3g}")
            if ef != 0 and (ef - lbf) / ef < self.max_relgap:
                break
            if int(iters) < chunk:  # converged inside the chunk
                break

        self._assignment = jnp.take_along_axis(
            stack, best_labels[None, None, :, :].astype(jnp.int32), axis=0
        )[0]
        self._stored_energy = best_e
        return self._stored_energy, float(lb), total_iters

    # ------------------------------------------------------------- views
    def current_dispmap(self) -> jax.Array:
        d = geometry.own_disparity(self._assignment)
        if self.normalize is not None:
            d = (d - self.normalize[0]) / self.normalize[1]
        return d

    def __repr__(self):
        H, W = self.sz
        return (
            f"{type(self).__name__}(size=({H},{W}), kernel={self.smoothness_kernel}, "
            f"energy={self._stored_energy:.6g}, maxiter={self.maxiter}, "
            f"max_relgap={self.max_relgap})"
        )


# ---------------------------------------------------------------- jitted core


@functools.partial(jax.jit, static_argnames=("kernel", "normalize"))
def _total_energy(planes, weights, unary, kernel, tol, normalize):
    return energy.total_energy(unary, planes, weights, kernel, tol, normalize)


@functools.partial(jax.jit, static_argnames=("kernel", "normalize", "improve"))
def _fusion_sweep(current, prop_stack, weights, kernel, tol, normalize, unary_p,
                  live=None, improve=0):
    """lax.scan of fusion moves over a [P, 4, H, W] proposal stack.

    The incumbent's unary and pairwise positions are carried incrementally:
    after a move they are pointwise merges of the two candidates' values
    (both models' unaries depend only on the pixel's own plane, and the
    positions only on one endpoint's plane), so each move evaluates the
    unary/geometry of the *proposal* only — the reference recomputes both
    sides per rd call (dispmap_super.m:70-74).

    ``live`` ([P] bool, default all-True) marks real moves; entries with
    live=False are guaranteed identities — the take-mask is forced empty so
    the carry passes through unchanged (chunk padding in
    binary_fuse_until_convergence relies on this).
    """

    def norm(x):
        if normalize is None:
            return x
        return (x - normalize[0]) / normalize[1]

    def problem_of(planes):
        D0 = norm(geometry.own_disparity(planes))
        Q = jnp.stack(
            [norm(geometry.neighbor_plane_disparity(planes, d, fill=0.0))
             for d in range(geometry.NUM_DIRS)], axis=0,
        )
        return D0, Q

    def step(carry, xs):
        prop, alive = xs
        cur, U0, D0c, Qc = carry
        U1 = unary_p(prop)
        D0p, Qp = problem_of(prop)
        D0 = jnp.stack([D0c, D0p], axis=0)  # [2, H, W]
        Q = jnp.stack([Qc, Qp], axis=1)  # [4, 2, H, W]
        res = binary.binary_fuse(U0, U1, D0, Q, weights, kernel=kernel,
                                 tol=tol, improve=improve)
        take = res.take & alive
        cur = energy.fuse_labelling(cur, prop, take)
        U0n = jnp.where(take, U1, U0)
        D0n = jnp.where(take, D0p, D0c)
        Qn = jnp.stack(
            [jnp.where(geometry.shift_from_neighbor(take, d, fill=False),
                       Qp[d], Qc[d])
             for d in range(geometry.NUM_DIRS)], axis=0,
        )
        return (cur, U0n, D0n, Qn), (res.energy, res.lower_bound)

    if live is None:
        live = jnp.ones((prop_stack.shape[0],), bool)
    U0 = unary_p(current)
    D0c, Qc = problem_of(current)
    (fused, _, _, _), (es, lbs) = jax.lax.scan(
        step, (current, U0, D0c, Qc), (prop_stack, live)
    )
    return fused, es, lbs


@functools.partial(jax.jit,
                   static_argnames=("kernel", "normalize", "improve"))
def _binary_fusion_step(current, proposal, U0, U1, weights, kernel, tol,
                        normalize, improve=0):
    D0, Q = binary.fusion_problem(current, proposal, normalize)
    res = binary.binary_fuse(U0, U1, D0, Q, weights, kernel=kernel, tol=tol,
                             improve=improve)
    fused = energy.fuse_labelling(current, proposal, res.take)
    return fused, res.energy, res.lower_bound


@functools.partial(
    jax.jit,
    static_argnames=("kernel", "normalize", "maxiter", "max_relgap",
                     "check_every", "schedule", "band"),
)
def _simultaneous_fusion_step(prop_stack, unary, weights, kernel, tol, normalize,
                              maxiter, max_relgap, check_every=1, messages=None,
                              schedule="checkerboard", band=128):
    def norm(x):
        if normalize is None:
            return x
        return (x - normalize[0]) / normalize[1]

    D0 = norm(jax.vmap(geometry.own_disparity)(prop_stack))  # [K, H, W]
    Q = jnp.stack(
        [
            norm(jax.vmap(lambda p: geometry.neighbor_plane_disparity(p, d, fill=0.0))(prop_stack))
            for d in range(geometry.NUM_DIRS)
        ],
        axis=0,
    )  # [4, K, H, W]
    extra = {}
    if schedule == "scanline":
        from stereo_tpu.solvers.scanline import solve_scanline as _solve
    elif schedule == "wavefront":
        from stereo_tpu.solvers.wavefront import solve_wavefront as _solve
    elif schedule == "banded":
        from stereo_tpu.solvers.banded import solve_banded as _solve

        H, W = unary.shape[-2:]
        extra = dict(Bh=max(2, min(band, H)), Bw=max(2, min(band, W)))
    else:
        _solve = trws.solve
    res = _solve(
        unary, D0, Q, weights, kernel=kernel, tol=tol, maxiter=maxiter,
        max_relgap=max_relgap, check_every=check_every, messages=messages,
        **extra,
    )
    return res.labels, res.energy, res.lower_bound, res.iterations, res.messages
