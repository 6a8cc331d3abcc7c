"""Wavefront (anti-diagonal) TRW-S: the reference's *raster ordering*, exactly,
data-parallel on the device.

The host/reference serial TRW-S (cpp/trw-s/minimize.cpp:31-116) processes
pixels in raster order; its monotonic chains span whole rows *and* whole
columns, so the lower bound converges in a few hundred sweeps where the
checkerboard ordering (solvers/trws.py) — whose chains are single edges —
needs far more.

Key observation: under raster order, pixel (y, x) depends only on (y, x-1)
and (y-1, x) — both on the previous anti-diagonal t-1 = y+x-1.  Two pixels on
the same anti-diagonal share no read/write buffers:

  (y, x) writes the in-buffers  M[LT] at (y, x+1)  and  M[UP] at (y+1, x)
  (both on diagonal t+1) plus its own M[RT]/M[DN]; the other diagonal-t pixel
  that touches (y, x+1) is (y-1, x+1), which writes M[UP] there — a different
  buffer.

So sweeping diagonals t = 0..H+W-2 with all of diagonal t updated in parallel
is *bitwise* the sequential raster sweep — the classic wavefront
parallelization of a scan.  This module implements it on *skewed* arrays
(S[y, t] = A[y, t-y], anti-diagonals become columns), stored *t-leading* so
every step touches contiguous [·, K, H] column slabs:

  - problem data:  theta/D0 [T+2, K, H], Q [T+2, 2, K, H] per direction
    group, alphas/vmask [T+2, 2, H], gamma/pix [T+2, H];
  - messages, split by the direction group each sweep direction *writes*:
      MA [T+2, 2, K, H] = (RT, DN)  — written at col c by the forward pass,
      MB [T+2, 2, K, H] = (LT, UP)  — written at col c by the backward pass,
    so both passes perform two full-slab column writes per step and no
    read-modify-write.

Exactness is pinned against tests/oracles.SequentialTRWS with the raster
order (tests/test_wavefront.py).

Message/edge conventions match solvers/trws.py: buffer M[d][k, y, x] holds the
message on edge E(p, d) = (tail = p + DIRS[d] -> head p), stored at the head;
potential V(k_t, k_h) = alpha_e * TR(|Q[d][k_t] - D0[k_h]|) with Q/D0/alpha
evaluated at the head pixel.  gamma(p) = 1/max(nFwd, nBwd)
(treeProbabilities.cpp:12-47): under raster order nFwd = 2·#(later nbrs),
nBwd = 2·#(earlier nbrs).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from stereo_tpu import geometry
from stereo_tpu.energy import truncated_kernel
from stereo_tpu.solvers.trws import TRWSResult

LT, RT, UP, DN = 0, 1, 2, 3
# direction groups: A = (RT, DN) — forward-pass writes; B = (LT, UP)
GROUP_A = (RT, DN)
GROUP_B = (LT, UP)


# ------------------------------------------------------------------ skewing
def skew(a: jax.Array, W: int) -> jax.Array:
    """[..., H, W] -> [..., H, T]: S[..., y, t] = A[..., y, t - y], zero
    where t - y is outside [0, W)."""
    H = a.shape[-2]
    T = H + W - 1
    y = jnp.arange(H)[:, None]
    t = jnp.arange(T)[None, :]
    x = t - y
    valid = (x >= 0) & (x < W)
    idx = jnp.clip(x, 0, W - 1)
    idx_b = jnp.broadcast_to(idx, a.shape[:-1] + (T,))
    out = jnp.take_along_axis(a, idx_b, axis=-1)
    return jnp.where(valid, out, jnp.zeros((), a.dtype))


def unskew(s: jax.Array, W: int) -> jax.Array:
    """Inverse of skew: [..., H, T] -> [..., H, W]."""
    H = s.shape[-2]
    y = jnp.arange(H)[:, None]
    x = jnp.arange(W)[None, :]
    idx = jnp.broadcast_to(x + y, s.shape[:-1] + (W,))
    return jnp.take_along_axis(s, idx, axis=-1)


def _tlead(a: jax.Array, W: int) -> jax.Array:
    """Skew the trailing [H, W] axes, pad one zero column each side, and move
    the t axis to the front: [..., H, W] -> [T+2, ..., H]."""
    s = skew(a, W)  # [..., H, T]
    s = jnp.pad(s, [(0, 0)] * (s.ndim - 1) + [(1, 1)])
    return jnp.moveaxis(s, -1, 0)


def _tlead_inv(a: jax.Array, W: int) -> jax.Array:
    """[T+2, ..., H] -> [..., H, W]: drop pad columns and unskew."""
    s = jnp.moveaxis(a, 0, -1)[..., 1:-1]
    return unskew(s, W)


def raster_gamma(H: int, W: int, dtype=jnp.float32) -> jax.Array:
    """gamma = 1/max(nFwd, nBwd) under raster order. [H, W]."""
    ys = jnp.arange(H)[:, None] * jnp.ones((1, W), jnp.int32)
    xs = jnp.arange(W)[None, :] * jnp.ones((H, 1), jnp.int32)
    has_l = (xs >= 1).astype(dtype)
    has_r = (xs <= W - 2).astype(dtype)
    has_u = (ys >= 1).astype(dtype)
    has_d = (ys <= H - 2).astype(dtype)
    n_fwd = 2.0 * (has_r + has_d)
    n_bwd = 2.0 * (has_l + has_u)
    return 1.0 / jnp.maximum(jnp.maximum(n_fwd, n_bwd), 1.0)


# ---------------------------------------------------------- message updates
# Leading batch axes (the stacked direction pair) broadcast through: all
# inputs may carry [..., K, H] / [..., H] shapes.  One dense [..., K, K, H]
# expression per send keeps the scan-step body to a handful of fusable ops
# (a per-label Python loop here costs ~100 tiny launches per column); XLA
# fuses the broadcast into the min-reduction.
def _send_head(gD, Mold, Q, D0, alpha, kernel, tol):
    """Head-send: msg'[k_t] = min_{k_h}(gD[k_h] - Mold[k_h] + a·TR(Q[k_t]-D0[k_h])).

    gD/Mold/Q/D0: [..., K, H]; alpha: [..., H].  Returns (normalized msg, vmin).
    """
    Hs = gD - Mold  # [..., Kh, H]
    term = alpha[..., None, None, :] * truncated_kernel(
        Q[..., None, :, :] - D0[..., :, None, :], kernel, tol)  # [..., Kh, Kt, H]
    acc = jnp.min(Hs[..., :, None, :] + term, axis=-3)  # [..., Kt, H]
    vmin = jnp.min(acc, axis=-2)
    return acc - vmin[..., None, :], vmin


def _send_tail(gD_tail, Mold, Q, D0, alpha, kernel, tol):
    """Tail-send: msg'[k_h] = min_{k_t}(gD_tail[k_t] - Mold[k_t] + a·TR(Q[k_t]-D0[k_h]))."""
    Hs = gD_tail - Mold  # [..., Kt, H]
    term = alpha[..., None, None, :] * truncated_kernel(
        Q[..., :, None, :] - D0[..., None, :, :], kernel, tol)  # [..., Kt, Kh, H]
    msg = jnp.min(Hs[..., :, None, :] + term, axis=-3)  # [..., Kh, H]
    vmin = jnp.min(msg, axis=-2)
    return msg - vmin[..., None, :], vmin


def _shift_down(v):
    """v[..., y] -> v[..., y-1] (row y reads row y-1), zero at y=0."""
    pads = [(0, 0)] * (v.ndim - 1) + [(1, 0)]
    return jnp.pad(v, pads)[..., :-1]


def _shift_up(v):
    """v[..., y] -> v[..., y+1], zero at y=H-1."""
    pads = [(0, 0)] * (v.ndim - 1) + [(0, 1)]
    return jnp.pad(v, pads)[..., 1:]


class _Skewed:
    """Skewed, t-leading, column-padded problem data."""

    def __init__(self, theta, D0, Q, alphas, kernel, tol):
        K, H, W = theta.shape
        dtype = theta.dtype
        self.K, self.H, self.W = K, H, W
        self.T = H + W - 1
        self.kernel, self.tol = kernel, tol
        self.theta = _tlead(theta, W)  # [T+2, K, H]
        self.D0 = _tlead(D0, W)
        # per-group problem data: [T+2, 2, K, H] / [T+2, 2, H]
        self.QA = _tlead(jnp.stack([Q[d] for d in GROUP_A], 0), W)
        self.QB = _tlead(jnp.stack([Q[d] for d in GROUP_B], 0), W)
        self.aA = _tlead(jnp.stack([alphas[d] for d in GROUP_A], 0), W)
        self.aB = _tlead(jnp.stack([alphas[d] for d in GROUP_B], 0), W)
        valid = {d: geometry.valid_mask(H, W, d, dtype=dtype) for d in range(4)}
        self.vA = _tlead(jnp.stack([valid[d] for d in GROUP_A], 0), W)
        self.vB = _tlead(jnp.stack([valid[d] for d in GROUP_B], 0), W)
        y = jnp.arange(H)[:, None]
        t = jnp.arange(self.T)[None, :]
        x = t - y
        pix = ((x >= 0) & (x < W)).astype(dtype)  # [H, T]
        pix = jnp.pad(pix, [(0, 0), (1, 1)])
        self.pix = jnp.moveaxis(pix, -1, 0)  # [T+2, H]
        self.gamma = _tlead(raster_gamma(H, W, dtype), W)  # [T+2, H]

    def col(self, a, c):
        return lax.dynamic_index_in_dim(a, c, axis=0, keepdims=False)

    # array fields, for passing the problem through a jit boundary as
    # arguments (closure-captured slabs inflate remote compile payloads —
    # same pattern as banded._BandedProblem)
    _ARRAY_FIELDS = ("theta", "D0", "QA", "QB", "aA", "aB", "vA", "vB",
                     "pix", "gamma")

    def tree(self):
        return {f: getattr(self, f) for f in self._ARRAY_FIELDS}

    def with_tree(self, tree):
        import copy

        sk = copy.copy(self)
        for f, v in tree.items():
            setattr(sk, f, v)
        return sk


def _set_col(M, c, value):
    return lax.dynamic_update_index_in_dim(M, value, c, axis=0)


def messages_to_groups(messages: jax.Array, W: int):
    """[4, K, H, W] -> (MA, MB) t-leading [T+2, 2, K, H] slabs."""
    MA = _tlead(jnp.stack([messages[d] for d in GROUP_A], 0), W)
    MB = _tlead(jnp.stack([messages[d] for d in GROUP_B], 0), W)
    return MA, MB


def groups_to_messages(MA: jax.Array, MB: jax.Array, W: int) -> jax.Array:
    """(MA, MB) -> [4, K, H, W] in the trws.py direction order."""
    A = _tlead_inv(MA, W)  # [2, K, H, W]
    B = _tlead_inv(MB, W)
    return jnp.stack([B[0], A[0], B[1], A[1]], 0)  # LT, RT, UP, DN


def decode_raster(sk: _Skewed, M):
    """Greedy conditioned decode in raster order + exact energy.

    Mirrors ComputeSolutionAndEnergy (minimize.cpp:223-264) under the raster
    order on a message state M = (MA, MB) in t-leading group layout.
    Mechanically usable on any message state following the trws.py buffer
    conventions, but NOTE the round-4 measurement (solvers/banded.py
    BandedRun decode="raster"): applied to a *banded*-schedule state it
    decodes systematically worse than that schedule's own decode — the
    greedy conditioned decode is only meaningful under the ordering whose
    forward messages it conditions on.  Returns (labels [H, W] int32,
    energy)."""
    MA, MB = M
    T, kernel, tol = sk.T, sk.kernel, sk.tol
    H, W = sk.H, sk.W
    acc_t = jnp.promote_types(MA.dtype, jnp.float32)

    def step(carry, t):
        sol_prev, E = carry  # sol of padded column c-1, [H] int32
        c = t + 1
        th = sk.col(sk.theta, c)
        D0c = sk.col(sk.D0, c)
        pixc = sk.col(sk.pix, c)
        QB_c = sk.col(sk.QB, c)
        aB_c = sk.col(sk.aB, c)
        vB_c = sk.col(sk.vB, c)
        QA_p = sk.col(sk.QA, c - 1)
        aA_p = sk.col(sk.aA, c - 1)
        vA_p = sk.col(sk.vA, c - 1)
        D0p = sk.col(sk.D0, c - 1)

        # conditioned terms from earlier neighbors (left, up)
        sol_l = sol_prev  # left nbr shares the skew row
        sol_u = _shift_down(sol_prev)  # up nbr is skew row y-1
        Db = th
        # E(p, LT): V[sol_l, k_p] at p
        Q_sel = jnp.take_along_axis(QB_c[0], sol_l[None, :], axis=0)[0]
        Db = Db + aB_c[0][None, :] * truncated_kernel(
            Q_sel[None, :] - D0c, kernel, tol) * vB_c[0][None, :]
        # E(p, UP): V[sol_u, k_p] at p
        Q_sel = jnp.take_along_axis(QB_c[1], sol_u[None, :], axis=0)[0]
        Db = Db + aB_c[1][None, :] * truncated_kernel(
            Q_sel[None, :] - D0c, kernel, tol) * vB_c[1][None, :]
        # E(ln, RT): V[k_p, sol_l] at the left neighbor (col c-1)
        D0_sel = jnp.take_along_axis(D0p, sol_l[None, :], axis=0)[0]
        Db = Db + aA_p[0][None, :] * truncated_kernel(
            QA_p[0] - D0_sel[None, :], kernel, tol) * vA_p[0][None, :]
        # E(un, DN): V[k_p, sol_u] at the up neighbor — evaluate at the
        # neighbor's own skew row (y-1) of column c-1, where sol_prev
        # already holds its label, then shift down to row y.
        D0_un_sel = jnp.take_along_axis(D0p, sol_prev[None, :], axis=0)[0]
        t_un = aA_p[1][None, :] * truncated_kernel(
            QA_p[1] - D0_un_sel[None, :], kernel, tol) * vA_p[1][None, :]
        Db = Db + _shift_down(t_un)

        # forward messages on later edges
        Ac = sk.col(MA, c)
        Bn = sk.col(MB, c + 1)
        Di = Db + Ac[0] + Ac[1] + Bn[0] + _shift_up(Bn[1])

        sol = jnp.argmin(Di, axis=0).astype(jnp.int32)
        E = E + jnp.sum(
            jnp.where(pixc > 0,
                      jnp.take_along_axis(Db, sol[None, :], axis=0)[0],
                      0.0), dtype=acc_t)
        return (sol, E), sol

    (last, E), sols = lax.scan(
        step, (jnp.zeros((H,), jnp.int32), jnp.zeros((), acc_t)),
        jnp.arange(T))
    # sols: [T, H] — column t holds labels of padded col t+1
    sols_sk = jnp.moveaxis(sols, 0, -1)  # [H, T]
    labels = unskew(sols_sk, W)
    return labels, E


def _beliefs_col(sk: _Skewed, MA, MB, c, Ac=None, Bc=None):
    """Beliefs of padded column c: theta + all 8 incident buffers. [K, H]."""
    if Ac is None:
        Ac = sk.col(MA, c)
    if Bc is None:
        Bc = sk.col(MB, c)
    Acm1 = sk.col(MA, c - 1)
    Bcp1 = sk.col(MB, c + 1)
    D = sk.col(sk.theta, c) + Ac[0] + Ac[1] + Bc[0] + Bc[1]
    # out-buffers at the neighbors (zero-kept at nonexistent neighbors by
    # construction): RT at the left nbr (same skew row), DN at the up nbr
    # (skew row y-1 -> shift down), LT at the right nbr, UP at the down nbr.
    D = D + Acm1[0] + _shift_down(Acm1[1])
    D = D + Bcp1[0] + _shift_up(Bcp1[1])
    return D


def solve_wavefront(
    unary: jax.Array,  # [K, H, W]
    positions: jax.Array,  # D0 [K, H, W]
    nbr_positions: jax.Array,  # Q [4, K, H, W]
    alphas: jax.Array,  # [4, H, W]
    *,
    kernel: int,
    tol,
    maxiter: int = 1000,
    max_relgap: float = 1e-4,
    messages: jax.Array | None = None,  # [4, K, H, W] warm start
    check_every: int = 1,
    unroll: int = 1,
) -> TRWSResult:
    """Raster-order TRW-S via anti-diagonal wavefronts; drop-in for trws.solve.

    Each sweep is a lax.scan over skewed columns.
    """
    K, H, W = unary.shape
    dtype = unary.dtype
    sk = _Skewed(unary, positions, nbr_positions, alphas, kernel, tol)
    T = sk.T
    acc_t = jnp.promote_types(dtype, jnp.float32)

    if messages is None:
        messages = jnp.zeros((4, K, H, W), dtype)
    M0 = messages_to_groups(messages, W)

    ktol = (kernel, tol)

    def fwd_col(M, t):
        MA, MB = M
        c = t + 1  # padded column index
        Ac = sk.col(MA, c)
        Bcp1 = sk.col(MB, c + 1)
        D = _beliefs_col(sk, MA, MB, c, Ac=Ac)
        gD = sk.col(sk.gamma, c)[None, :] * D

        # E(p, RT)/E(p, DN): head-sends at this column (group A)
        mh, _ = _send_head(gD[None], Ac, sk.col(sk.QA, c),
                           sk.col(sk.D0, c)[None], sk.col(sk.aA, c), *ktol)
        vh = sk.col(sk.vA, c)
        MA = _set_col(MA, c, jnp.where(vh[:, None, :] > 0, mh, Ac))

        # E(rn, LT)/E(dn, UP): tail-sends into col c+1 (group B; the right
        # nbr shares the skew row, the down nbr is skew row y+1 -> shift down)
        gDt = jnp.stack([gD, _shift_down(gD)], 0)
        mt, _ = _send_tail(gDt, Bcp1, sk.col(sk.QB, c + 1),
                           sk.col(sk.D0, c + 1)[None], sk.col(sk.aB, c + 1),
                           *ktol)
        vt = sk.col(sk.vB, c + 1)
        MB = _set_col(MB, c + 1, jnp.where(vt[:, None, :] > 0, mt, Bcp1))
        return (MA, MB), None

    def bwd_col(M, t):
        MA, MB = M
        c = t + 1
        Bc = sk.col(MB, c)
        Acm1 = sk.col(MA, c - 1)
        D = _beliefs_col(sk, MA, MB, c, Bc=Bc)
        pixc = sk.col(sk.pix, c)
        vminD = jnp.min(D, axis=0)
        lb = jnp.sum(jnp.where(pixc > 0, vminD, 0.0), dtype=acc_t)
        gD = sk.col(sk.gamma, c)[None, :] * (D - vminD[None, :])

        # E(p, LT)/E(p, UP): head-sends at this column (group B)
        mh, vminh = _send_head(gD[None], Bc, sk.col(sk.QB, c),
                               sk.col(sk.D0, c)[None], sk.col(sk.aB, c),
                               *ktol)
        vh = sk.col(sk.vB, c)
        lb += jnp.sum(jnp.where(vh > 0, vminh, 0.0), dtype=acc_t)
        MB = _set_col(MB, c, jnp.where(vh[:, None, :] > 0, mh, Bc))

        # E(ln, RT)/E(un, DN): tail-sends into col c-1 (group A; the left
        # nbr shares the skew row, the up nbr is skew row y-1 -> shift up)
        gDt = jnp.stack([gD, _shift_up(gD)], 0)
        mt, vmint = _send_tail(gDt, Acm1, sk.col(sk.QA, c - 1),
                               sk.col(sk.D0, c - 1)[None],
                               sk.col(sk.aA, c - 1), *ktol)
        vt = sk.col(sk.vA, c - 1)
        lb += jnp.sum(jnp.where(vt > 0, vmint, 0.0), dtype=acc_t)
        MA = _set_col(MA, c - 1, jnp.where(vt[:, None, :] > 0, mt, Acm1))
        return (MA, MB), lb

    def decode(M):
        return decode_raster(sk, M)

    def sweep(M, _):
        M, _ = lax.scan(fwd_col, M, jnp.arange(T), unroll=unroll)
        M, lbs = lax.scan(bwd_col, M, jnp.arange(T - 1, -1, -1),
                          unroll=unroll)
        return M, jnp.sum(lbs, dtype=acc_t)

    def one_check(M):
        M, lbs = lax.scan(sweep, M, jnp.arange(check_every))
        lb = lbs[-1]
        labels, energy = decode(M)
        return M, energy, lb, labels

    def cond(state):
        M, it, energy, lb, labels = state
        relgap = jnp.where(energy != 0, (energy - lb) / energy, 0.0)
        return jnp.logical_and(
            it < maxiter, jnp.logical_or(it == 0, relgap >= max_relgap))

    def body(state):
        M, it, _, _, _ = state
        M, energy, lb, labels = one_check(M)
        return (M, it + check_every, energy, lb, labels)

    zero = jnp.zeros((), acc_t)
    state0 = (M0, jnp.zeros((), jnp.int32), zero, zero,
              jnp.zeros((H, W), jnp.int32))
    M, iters, energy, lb, labels = lax.while_loop(cond, body, state0)
    return TRWSResult(labels, energy, lb, iters,
                      groups_to_messages(M[0], M[1], W))
