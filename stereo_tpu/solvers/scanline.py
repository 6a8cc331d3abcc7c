"""Scanline-ordered TRW-S: row-sequential sweeps on the device.

The checkerboard schedule (solvers/trws.py) is maximally parallel but its
single-edge monotonic chains propagate information one pixel per sweep, so
tight relative gaps need many sweeps.  This module implements TRW-S under the
*scanline ordering*

    rank(y, x) = (y, parity(x), x)  — rows top-to-bottom; within a row, even
                                       columns before odd columns —

which gives image-spanning vertical chains (convergence behavior like the
reference's serial orderings, ordering.cpp:7-140) while keeping W/2-wide data
parallelism in every step: within a phase the source pixels are mutually
non-adjacent and share no buffers, so the parallel update equals the
sequential one and this is *exact* TRW-S for this ordering — monotone lower
bound, same stopping rule, greedy conditioned decode
(minimize.cpp:31-116, 223-264).

Edge conventions as in solvers/trws.py: E(p, d) is the in-edge of p from its
DIRS[d] neighbor, with potential V(k_tail, k_head) = alpha * TR(|Q_d[k_tail]
- D0[k_head]|) measured at p; one message buffer per edge stored at the head.
Update variants:
  B (source = head p):  msg[i] = min_j( gD_p[j] - M[j] + a*TR(|Q_d[i]-D0[j]|) )
  A (source = tail n):  msg[j] = min_i( gD_n[i] - M[i] + a*TR(|Q_d[i]-D0[j]|) )

Forward sweep, row y:   even phase: lateral pairs (E(p,L/R) B at even,
A at odd) + down pair at even (E(p,DN) B; next row E(n,UP) A);
odd phase: down pair at odd.  Backward sweep mirrors with up pairs, odd
phase first, accumulating the lower bound.

Implementation: one ghost row of zero weights on top and bottom; a lax.scan
over rows reads a [3, W] slab and writes back rows touched by the step.

A scanline sweep is H sequential scan steps of [K, W] work, while its
per-sweep bound progress is only ~1.5x the checkerboard's, so the
checkerboard schedule is the default; this module serves as an exact alternative ordering (useful as
an on-device oracle and for ordering-sensitivity studies), mirroring how the
reference's convergence depends on SetAutomaticOrdering.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from stereo_tpu import geometry
from stereo_tpu.energy import truncated_kernel
from stereo_tpu.solvers.trws import TRWSResult

# direction indices (geometry.DIRS order)
LT, RT, UP, DN = 0, 1, 2, 3


def scanline_gamma(H: int, W: int, dtype=jnp.float32) -> jax.Array:
    """gamma = 1/max(nFwd, nBwd) under the scanline ordering
    (treeProbabilities.cpp:12-47; two directed edges per neighbor pair)."""
    xs = jnp.arange(W)[None, :] * jnp.ones((H, 1), jnp.int32)
    ys = jnp.arange(H)[:, None] * jnp.ones((1, W), jnp.int32)
    has_l = (xs >= 1).astype(dtype)
    has_r = (xs <= W - 2).astype(dtype)
    has_u = (ys >= 1).astype(dtype)
    has_d = (ys <= H - 2).astype(dtype)
    even = xs % 2 == 0
    n_fwd = jnp.where(even, 2 * (has_l + has_r + has_d), 2 * has_d)
    n_bwd = jnp.where(even, 2 * has_u, 2 * (has_u + has_l + has_r))
    return 1.0 / jnp.maximum(jnp.maximum(n_fwd, n_bwd), 1.0)


def _roll_cols(x, shift):
    """Shift along the column axis, vacated entries zero. x: [..., W]."""
    out = jnp.roll(x, shift, axis=-1)
    idx = jnp.arange(x.shape[-1])
    if shift > 0:
        mask = idx >= shift
    else:
        mask = idx < x.shape[-1] + shift
    return out * mask.astype(x.dtype)


def _mp_B(gD, M, Q, D0, alpha, kernel, tol):
    """Variant B on a row: msg[i] = min_j(gD[j] - M[j] + a*TR(|Q[i]-D0[j]|)).

    gD/M/Q/D0: [K, W]; alpha: [W].  Returns (normalized msg, vmin)."""
    K = Q.shape[0]
    Hs = gD - M
    acc = None
    for j in range(K):
        t = Hs[j][None, :] + alpha[None, :] * truncated_kernel(Q - D0[j][None, :], kernel, tol)
        acc = t if acc is None else jnp.minimum(acc, t)
    vmin = jnp.min(acc, axis=0)
    return acc - vmin[None, :], vmin


def _mp_A(gD_tail, M, Q, D0, alpha, kernel, tol):
    """Variant A on a row: msg[j] = min_i(gD_tail[i] - M[i] + a*TR(|Q[i]-D0[j]|))."""
    K = Q.shape[0]
    Hs = gD_tail - M
    out = []
    for j in range(K):
        t = Hs + alpha[None, :] * truncated_kernel(Q - D0[j][None, :], kernel, tol)
        out.append(jnp.min(t, axis=0))
    msg = jnp.stack(out, axis=0)
    vmin = jnp.min(msg, axis=0)
    return msg - vmin[None, :], vmin


class _RowData:
    """Static per-row views of the padded problem arrays."""

    def __init__(self, theta_p, D0_p, Q_p, alphas_p, valid_p, gamma_p):
        self.theta = theta_p  # [K, H+2, W]
        self.D0 = D0_p
        self.Q = Q_p  # [4, K, H+2, W]
        self.alphas = alphas_p  # [4, H+2, W]
        self.valid = valid_p  # [4, H+2, W]
        self.gamma = gamma_p  # [H+2, W]

    def row(self, arr, r):
        return lax.dynamic_index_in_dim(arr, r, axis=-2, keepdims=False)


def _beliefs_row(rd: _RowData, M, r):
    """Beliefs of padded row r: theta + all 8 incident buffers. [K, W].

    M is a 4-tuple of per-direction buffers [K, H+2, W] — separate arrays so
    every row write is a single in-place dynamic-update-slice on the scan
    carry (a stacked [4, K, H+2, W] carry forced XLA to materialize a full
    copy per .at[d].set, ~12 copies of the whole message state per row)."""
    th = rd.row(rd.theta, r)
    D = th
    for d in range(4):
        D = D + lax.dynamic_index_in_dim(M[d], r, axis=-2, keepdims=False)
    # out-edge buffers: at left neighbor E(n,RT); right E(n,LT);
    # up neighbor E(n,DN) (row r-1); down neighbor E(n,UP) (row r+1)
    D = D + _roll_cols(lax.dynamic_index_in_dim(M[RT], r, axis=-2, keepdims=False), 1)
    D = D + _roll_cols(lax.dynamic_index_in_dim(M[LT], r, axis=-2, keepdims=False), -1)
    D = D + lax.dynamic_index_in_dim(M[DN], r - 1, axis=-2, keepdims=False)
    D = D + lax.dynamic_index_in_dim(M[UP], r + 1, axis=-2, keepdims=False)
    return D


def _set_row(M, d, r, value):
    """Tuple-of-arrays in-place row update (see _beliefs_row)."""
    return M[:d] + (lax.dynamic_update_index_in_dim(M[d], value, r, axis=-2),) + M[d + 1:]


def _masked(new, old, mask_w):
    """Select new where mask (over columns), else old. new/old: [K, W]."""
    return jnp.where(mask_w[None, :], new, old)


def solve_scanline(
    unary: jax.Array,  # [K, H, W]
    positions: jax.Array,  # D0 [K, H, W]
    nbr_positions: jax.Array,  # Q [4, K, H, W]
    alphas: jax.Array,  # [4, H, W]
    *,
    kernel: int,
    tol,
    maxiter: int = 1000,
    max_relgap: float = 1e-4,
    messages: jax.Array | None = None,  # [4, K, H, W]
    check_every: int = 1,
) -> TRWSResult:
    """TRW-S with the scanline ordering; drop-in alternative to trws.solve."""
    K, H, W = unary.shape
    dtype = unary.dtype

    pad_row = lambda a: jnp.pad(a, [(0, 0)] * (a.ndim - 2) + [(1, 1), (0, 0)])
    theta_p = pad_row(unary)
    D0_p = pad_row(positions)
    Q_p = pad_row(nbr_positions)
    alphas_p = pad_row(alphas)
    valid = jnp.stack(
        [geometry.valid_mask(H, W, d, dtype=dtype) for d in range(4)], 0)
    valid_p = pad_row(valid)
    gamma_p = pad_row(scanline_gamma(H, W, dtype))
    rd = _RowData(theta_p, D0_p, Q_p, alphas_p, valid_p, gamma_p)

    xs = jnp.arange(W)
    even_w = (xs % 2 == 0)
    odd_w = ~even_w
    acc_t = jnp.promote_types(dtype, jnp.float32)

    def fwd_row(M, y):
        """Forward step for real row y (padded r = y + 1)."""
        r = y + 1
        row = lambda a: rd.row(a, r)
        nrow = lambda a: rd.row(a, r + 1)
        Dmid = _beliefs_row(rd, M, r)
        gD = row(rd.gamma)[None, :] * Dmid

        Qm = [rd.row(rd.Q[d], r) for d in range(4)]
        Qn_up = rd.row(rd.Q[UP], r + 1)
        D0m = row(rd.D0)
        D0n = nrow(rd.D0)
        am = [row(rd.alphas[d]) for d in range(4)]
        an_up = lax.dynamic_index_in_dim(rd.alphas[UP], r + 1, axis=-2, keepdims=False)
        vm = [row(rd.valid[d]) for d in range(4)]
        vn_up = lax.dynamic_index_in_dim(rd.valid[UP], r + 1, axis=-2, keepdims=False)

        ML = lax.dynamic_index_in_dim(M[LT], r, axis=-2, keepdims=False)
        MR = lax.dynamic_index_in_dim(M[RT], r, axis=-2, keepdims=False)
        MD = lax.dynamic_index_in_dim(M[DN], r, axis=-2, keepdims=False)
        MU_next = lax.dynamic_index_in_dim(M[UP], r + 1, axis=-2, keepdims=False)

        # ---- even phase (sources: even columns of row y)
        # E(p,LT) B at even / A at odd (tail even-left)
        bL, _ = _mp_B(gD, ML, Qm[LT], D0m, am[LT], kernel, tol)
        aL, _ = _mp_A(_roll_cols(gD, 1), ML, Qm[LT], D0m, am[LT], kernel, tol)
        newL = (jnp.where(even_w[None, :], bL, aL)) * vm[LT][None, :]
        bR, _ = _mp_B(gD, MR, Qm[RT], D0m, am[RT], kernel, tol)
        aR, _ = _mp_A(_roll_cols(gD, -1), MR, Qm[RT], D0m, am[RT], kernel, tol)
        newR = (jnp.where(even_w[None, :], bR, aR)) * vm[RT][None, :]
        # E(p,DN) B at even
        bD, _ = _mp_B(gD, MD, Qm[DN], D0m, am[DN], kernel, tol)
        newD = _masked(bD * vm[DN][None, :], MD, even_w)
        # next row E(n,UP) A at even (tail = this row's pixel)
        aU, _ = _mp_A(gD, MU_next, Qn_up, D0n, an_up, kernel, tol)
        newUn = _masked(aU * vn_up[None, :], MU_next, even_w)

        M = _set_row(M, LT, r, newL)
        M = _set_row(M, RT, r, newR)
        M = _set_row(M, DN, r, newD)
        M = _set_row(M, UP, r + 1, newUn)

        # ---- odd phase (sources: odd columns), beliefs recomputed
        Dmid2 = _beliefs_row(rd, M, r)
        gD2 = row(rd.gamma)[None, :] * Dmid2
        MD = lax.dynamic_index_in_dim(M[DN], r, axis=-2, keepdims=False)
        MU_next = lax.dynamic_index_in_dim(M[UP], r + 1, axis=-2, keepdims=False)
        bD2, _ = _mp_B(gD2, MD, Qm[DN], D0m, am[DN], kernel, tol)
        newD2 = _masked(bD2 * vm[DN][None, :], MD, odd_w)
        aU2, _ = _mp_A(gD2, MU_next, Qn_up, D0n, an_up, kernel, tol)
        newUn2 = _masked(aU2 * vn_up[None, :], MU_next, odd_w)
        M = _set_row(M, DN, r, newD2)
        M = _set_row(M, UP, r + 1, newUn2)
        return M, None

    def bwd_row(M, y):
        """Backward step for real row y; returns LB contribution."""
        r = y + 1
        row = lambda a: rd.row(a, r)
        Dmid = _beliefs_row(rd, M, r)

        Qm = [rd.row(rd.Q[d], r) for d in range(4)]
        Qn_dn = lax.dynamic_index_in_dim(rd.Q[DN], r - 1, axis=-2, keepdims=False)
        D0m = row(rd.D0)
        D0p = lax.dynamic_index_in_dim(rd.D0, r - 1, axis=-2, keepdims=False)
        am = [row(rd.alphas[d]) for d in range(4)]
        ap_dn = lax.dynamic_index_in_dim(rd.alphas[DN], r - 1, axis=-2, keepdims=False)
        vm = [row(rd.valid[d]) for d in range(4)]
        vp_dn = lax.dynamic_index_in_dim(rd.valid[DN], r - 1, axis=-2, keepdims=False)
        gamma_row = row(rd.gamma)

        def phase(M, mask_w, Dmid):
            """Process the masked pixels of row y as backward sources."""
            nonlocal_lb = jnp.zeros((), acc_t)
            vminD = jnp.min(Dmid, axis=0)
            nonlocal_lb += jnp.sum(jnp.where(mask_w, vminD, 0.0), dtype=acc_t)
            Dn = Dmid - vminD[None, :]
            gD = gamma_row[None, :] * Dn

            ML = lax.dynamic_index_in_dim(M[LT], r, axis=-2, keepdims=False)
            MR = lax.dynamic_index_in_dim(M[RT], r, axis=-2, keepdims=False)
            MU = lax.dynamic_index_in_dim(M[UP], r, axis=-2, keepdims=False)
            MD_prev = lax.dynamic_index_in_dim(M[DN], r - 1, axis=-2, keepdims=False)

            # lateral sends only happen in the odd phase
            lateral = mask_w is odd_w
            if lateral:
                # E(p,LT) B at odd / E(n_right? ...) — see module docstring
                bL, vL = _mp_B(gD, ML, Qm[LT], D0m, am[LT], kernel, tol)
                newL = _masked(bL * vm[LT][None, :], ML, odd_w)
                nonlocal_lb += jnp.sum(jnp.where(odd_w & (vm[LT] > 0), vL, 0.0), dtype=acc_t)
                bR, vR = _mp_B(gD, MR, Qm[RT], D0m, am[RT], kernel, tol)
                newR = _masked(bR * vm[RT][None, :], MR, odd_w)
                nonlocal_lb += jnp.sum(jnp.where(odd_w & (vm[RT] > 0), vR, 0.0), dtype=acc_t)
                # A-sends into even neighbors' lateral in-edges
                aR, vaR = _mp_A(_roll_cols(gD, -1), MR, Qm[RT], D0m, am[RT], kernel, tol)
                newR = _masked(aR * vm[RT][None, :], newR, even_w)
                nonlocal_lb += jnp.sum(jnp.where(even_w & (vm[RT] > 0), vaR, 0.0), dtype=acc_t)
                aL, vaL = _mp_A(_roll_cols(gD, 1), ML, Qm[LT], D0m, am[LT], kernel, tol)
                newL = _masked(aL * vm[LT][None, :], newL, even_w)
                nonlocal_lb += jnp.sum(jnp.where(even_w & (vm[LT] > 0), vaL, 0.0), dtype=acc_t)
                M = _set_row(M, LT, r, newL)
                M = _set_row(M, RT, r, newR)
            # up pair: E(p,UP) B at masked cols
            bU, vU = _mp_B(gD, MU, Qm[UP], D0m, am[UP], kernel, tol)
            newU = _masked(bU * vm[UP][None, :], MU, mask_w)
            nonlocal_lb += jnp.sum(jnp.where(mask_w & (vm[UP] > 0), vU, 0.0), dtype=acc_t)
            # prev row E(n,DN) A at masked cols
            aD, vaD = _mp_A(gD, MD_prev, Qn_dn, D0p, ap_dn, kernel, tol)
            newDp = _masked(aD * vp_dn[None, :], MD_prev, mask_w)
            nonlocal_lb += jnp.sum(jnp.where(mask_w & (vp_dn > 0), vaD, 0.0), dtype=acc_t)
            M = _set_row(M, UP, r, newU)
            M = _set_row(M, DN, r - 1, newDp)
            return M, nonlocal_lb

        M, lb1 = phase(M, odd_w, Dmid)
        Dmid2 = _beliefs_row(rd, M, r)
        M, lb2 = phase(M, even_w, Dmid2)
        return M, lb1 + lb2

    def decode(M):
        """Greedy conditioned decode in rank order + exact energy."""

        def step(carry, y):
            sol_up, E = carry
            r = y + 1
            row = lambda a: rd.row(a, r)
            th = row(rd.theta)
            D0m = row(rd.D0)
            Qm = [rd.row(rd.Q[d], r) for d in range(4)]
            am = [row(rd.alphas[d]) for d in range(4)]
            # previous-row quantities for the out-edge up-pair term
            D0p = lax.dynamic_index_in_dim(rd.D0, r - 1, axis=-2, keepdims=False)
            Qp_dn = lax.dynamic_index_in_dim(rd.Q[DN], r - 1, axis=-2, keepdims=False)
            ap_dn = lax.dynamic_index_in_dim(rd.alphas[DN], r - 1, axis=-2, keepdims=False)

            # DiBackward common: up-pair terms conditioned on sol_up
            Q_up_sel = geometry.take_plane(Qm[UP], sol_up)
            db = th + am[UP][None, :] * truncated_kernel(Q_up_sel[None, :] - D0m, kernel, tol)
            D0p_sel = geometry.take_plane(D0p, sol_up)
            db = db + ap_dn[None, :] * truncated_kernel(Qp_dn - D0p_sel[None, :], kernel, tol)

            # forward messages into this row's pixels
            ML = lax.dynamic_index_in_dim(M[LT], r, axis=-2, keepdims=False)
            MR = lax.dynamic_index_in_dim(M[RT], r, axis=-2, keepdims=False)
            MD = lax.dynamic_index_in_dim(M[DN], r, axis=-2, keepdims=False)
            MU_next = lax.dynamic_index_in_dim(M[UP], r + 1, axis=-2, keepdims=False)
            fwd_down = MD + MU_next

            # even pixels: Di = db + all six forward-edge messages --
            # in-laterals at p, out-laterals stored at the odd neighbors
            # (indexed by p's labels after their backward B-sends), down pair
            Di_even = (db + ML + MR + _roll_cols(MR, 1) + _roll_cols(ML, -1)
                       + fwd_down)
            sol_even = jnp.argmin(Di_even, axis=0).astype(jnp.int32)

            # odd pixels: condition laterals on even solutions
            sol_l = _roll_cols(sol_even, 1)
            sol_r = _roll_cols(sol_even, -1)
            QL_sel = geometry.take_plane(Qm[LT], sol_l)
            db_o = db + am[LT][None, :] * truncated_kernel(QL_sel[None, :] - D0m, kernel, tol)
            QR_sel = geometry.take_plane(Qm[RT], sol_r)
            db_o = db_o + am[RT][None, :] * truncated_kernel(QR_sel[None, :] - D0m, kernel, tol)
            # out-lateral: V(k_p', sol_n) at the even neighbor n
            D0_sel_e = geometry.take_plane(D0m, sol_even)
            t_r = am[RT][None, :] * truncated_kernel(Qm[RT] - D0_sel_e[None, :], kernel, tol)
            db_o = db_o + _roll_cols(t_r, 1)  # from n = p'-1: E(n,RT) tail p'
            t_l = am[LT][None, :] * truncated_kernel(Qm[LT] - D0_sel_e[None, :], kernel, tol)
            db_o = db_o + _roll_cols(t_l, -1)  # from n = p'+1: E(n,LT) tail p'
            Di_odd = db_o + fwd_down
            sol_odd = jnp.argmin(Di_odd, axis=0).astype(jnp.int32)

            sol = jnp.where(even_w, sol_even, sol_odd)
            db_final = jnp.where(even_w[None, :], db, db_o)
            E = E + jnp.sum(
                geometry.take_plane(db_final, sol),
                dtype=acc_t,
            )
            return (sol, E), sol

        (last, E), sols = lax.scan(
            step, (jnp.zeros((W,), jnp.int32), jnp.zeros((), acc_t)),
            jnp.arange(H),
        )
        return sols, E

    if messages is None:
        messages = jnp.zeros((4, K, H, W), dtype)
    Mp = pad_row(messages)
    M0 = (Mp[0], Mp[1], Mp[2], Mp[3])

    def sweep(M, _):
        M, _ = lax.scan(fwd_row, M, jnp.arange(H))
        M, lbs = lax.scan(bwd_row, M, jnp.arange(H - 1, -1, -1))
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
            it < maxiter, jnp.logical_or(it == 0, relgap >= max_relgap)
        )

    def body(state):
        M, it, _, _, _ = state
        M, energy, lb, labels = one_check(M)
        return (M, it + check_every, energy, lb, labels)

    zero = jnp.zeros((), acc_t)
    state0 = (M0, jnp.zeros((), jnp.int32), zero, zero,
              jnp.zeros((H, W), jnp.int32))
    M, iters, energy, lb, labels = lax.while_loop(cond, body, state0)
    M = jnp.stack(M, axis=0)
    return TRWSResult(labels, energy, lb, iters, M[:, :, 1:-1, :])
