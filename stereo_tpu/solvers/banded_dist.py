"""Distributed banded wavefront TRW-S: gy-stripes over a device mesh.

The banded order t(p) = yb + xb (solvers/banded.py) is independent of the
block-row index gy: every block's wavefront advances in lockstep.  Partition
whole block-rows (gy stripes) across a 1-D device mesh and each device runs
the *local* banded problem on its stripe; the only cross-device coupling is

  (a) the y-seam side arrays of the stripe-border seam pairs
      (pU = (., Bh-1, xb) last block-row of stripe d |
       pD = (., 0, xb)    first block-row of stripe d+1):
      SyD@pU lives on d, SyU@pD lives on d+1, and each pair's beliefs read
      the partner's buffer — a [K, Gx] slab per step, and
  (b) the tail-sends across the border, which need the *source* node's gD
      from the neighbor stripe at the step that processes it — another
      [K, Gx] slab per step,

exactly the shard_map + per-step ppermute design of ROADMAP "Still open" #1
(reference chain mixing to match at scale: cpp/trw-s/minimize.cpp:36-95).

Each stripe sweeps via the scan path (one device program per step, the
seam slabs exchanged by ppermute between steps); a persistent whole-sweep
kernel would need the exchange inside the kernel.

Exactness: the stripe-local computation is the same per-node arithmetic in
the same order as the single-device solver — _BandedProblem built with
``stripe=(row0, Himg, has_above, has_below)`` judges masks/gammas against
global row indices, so messages and labels are **bitwise identical** to
solve_banded on one device (pinned in tests/test_sharding.py); only the
energy/lower-bound *sums* are reassociated (per-stripe partials + psum).

Halo timing (why a start-of-step exchange of the border rows suffices):
within a pass each border side-array entry is written exactly once —

  fwd:  beliefs@pD read SyD@pU at xb=t   -> written this step AFTER reads
                                            (pre-step halo = prev-pass value)
        beliefs@pU read SyU@pD at xb=t-(Bh-1) -> written by the neighbor's
                                            F-head at step t-(Bh-1) <= t-1
  bwd:  the mirror, with steps descending — both reads see either the
        previous pass's value or a value written >= 1 step earlier,

so a ppermute of the neighbor's current border row at the top of each scan
step always carries exactly the value the sequential order prescribes.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from stereo_tpu.energy import truncated_kernel
from stereo_tpu.geometry import take_plane
from stereo_tpu.solvers.trws import TRWSResult
from stereo_tpu.solvers import banded
from stereo_tpu.solvers.banded import (
    BandedSpec, _BandedProblem, _acc_t, _padLp, _sdownb, _set_col, _supb,
    from_cols, messages_to_state, state_to_messages,
)
from stereo_tpu.solvers.wavefront import _send_head, _send_tail

__all__ = ["sharded_banded_run", "make_y_mesh"]


def make_y_mesh(n_devices: int | None = None, devices=None,
                batch: int = 1) -> Mesh:
    """('y',) stripe mesh — or ('batch', 'y') when batch > 1 — over the
    first n_devices devices."""
    devices = list(devices if devices is not None else jax.devices())
    if n_devices is not None:
        devices = devices[:n_devices]
    if batch > 1:
        n = len(devices)
        if n % batch:
            raise ValueError(f"{n} devices not divisible by batch={batch}")
        return Mesh(np.asarray(devices).reshape(batch, n // batch),
                    ("batch", "y"))
    return Mesh(np.asarray(devices), ("y",))


class _StripeCtx:
    """Per-device distribution context: masks, perms, halo exchange."""

    def __init__(self, bp: _BandedProblem, axis: str, n: int,
                 vary_axes=None):
        self.bp = bp
        self.axis = axis
        self.n = n
        self.vary_axes = vary_axes if vary_axes is not None else (axis,)
        spec = bp.spec
        Gx, nb, L, Lp = spec.Gx, spec.nb, spec.L, spec.Lp
        self.bot_off = (spec.Bh - 1) * nb + (spec.Gy - 1) * Gx
        lane = jnp.arange(L)
        self.top_L = lane < Gx  # my0 border lanes (yb=0, gy=0)
        self.bot_L = (lane >= self.bot_off) & (lane < self.bot_off + Gx)
        lane2 = jnp.arange(Lp)
        l2_gy = (lane2 % nb) // Gx
        self.l2_top = l2_gy == 0  # B-tail border write rows
        self.l2_bot = l2_gy == spec.Gy - 1  # F-tail border write rows
        # device i's slab lands on i+1 (perm_dn: value from ABOVE) / i-1
        # (perm_up: value from BELOW); edge devices receive zeros.
        self.perm_dn = [(i, i + 1) for i in range(n - 1)]
        self.perm_up = [(i + 1, i) for i in range(n - 1)]

    def _pp(self, v, perm):
        if not perm:  # single stripe: nothing to exchange
            return jnp.zeros_like(v)
        return lax.ppermute(v, self.axis, perm)

    def vary(self, x):
        """Mark a locally-created constant as device-varying (shard_map's
        vma typing requires scan carries to agree with the updated state;
        under a ('batch', 'y') mesh the state varies over both axes)."""
        return jax.tree.map(
            lambda v: lax.pcast(v, self.vary_axes, to="varying"), x)

    def _row(self, arr, gy):
        """[K, Lp] side array -> its block-row gy as [K, Bw, Gx]."""
        spec = self.bp.spec
        r = arr[..., : spec.L2].reshape(arr.shape[:-1] + (spec.Bw, spec.nb))
        return r[..., gy * spec.Gx:(gy + 1) * spec.Gx]

    def exchange(self, S):
        """(haloSyD_above, haloSyU_below): the neighbors' border side-array
        rows as of the previous step, [K, Bw, Gx] each."""
        _, _, SyU, SyD = S
        spec = self.bp.spec
        halo_syd = self._pp(self._row(SyD, spec.Gy - 1), self.perm_dn)
        halo_syu = self._pp(self._row(SyU, 0), self.perm_up)
        return halo_syd, halo_syu

    def _place_top(self, slab):
        """[.., Gx] -> [.., L] at the my0 border lanes [0, Gx)."""
        L = self.bp.spec.L
        pads = [(0, 0)] * (slab.ndim - 1) + [(0, L - slab.shape[-1])]
        return jnp.pad(slab, pads)

    def _place_bot(self, slab):
        """[.., Gx] -> [.., L] at the myT border lanes."""
        spec = self.bp.spec
        pads = ([(0, 0)] * (slab.ndim - 1)
                + [(self.bot_off, spec.L - self.bot_off - spec.Gx)])
        return jnp.pad(slab, pads)

    def subst_views(self, views, halos, t):
        """Replace the wrap-garbage border lanes of the _seam_views rolls
        with the neighbors' halo values."""
        syu0, syd0, sydT, syuT = views
        halo_syd, halo_syu = halos
        spec = self.bp.spec
        t0 = jnp.clip(t, 0, spec.Bw - 1)
        slab0 = lax.dynamic_index_in_dim(halo_syd, t0, 1, keepdims=False)
        syd0 = jnp.where(self.top_L, self._place_top(slab0), syd0)
        tT = jnp.clip(t - (spec.Bh - 1), 0, spec.Bw - 1)
        slabT = lax.dynamic_index_in_dim(halo_syu, tT, 1, keepdims=False)
        syuT = jnp.where(self.bot_L, self._place_bot(slabT), syuT)
        return syu0, syd0, sydT, syuT


def _fwd_col(ctx: _StripeCtx, state, t):
    """Distributed mirror of banded._fwd_col (same interior arithmetic)."""
    bp = ctx.bp
    spec = bp.spec
    nb, Gx, Lp = spec.nb, spec.Gx, spec.Lp
    ktol = (bp.kernel, bp.tol)
    MA, MB, S = state
    SxL, SxR, SyU, SyD = S
    c = t + 1
    halos = ctx.exchange(S)
    views = ctx.subst_views(banded._seam_views(bp, S, t), halos, t)
    D, (Ac, _, _, Bcp1), masks = banded._beliefs(bp, MA, MB, c, t, S, views)
    mx0, mxW, my0, myT = masks
    gD = bp.col(bp.gamma, c)[None, :] * D  # [K, L]

    # interior head-sends, group A (RT, DN) at column c
    mh, _ = _send_head(gD[None], Ac, bp.col(bp.QA, c),
                       bp.col(bp.D0, c)[None], bp.col(bp.aA, c), *ktol)
    vh = bp.col(bp.vA, c)
    MA = _set_col(MA, c, jnp.where(vh[:, None, :] > 0, mh, Ac))

    # interior tail-sends, group B (LT, UP) into column c+1
    gDt = jnp.stack([gD, _sdownb(gD, nb)], 0)
    mt, _ = _send_tail(gDt, Bcp1, bp.col(bp.QB, c + 1),
                       bp.col(bp.D0, c + 1)[None],
                       bp.col(bp.aB, c + 1), *ktol)
    vt = bp.col(bp.vB, c + 1)
    MB = _set_col(MB, c + 1, jnp.where(vt[:, None, :] > 0, mt, Bcp1))

    QB_c = bp.col(bp.QB, c)
    D0_c = bp.col(bp.D0, c)
    aB_c = bp.col(bp.aB, c)
    # F-head x: M[LT]@(., t, 0)
    mlt, _ = _send_head(gD, SxL, QB_c[0], D0_c, aB_c[0], *ktol)
    SxL = jnp.where(mx0, mlt, SxL)
    # F-head y: M[UP]@(., 0, t) — border rows (gy = 0, stripe above) write
    # the same local SyU entries; only the masks are wider.
    mup, _ = _send_head(gD, views[0], QB_c[1], D0_c, aB_c[1], *ktol)
    upd = jnp.roll(_padLp(jnp.where(my0, mup, 0.0), Lp), t * nb, axis=-1)
    wy = (bp.l2_grp == t) & bp.vSyU
    SyU = jnp.where(wy, upd, SyU)
    # F-tail x: M[RT]@(., t, Bw-1) <- source (b+1, t, 0)
    mrt, _ = _send_tail(jnp.roll(gD, -1, axis=-1), SxR,
                        bp.PxR_q, bp.PxR_d0, bp.PxR_a, *ktol)
    wx = (bp.lane_yb == t) & bp.vSxR
    SxR = jnp.where(wx, mrt, SxR)
    # F-tail y: M[DN]@(., Bh-1, t) <- source (down-block, 0, t); for the
    # last block-row the source is the stripe below's top row — its gD slab
    # arrives by ppermute (computed this step on the neighbor).
    gDp = _padLp(gD, Lp)
    src = jnp.roll(gDp, t * nb - Gx, axis=-1)
    gD_below = ctx._pp(gD[:, : Gx], ctx.perm_up)
    t0 = jnp.clip(t, 0, spec.Bw - 1)
    subst = lax.dynamic_update_slice(
        jnp.zeros_like(gDp), gD_below,
        (0, t0 * nb + (spec.Gy - 1) * Gx))
    src = jnp.where(ctx.l2_bot, subst, src)
    mdn, _ = _send_tail(src, SyD, bp.PyD_q, bp.PyD_d0, bp.PyD_a, *ktol)
    wy2 = (bp.l2_grp == t) & bp.vSyD
    SyD = jnp.where(wy2, mdn, SyD)
    return (MA, MB, (SxL, SxR, SyU, SyD)), None


def _bwd_col(ctx: _StripeCtx, state, t):
    """Distributed mirror of banded._bwd_col with local lb partials."""
    bp = ctx.bp
    spec = bp.spec
    nb, Gx, Lp = spec.nb, spec.Gx, spec.Lp
    ktol = (bp.kernel, bp.tol)
    acc_t = _acc_t(bp)
    MA, MB, S = state
    SxL, SxR, SyU, SyD = S
    c = t + 1
    halos = ctx.exchange(S)
    views = ctx.subst_views(banded._seam_views(bp, S, t), halos, t)
    D, (_, Bc, Acm1, _), masks = banded._beliefs(bp, MA, MB, c, t, S, views)
    mx0, mxW, my0, myT = masks
    pix_c = bp.col(bp.pix, c)
    vminD = jnp.min(D, axis=0)
    lb = jnp.sum(jnp.where(pix_c > 0, vminD, 0.0), dtype=acc_t)
    gD = bp.col(bp.gamma, c)[None, :] * (D - vminD[None, :])

    # interior head-sends, group B (LT, UP) at column c
    mh, vminh = _send_head(gD[None], Bc, bp.col(bp.QB, c),
                           bp.col(bp.D0, c)[None], bp.col(bp.aB, c),
                           *ktol)
    vh = bp.col(bp.vB, c)
    lb += jnp.sum(jnp.where(vh > 0, vminh, 0.0), dtype=acc_t)
    MB = _set_col(MB, c, jnp.where(vh[:, None, :] > 0, mh, Bc))

    # interior tail-sends, group A (RT, DN) into column c-1
    gDt = jnp.stack([gD, _supb(gD, nb)], 0)
    mt, vmint = _send_tail(gDt, Acm1, bp.col(bp.QA, c - 1),
                           bp.col(bp.D0, c - 1)[None],
                           bp.col(bp.aA, c - 1), *ktol)
    vt = bp.col(bp.vA, c - 1)
    lb += jnp.sum(jnp.where(vt > 0, vmint, 0.0), dtype=acc_t)
    MA = _set_col(MA, c - 1, jnp.where(vt[:, None, :] > 0, mt, Acm1))

    QA_c = bp.col(bp.QA, c)
    D0_c = bp.col(bp.D0, c)
    aA_c = bp.col(bp.aA, c)
    # B-head x
    mrt, vrt = _send_head(gD, SxR, QA_c[0], D0_c, aA_c[0], *ktol)
    SxR = jnp.where(mxW, mrt, SxR)
    lb += jnp.sum(jnp.where(mxW, vrt, 0.0), dtype=acc_t)
    # B-head y: local gD, local SyD entries (border rows included via masks)
    mdn, vdn = _send_head(gD, views[2], QA_c[1], D0_c, aA_c[1], *ktol)
    lb += jnp.sum(jnp.where(myT, vdn, 0.0), dtype=acc_t)
    upd = jnp.roll(_padLp(jnp.where(myT, mdn, 0.0), Lp),
                   -(2 * spec.Bh - 2 - t) * nb, axis=-1)
    wyd = (bp.l2_grp == t - (spec.Bh - 1)) & bp.vSyD
    SyD = jnp.where(wyd, upd, SyD)
    # B-tail x
    mlt, vlt = _send_tail(jnp.roll(gD, 1, axis=-1), SxL,
                          bp.PxL_q, bp.PxL_d0, bp.PxL_a, *ktol)
    wxl = (bp.lane_yb == t - (spec.Bw - 1)) & bp.vSxL
    SxL = jnp.where(wxl, mlt, SxL)
    lb += jnp.sum(jnp.where(wxl, vlt, 0.0), dtype=acc_t)
    # B-tail y: M[UP]@(., 0, t-Bh+1) <- source (., Bh-1, t-Bh+1); for the
    # first block-row the source is the stripe above's bottom row.
    gDp = _padLp(gD, Lp)
    src = jnp.roll(gDp, (t - 2 * spec.Bh + 2) * nb + Gx, axis=-1)
    gD_above = ctx._pp(
        gD[:, ctx.bot_off: ctx.bot_off + Gx], ctx.perm_dn)
    tT = jnp.clip(t - (spec.Bh - 1), 0, spec.Bw - 1)
    subst = lax.dynamic_update_slice(
        jnp.zeros_like(gDp), gD_above, (0, tT * nb))
    src = jnp.where(ctx.l2_top, subst, src)
    mup, vup = _send_tail(src, SyU, bp.PyU_q, bp.PyU_d0, bp.PyU_a, *ktol)
    wyu = (bp.l2_grp == t - (spec.Bh - 1)) & bp.vSyU
    SyU = jnp.where(wyu, mup, SyU)
    lb += jnp.sum(jnp.where(wyu, vup, 0.0), dtype=acc_t)
    return (MA, MB, (SxL, SxR, SyU, SyD)), lb


def _sweep(ctx: _StripeCtx, state):
    T = ctx.bp.spec.T
    state, _ = lax.scan(lambda s, t: _fwd_col(ctx, s, t), state,
                        jnp.arange(T))
    state, lbs = lax.scan(lambda s, t: _bwd_col(ctx, s, t), state,
                          jnp.arange(T - 1, -1, -1))
    return state, jnp.sum(lbs, dtype=_acc_t(ctx.bp))


def _decode(ctx: _StripeCtx, state):
    """Distributed mirror of banded._decode_state.

    Per-step cross-device data: the halo side-array rows (S is frozen, so
    they are pass-constant) plus the just-decoded top-row solutions of the
    stripe below, pipelined Bh-1 steps ahead of their use."""
    bp = ctx.bp
    spec = bp.spec
    T, nb, Gx, L, Lp = spec.T, spec.nb, spec.Gx, spec.L, spec.Lp
    Bh, Bw = spec.Bh, spec.Bw
    kernel, tol = bp.kernel, bp.tol
    acc_t = _acc_t(bp)
    MA, MB, S = state
    SxL, SxR, SyU, SyD = S
    halos = ctx.exchange(S)
    # static border data of the stripe below's top row (edge data of the
    # border pairs' pD ends), exchanged once: [K, Bw, Gx] / [Bw, Gx]
    rows_q = ctx._pp(ctx._row(bp.PyU_q, 0), ctx.perm_up)
    rows_d0 = ctx._pp(ctx._row(bp.PyU_d0, 0), ctx.perm_up)
    rows_a = ctx._pp(ctx._row(bp.PyU_a, 0), ctx.perm_up)

    def step(carry, t):
        sols, E, halo_sols = carry
        c = t + 1
        views = ctx.subst_views(banded._seam_views(bp, S, t), halos, t)
        syu0, syd0, _, _ = views
        pix_c = bp.col(bp.pix, c)
        th = bp.col(bp.theta, c)
        D0c = bp.col(bp.D0, c)
        QB_c = bp.col(bp.QB, c)
        aB_c = bp.col(bp.aB, c)
        vB_c = bp.col(bp.vB, c)
        QA_c = bp.col(bp.QA, c)
        aA_c = bp.col(bp.aA, c)
        QA_p = bp.col(bp.QA, c - 1)
        aA_p = bp.col(bp.aA, c - 1)
        vA_p = bp.col(bp.vA, c - 1)
        D0p = bp.col(bp.D0, c - 1)
        sol_prev = bp.col(sols, c - 1)

        mx0 = (bp.lane_yb == t) & bp.vSxL
        mxW = (bp.lane_yb == t - (Bw - 1)) & bp.vSxR
        my0 = (bp.lane_yb == 0) & bp.has_up & (pix_c > 0)
        myT = (bp.lane_yb == Bh - 1) & bp.has_dn & (pix_c > 0)

        Db = th
        # conditioned on interior earlier nbrs (left, up)
        sol_l = sol_prev
        sol_u = _sdownb(sol_prev, nb)
        Q_sel = take_plane(QB_c[0], sol_l)
        Db = Db + aB_c[0][None, :] * truncated_kernel(
            Q_sel[None, :] - D0c, kernel, tol) * vB_c[0][None, :]
        Q_sel = take_plane(QB_c[1], sol_u)
        Db = Db + aB_c[1][None, :] * truncated_kernel(
            Q_sel[None, :] - D0c, kernel, tol) * vB_c[1][None, :]
        # out-edges at interior earlier nbrs: E(ln, RT), E(un, DN)
        D0_sel = take_plane(D0p, sol_l)
        Db = Db + aA_p[0][None, :] * truncated_kernel(
            QA_p[0] - D0_sel[None, :], kernel, tol) * vA_p[0][None, :]
        D0_un = take_plane(D0p, sol_prev)
        t_un = aA_p[1][None, :] * truncated_kernel(
            QA_p[1] - D0_un[None, :], kernel, tol) * vA_p[1][None, :]
        Db = Db + _sdownb(t_un, nb)
        # conditioned on seam earlier nbrs: right (xb = Bw-1 nodes) — local
        sol_r = jnp.roll(bp.col(sols, c - (Bw - 1)), -1, axis=-1)
        Q_sel = take_plane(QA_c[0], sol_r)
        Db = Db + jnp.where(
            mxW, aA_c[0] * truncated_kernel(Q_sel[None] - D0c, kernel,
                                            tol), 0.0)
        qln = jnp.roll(bp.PxL_q, -1, axis=-1)
        d0ln = take_plane(jnp.roll(bp.PxL_d0, -1, axis=-1), sol_r)
        aln = jnp.roll(bp.PxL_a, -1, axis=-1)
        Db = Db + jnp.where(
            mxW, aln * truncated_kernel(qln - d0ln[None], kernel, tol),
            0.0)
        # conditioned on seam earlier nbrs: down — border rows read the
        # stripe below's pipelined solutions + exchanged static edge data
        sol_d = jnp.roll(_padLp(bp.col(sols, c - (Bh - 1)), Lp),
                         (Bh - 1) * nb - Gx, axis=-1)[..., :L]
        tT = jnp.clip(t - (Bh - 1), 0, Bw - 1)
        cr = jnp.clip(c - (Bh - 1), 0, T + 1)
        hs = lax.dynamic_index_in_dim(halo_sols, cr, 0, keepdims=False)
        sol_d = jnp.where(ctx.bot_L, ctx._place_bot(hs), sol_d)
        Q_sel = take_plane(QA_c[1], sol_d)
        Db = Db + jnp.where(
            myT, aA_c[1] * truncated_kernel(Q_sel[None] - D0c, kernel,
                                            tol), 0.0)
        sh = (2 * Bh - 2 - t) * nb - Gx
        qdn = jnp.roll(bp.PyU_q, sh, axis=-1)[..., :L]
        d0dn_full = jnp.roll(bp.PyU_d0, sh, axis=-1)[..., :L]
        adn = jnp.roll(bp.PyU_a, sh, axis=-1)[..., :L]
        qb = lax.dynamic_index_in_dim(rows_q, tT, 1, keepdims=False)
        d0b = lax.dynamic_index_in_dim(rows_d0, tT, 1, keepdims=False)
        ab = lax.dynamic_index_in_dim(rows_a, tT, 0, keepdims=False)
        qdn = jnp.where(ctx.bot_L, ctx._place_bot(qb), qdn)
        d0dn_full = jnp.where(ctx.bot_L, ctx._place_bot(d0b), d0dn_full)
        adn = jnp.where(ctx.bot_L, ctx._place_bot(ab), adn)
        d0dn = take_plane(d0dn_full, sol_d)
        Db = Db + jnp.where(
            myT, adn * truncated_kernel(qdn - d0dn[None], kernel, tol),
            0.0)

        # messages on later edges
        Ac = bp.col(MA, c)
        Bn = bp.col(MB, c + 1)
        Di = Db + Ac[0] + Ac[1] + Bn[0] + _supb(Bn[1], nb)
        Di = Di + jnp.where(mx0, SxL + jnp.roll(SxR, 1, axis=-1), 0.0)
        Di = Di + jnp.where(my0, syu0 + syd0, 0.0)

        sol = jnp.argmin(Di, axis=0).astype(jnp.int32)
        E = E + jnp.sum(
            jnp.where(pix_c > 0, take_plane(Db, sol), 0.0), dtype=acc_t)
        sols = _set_col(sols, c, sol)
        # pipeline the just-decoded top-row pD solutions up to the stripe
        # above (consumed there at step t + Bh - 1)
        slab = ctx._pp(sol[: Gx], ctx.perm_up)
        halo_sols = lax.dynamic_update_slice(halo_sols, slab[None], (c, 0))
        return (sols, E, halo_sols), None

    sols0 = jnp.zeros((T + 2, spec.L), jnp.int32)
    halo0 = jnp.zeros((T + 2, Gx), jnp.int32)
    carry0 = ctx.vary((sols0, jnp.zeros((), acc_t), halo0))
    (sols, E, _), _ = lax.scan(step, carry0, jnp.arange(T))
    labels = from_cols(sols.astype(bp.dtype), spec).astype(jnp.int32)
    return labels, E


def sharded_banded_run(
    mesh: Mesh,
    unary: jax.Array,  # [K, H, W]
    positions: jax.Array,  # D0 [K, H, W]
    nbr_positions: jax.Array,  # Q [4, K, H, W]
    alphas: jax.Array,  # [4, H, W]
    *,
    kernel: int,
    tol,
    Bh: int,
    Bw: int,
    sweeps: int,
    decode_every: int | None = None,
    messages: jax.Array | None = None,
    axis: str = "y",
) -> TRWSResult:
    """Banded TRW-S over gy stripes of a 1-D device mesh.

    Fixed-budget chunk semantics matching BandedRun.run: ``sweeps`` passes,
    decoding every ``decode_every`` and keeping the best labeling seen.
    Labels and messages are bitwise-identical to the single-device
    solver/run; energy and lower bound agree to reassociation (psum of
    per-stripe partials).  Requires ceil(H/Bh) % n_stripes == 0 so every
    stripe holds the same number of whole block-rows.

    Batched inputs ([B, K, H, W] etc.) distribute stereo pairs over the
    mesh's 'batch' axis (B must equal its size) with each pair's stripes
    over ``axis`` — the (2, 4)-mesh flavor of the pooled drivers.
    """
    batched = unary.ndim == 4
    if batched:
        B = int(unary.shape[0])
        if "batch" not in mesh.axis_names or int(mesh.shape["batch"]) != B:
            raise ValueError(
                f"batched solve needs a 'batch' mesh axis of size {B}")
    K, H, W = unary.shape[-3:]
    dtype = unary.dtype
    n = int(mesh.shape[axis])
    Gy = -(-H // Bh)
    if Gy % n != 0:
        raise ValueError(
            f"ceil(H/Bh) = {Gy} block-rows not divisible by the mesh "
            f"'{axis}' axis ({n}); pick Bh so stripes get whole block-rows")
    Gyl = Gy // n
    Hl = Gyl * Bh
    Hp = Gy * Bh
    if decode_every is None or decode_every >= sweeps:
        decode_every = sweeps
    sweeps = (sweeps // decode_every) * decode_every
    n_seg = sweeps // decode_every
    spec_l = BandedSpec(Hl, W, Bh, Bw)

    def padH(a):
        pads = [(0, 0)] * (a.ndim - 2) + [(0, Hp - H), (0, 0)]
        return jnp.pad(a, pads)

    if messages is None:
        mshape = ((B, 4, K, H, W) if batched else (4, K, H, W))
        messages = jnp.zeros(mshape, dtype)

    def stripe_fn(u, d0, q, al, msgs):
        idx = lax.axis_index(axis)
        row0 = idx * Hl
        stripe = (row0, H, idx > 0, idx < n - 1)
        bp = _BandedProblem(u, d0, q, al, spec_l, kernel, tol,
                            stripe=stripe)
        vary_axes = (("batch", axis) if batched else (axis,))
        ctx = _StripeCtx(bp, axis, n, vary_axes=vary_axes)
        state = messages_to_state(msgs, bp)
        acc = _acc_t(bp)

        def segment(carry, _):
            state, bestE, bestL = carry
            state, lbs = lax.scan(lambda s, _: _sweep(ctx, s), state,
                                  jnp.arange(decode_every))
            labels, E = _decode(ctx, state)
            Eg = lax.psum(E, axis)
            better = Eg < bestE
            bestE = jnp.where(better, Eg, bestE)
            bestL = jnp.where(better, labels, bestL)
            return (state, bestE, bestL), lbs[-1]

        # bestE is psum-derived over the stripe axis on every path, so it
        # stays 'y'-invariant through the scan (shard_map infers the out
        # spec from that) — but under a ('batch', 'y') mesh it still varies
        # per pair; bestL is the device's own stripe and stays varying.
        big = jnp.asarray(jnp.inf, acc)
        extra = tuple(a for a in ctx.vary_axes if a != axis)
        if extra:
            big = lax.pcast(big, extra, to="varying")
        lab0 = jnp.zeros((Hl, W), jnp.int32)
        carry0 = (state, big, ctx.vary(lab0))
        (state, bestE, bestL), lbs = lax.scan(
            segment, carry0, jnp.arange(n_seg))
        lb = lax.psum(lbs[-1], axis)
        return bestL, bestE, lb, state_to_messages(state, bp)

    if batched:
        # one pair per 'batch' row; the local slice has a leading axis of 1
        def fn(u, d0, q, al, msgs):
            L, E, lb_, M = stripe_fn(u[0], d0[0], q[0], al[0], msgs[0])
            return L[None], E[None], lb_[None], M[None]

        in_specs = (P("batch", None, axis, None),
                    P("batch", None, axis, None),
                    P("batch", None, None, axis, None),
                    P("batch", None, axis, None),
                    P("batch", None, None, axis, None))
        out_specs = (P("batch", axis, None), P("batch"), P("batch"),
                     P("batch", None, None, axis, None))
    else:
        fn = stripe_fn
        in_specs = (P(None, axis, None), P(None, axis, None),
                    P(None, None, axis, None), P(None, axis, None),
                    P(None, None, axis, None))
        out_specs = (P(axis, None), P(), P(), P(None, None, axis, None))
    sharded = jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                            out_specs=out_specs)
    with mesh:
        labels, energy, lb, msgs = jax.jit(sharded)(
            padH(unary), padH(positions), padH(nbr_positions), padH(alphas),
            padH(messages))
    return TRWSResult(labels[..., :H, :], energy, lb,
                      jnp.asarray(sweeps, jnp.int32), msgs[..., :H, :])
