"""Binary fusion moves on the pixel grid.

The reference solves each binary fusion with QPBO roof duality
(rd.m, rd_mex.cpp:55-100) and keeps the current label where QPBO leaves nodes
unlabelled, so a fusion never increases the energy (property P2,
imrender/vgg/vgg_qpbo.m:14-17).

Design: a fusion move is a 2-label MRF whose pairwise terms are in
the *same* truncated-distance family as the multi-label problem —
V(a, b) = w * min(|d_a(tail @ head) - d_b(head @ head)|^k, tol)
(all_pairwise_costs, dispmap_super.m:236-262) — so checkerboard TRW-S doubles
as the fusion solver with K = 2.  For binary pairwise MRFs the TRW-S dual
optimum coincides with the roof-duality (QPBO) bound, so at convergence the
lower bound matches.

K = 2 specialization (vs the generic solvers/trws.py): a normalized 2-vector
message has one degree of freedom, so each directed-edge buffer is a single
signed plane ``md`` with (msg0, msg1) = (relu(-md), relu(md)); the 2x2
pairwise tables are precomputed once per move as 16 [H, W] planes.  Every
phase is then a short chain of elementwise min/add ops on [H, W] planes that
XLA fuses into a handful of memory passes — no K loop, no kernel needed,
and half the message bandwidth.  The math is the exact checkerboard TRW-S of
solvers/trws.py (same ordering, same gammas, same stopping rule).

Move acceptance — the per-pixel persistency analog (rd_mex.cpp:68-92): QPBO
labels a strict subset of pixels (autarky) and always improves.  Here the
decoded labeling's "take" mask is split into 4-connected components; because
distinct components share no edge, the energy delta of flipping each
component is independent and exactly additive, so we accept exactly the
components whose delta is <= 0.  This dominates both whole-image
accept/reject and QPBO's keep-current-on-unlabelled completion quality-wise
on the decoded labeling, and preserves the never-increase invariant by
construction.

An exact CPU QPBO oracle (stereo_tpu/native) backs parity tests and offers a
bit-faithful host path (solvers/qpbo_host).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from stereo_tpu import geometry
from stereo_tpu.energy import truncated_kernel
from stereo_tpu.geometry import NUM_DIRS, OPP
from stereo_tpu.solvers import trws


class FusionResult(NamedTuple):
    take: jax.Array  # [H, W] bool: where to adopt the proposal
    energy: jax.Array  # energy of the accepted configuration
    lower_bound: jax.Array  # TRW-S/roof-duality style lower bound
    iterations: jax.Array


def fusion_problem(
    current_planes: jax.Array,
    proposal_planes: jax.Array,
    normalize: tuple | None = None,
):
    """Build the K=2 label geometry for a fusion move.

    Returns (D0 [2,H,W], Q [4,2,H,W]): label 0 = current, 1 = proposal;
    positions are the continuous disparities entering the pairwise terms.
    """

    def norm(x):
        if normalize is None:
            return x
        return (x - normalize[0]) / normalize[1]

    def own(planes):
        return norm(geometry.own_disparity(planes))

    def nbr(planes, d):
        return norm(geometry.neighbor_plane_disparity(planes, d, fill=0.0))

    D0 = jnp.stack([own(current_planes), own(proposal_planes)], axis=0)
    Q = jnp.stack(
        [
            jnp.stack([nbr(current_planes, d), nbr(proposal_planes, d)], axis=0)
            for d in range(geometry.NUM_DIRS)
        ],
        axis=0,
    )
    return D0, Q


def _tables(D0, Q, alphas, kernel, tol):
    """Per-direction 2x2 pairwise tables V[d][i, j] = alpha_d * TR(|Q_i - D0_j|).

    i = tail label, j = head label.  Shape [4, 2, 2, H, W]; zero at invalid
    border edges because alphas is zero there.
    """
    V = []
    for d in range(NUM_DIRS):
        rows = []
        for i in range(2):
            rows.append(jnp.stack(
                [alphas[d] * truncated_kernel(Q[d, i] - D0[j], kernel, tol)
                 for j in range(2)], axis=0))
        V.append(jnp.stack(rows, axis=0))
    return jnp.stack(V, axis=0)


def _split(md):
    """Signed message plane -> (msg0, msg1), both >= 0 with min = 0."""
    zero = jnp.zeros((), md.dtype)
    return jnp.maximum(-md, zero), jnp.maximum(md, zero)


def _beliefs(theta0, theta1, M):
    """Beliefs (D0b, D1b): theta + all 8 incident buffers (trws._node_beliefs)."""
    D0b, D1b = theta0, theta1
    for d in range(NUM_DIRS):
        m0, m1 = _split(M[d])
        D0b = D0b + m0
        D1b = D1b + m1
        o0, o1 = _split(geometry.shift_from_neighbor(M[OPP[d]], d, fill=0.0))
        D0b = D0b + o0
        D1b = D1b + o1
    return D0b, D1b


def _k2_phase(theta0, theta1, M, V, gamma, valid, phase_mask, accumulate_lb):
    """One checkerboard half-iteration at K=2 (mirrors trws._phase)."""
    dtype = theta0.dtype
    acc_t = jnp.promote_types(dtype, jnp.float32)
    D0b, D1b = _beliefs(theta0, theta1, M)

    lb_nodes = jnp.zeros((), acc_t)
    if accumulate_lb:
        vminD = jnp.minimum(D0b, D1b)
        D0b = D0b - vminD
        D1b = D1b - vminD
        lb_nodes = jnp.sum(jnp.where(phase_mask, vminD, 0.0), dtype=acc_t)

    gD0 = gamma * D0b
    gD1 = gamma * D1b

    newM = []
    lb_msgs = jnp.zeros((), acc_t)
    for d in range(NUM_DIRS):
        m0, m1 = _split(M[d])
        # variant B (source = head p): msg[i] = min_j(gD_j - m_j + V[i, j])
        HB0 = gD0 - m0
        HB1 = gD1 - m1
        bmsg0 = jnp.minimum(HB0 + V[d, 0, 0], HB1 + V[d, 0, 1])
        bmsg1 = jnp.minimum(HB0 + V[d, 1, 0], HB1 + V[d, 1, 1])
        # variant A (source = tail n): msg[j] = min_i(gD'_i - m_i + V[i, j])
        HA0 = geometry.shift_from_neighbor(gD0, d, fill=0.0) - m0
        HA1 = geometry.shift_from_neighbor(gD1, d, fill=0.0) - m1
        amsg0 = jnp.minimum(HA0 + V[d, 0, 0], HA1 + V[d, 1, 0])
        amsg1 = jnp.minimum(HA0 + V[d, 0, 1], HA1 + V[d, 1, 1])

        msg0 = jnp.where(phase_mask, bmsg0, amsg0)
        msg1 = jnp.where(phase_mask, bmsg1, amsg1)
        vmin = jnp.minimum(msg0, msg1)
        md = (msg1 - msg0) * valid[d]
        newM.append(md)
        if accumulate_lb:
            lb_msgs = lb_msgs + jnp.sum(
                jnp.where(valid[d] > 0, vmin, 0.0), dtype=acc_t)
    return jnp.stack(newM, axis=0), lb_nodes + lb_msgs


def _k2_decode(theta0, theta1, M, V, cb):
    """Greedy conditioned decode (mirrors trws._decode at K=2)."""
    D0b, D1b = _beliefs(theta0, theta1, M)
    z_black = D1b < D0b

    cost0, cost1 = theta0, theta1
    for d in range(NUM_DIRS):
        zn = geometry.shift_from_neighbor(z_black, d, fill=False)
        # in-edge E(p, d): V(z_n, j)
        cost0 = cost0 + jnp.where(zn, V[d, 1, 0], V[d, 0, 0])
        cost1 = cost1 + jnp.where(zn, V[d, 1, 1], V[d, 0, 1])
        # out-edge E(n, OPP(d)) at neighbor n: V[OPP(d)](i, z_black(n'))
        t0 = jnp.where(z_black, V[OPP[d], 0, 1], V[OPP[d], 0, 0])
        t1 = jnp.where(z_black, V[OPP[d], 1, 1], V[OPP[d], 1, 0])
        cost0 = cost0 + geometry.shift_from_neighbor(t0, d, fill=0.0)
        cost1 = cost1 + geometry.shift_from_neighbor(t1, d, fill=0.0)
    z_white = cost1 < cost0
    return jnp.where(cb == 0, z_black, z_white)


def _k2_energy(z, theta0, theta1, V):
    """Exact energy of a 0/1 labeling under the precomputed tables."""
    acc_t = jnp.promote_types(theta0.dtype, jnp.float32)
    E = jnp.sum(jnp.where(z, theta1, theta0), dtype=acc_t)
    for d in range(NUM_DIRS):
        zn = geometry.shift_from_neighbor(z, d, fill=False)
        c = jnp.where(
            zn,
            jnp.where(z, V[d, 1, 1], V[d, 1, 0]),
            jnp.where(z, V[d, 0, 1], V[d, 0, 0]),
        )
        E = E + jnp.sum(c, dtype=acc_t)
    return E


def _shift_in(v, k, axis, fill):
    """Bring ``v[i - k]`` to position ``i`` along ``axis`` (k may be
    negative); vacated entries get ``fill``.  Slice + pad, no wrap."""
    n = v.shape[axis]
    if k >= 0:
        s = jax.lax.slice_in_dim(v, 0, n - k, axis=axis)
        pads = [(0, 0)] * v.ndim
        pads[axis] = (k, 0)
    else:
        s = jax.lax.slice_in_dim(v, -k, n, axis=axis)
        pads = [(0, 0)] * v.ndim
        pads[axis] = (0, -k)
    return jnp.pad(s, pads, constant_values=fill)


def _segmented_min_scan(m, live, axis, reverse):
    """Running min of ``m`` within contiguous runs of ``live`` along ``axis``.

    Dead (not live) entries break runs.  Associative monoid on (min, wall):
    combine(a, b) = (b.wall ? b.min : min(a.min, b.min), a.wall | b.wall),
    computed by explicit shift-doubling — identical results to
    ``lax.associative_scan`` over that monoid, but each of the log2(n) steps
    is two padded shifts + select/min (XLA fuses them into one pass),
    instead of the scan's slice/concat recursion (~3x the wall-clock of this
    form in the connected-components flood, the dominant cost of a fusion
    move's per-component acceptance).
    """
    big = (jnp.iinfo(m.dtype).max if jnp.issubdtype(m.dtype, jnp.integer)
           else jnp.inf)
    v = m
    b = ~live
    n = m.shape[axis]
    k = 1
    d = -1 if reverse else 1
    while k < n:
        # prefix contribution from distance k: identity (big, False) when
        # out of range, so border lanes keep their value
        vs = _shift_in(v, d * k, axis, big)
        bs = _shift_in(b, d * k, axis, False)
        v = jnp.where(b, v, jnp.minimum(v, vs))
        b = b | bs
        k *= 2
    return v


def connected_components(z: jax.Array) -> jax.Array:
    """4-connected component ids of a boolean mask.

    Returns [H, W] int32: for z pixels, the smallest flat pixel index in the
    component; H*W elsewhere.  Each round floods the current min id along
    entire rows and columns via segmented scans (elementwise work, no gathers
    or scatters, instead of the classic pointer-jumping formulation);
    converges in O(#bends of the windiest component) rounds, which
    is 1-3 for real fusion take-masks.
    """
    H, W = z.shape
    N = H * W
    idx = jnp.arange(N, dtype=jnp.int32).reshape(H, W)
    comp0 = jnp.where(z, idx, N)

    def flood(comp):
        for axis in (1, 0):
            for reverse in (False, True):
                s = _segmented_min_scan(comp, z, axis, reverse)
                comp = jnp.where(z, jnp.minimum(comp, s), N)
        return comp

    def not_uniform(comp):
        bad = jnp.zeros((), bool)
        for d in range(NUM_DIRS):
            zn = geometry.shift_from_neighbor(z, d, fill=False)
            cn = geometry.shift_from_neighbor(comp, d, fill=N)
            bad = bad | jnp.any(z & zn & (comp != cn))
        return bad

    # Cap the rounds at H + W (covers any spiral; real masks take 1-3).  An
    # early exit can split a component into edge-adjacent pieces — still safe:
    # accept_components then decides the pieces independently, and the
    # never-increase backstop in binary_fuse guards the (pathological) case
    # where that split accept would be worse than keeping the incumbent.
    comp = flood(comp0)
    comp, _, _ = jax.lax.while_loop(
        lambda state: state[1] & (state[2] < H + W),
        lambda state: (lambda c: (c, not_uniform(c), state[2] + 1))(
            flood(state[0])),
        (comp, not_uniform(comp), jnp.zeros((), jnp.int32)),
    )
    return comp


def _segment_verdicts_sorted(comp_flat, delta_flat, acc_t):
    """Per-pixel verdict (segment sum <= 0) via sort + segmented scans.

    Sums in a fixed association order, unlike a scatter-add (atomics in no
    fixed order on a GPU), so verdicts are reproducible and sharded ==
    single-device bitwise (parallel/fusion_dist.py):

      1. sort (comp, delta, iota) by comp
      2. within-segment prefix sums via a segmented associative scan
      3. broadcast each segment's total backward (reverse segmented max)
      4. scatter the per-element verdicts back through the sort permutation
         (unique indices — no collisions)
    """
    N = comp_flat.shape[0]
    idx = jnp.arange(N, dtype=jnp.int32)
    skeys, svals, sidx = jax.lax.sort(
        (comp_flat, delta_flat.astype(acc_t), idx), num_keys=1)
    starts = jnp.concatenate(
        [jnp.ones((1,), bool), skeys[1:] != skeys[:-1]])

    def seg_sum(a, b):  # segmented +: reset at segment starts
        (fa, va), (fb, vb) = a, b  # flags: "segment boundary inside span"
        return fa | fb, jnp.where(fb, vb, va + vb)

    _, pref = jax.lax.associative_scan(seg_sum, (starts, svals))
    # segment total = prefix at the segment's END; broadcast backward with a
    # reverse segmented copy (carry the rightmost value until a boundary)
    ends = jnp.concatenate([skeys[1:] != skeys[:-1], jnp.ones((1,), bool)])

    def seg_copy(a, b):
        (fa, va), (fb, vb) = a, b
        return fa | fb, jnp.where(fb, vb, va)

    _, total = jax.lax.associative_scan(
        seg_copy, (ends[::-1], jnp.where(ends, pref, 0.0)[::-1]))
    total = total[::-1]
    good_sorted = total <= 0.0
    return jnp.zeros((N,), bool).at[sidx].set(good_sorted,
                                              mode="promise_in_bounds")


def accept_components(z, theta0, theta1, V, method: str | None = None):
    """Filter a decoded take-mask to its energy-improving components.

    Flipping a 4-connected component S of ``z`` changes the energy by a sum
    of per-pixel unary deltas plus per-edge deltas; distinct components share
    no edge, so the deltas are independent.  Returns (take, n_components
    accepted implicitly via the mask).

    ``method``: 'sort' (sort + segmented scans + one permutation scatter,
    fixed summation order; see _segment_verdicts_sorted) or 'scatter' (one
    scatter-add segment sum + verdict gather, whose float atomics on a GPU
    add in no fixed order).  'sort' is the default: measured on an H100 in
    the teddy NCC fusion sweep it is also the faster of the two.
    """
    if method is None:
        method = "sort"
    H, W = z.shape
    N = H * W
    comp = connected_components(z)
    acc_t = jnp.promote_types(theta0.dtype, jnp.float32)

    # Fold every contribution into ONE per-pixel delta map owned by a z
    # pixel, so a single segment sum produces the component sums:
    #   - a z pixel owns its unary delta and all incident edge deltas,
    #   - an edge whose head keeps but whose tail flips is pushed back to
    #     the tail pixel (the only flipping endpoint) elementwise.
    delta = jnp.where(z, theta1 - theta0, 0.0).astype(acc_t)
    for d in range(NUM_DIRS):
        zn = geometry.shift_from_neighbor(z, d, fill=False)
        c = jnp.where(
            zn,
            jnp.where(z, V[d, 1, 1], V[d, 1, 0]),
            jnp.where(z, V[d, 0, 1], V[d, 0, 0]),
        )
        dE = (c - V[d, 0, 0]).astype(acc_t)
        delta = delta + jnp.where(z, dE, 0.0)
        push = jnp.where(jnp.logical_and(~z, zn), dE, 0.0)
        # out[p + DIRS[d]] = push[p]: the inverse shift brings the delta to
        # the tail pixel
        delta = delta + geometry.shift_from_neighbor(push, OPP[d], fill=0.0)

    if method == "sort":
        good_px = _segment_verdicts_sorted(comp.reshape(-1),
                                           delta.reshape(-1), acc_t)
        return z & good_px.reshape(H, W)
    # comp is always in [0, N] by construction: promise_in_bounds lets XLA
    # drop the clamp logic from the scatter-add and the verdict gather
    sums = jnp.zeros((N + 1,), acc_t).at[comp.reshape(-1)].add(
        delta.reshape(-1), mode="promise_in_bounds")
    good = sums <= 0.0
    return z & good.at[comp].get(mode="promise_in_bounds")


def icm_polish(z, theta0, theta1, V, cb, n_sweeps: int):
    """Checkerboard ICM on a take-mask: set every phase-color pixel to its
    exact conditional argmin given the (fixed) opposite color.

    The data-parallel analog of QPBO-I's randomized fix-and-resolve
    (QPBO_extra.cpp:1152-1225 via rd_mex.cpp:84-96): QPBO-I fixes a node
    subset and resolves the rest optimally; here each phase fixes one
    checkerboard color and resolves every pixel of the other exactly, so
    the energy is non-increasing per phase (no two resolved pixels share an
    edge).  Polishes the near-tie frustrated cores the TRW-S decode can
    leave suboptimal (measured: closes the worst device-vs-QPBO-I energy
    gap in the fuzz family of tests/test_fusion_cross_check.py)."""
    d_unary = theta1 - theta0

    def phase(z, color_mask):
        delta = d_unary
        for d in range(NUM_DIRS):
            zn = geometry.shift_from_neighbor(z, d, fill=False)
            # in-edge E(p, d): head p flips, tail fixed at zn
            delta = delta + jnp.where(zn, V[d, 1, 1] - V[d, 1, 0],
                                      V[d, 0, 1] - V[d, 0, 0])
            # out-edge at q = p - DIRS[d] (p is its tail; head fixed at z_q)
            g = jnp.where(z, V[d, 1, 1] - V[d, 0, 1],
                          V[d, 1, 0] - V[d, 0, 0])
            delta = delta + geometry.shift_from_neighbor(g, OPP[d], fill=0.0)
        return jnp.where(color_mask, delta < 0, z)

    for _ in range(n_sweeps):
        z = phase(z, cb == 0)
        z = phase(z, cb == 1)
    return z


def _edge_cost(Vd, zn, z):
    """Directed-edge cost V[d][tail=zn, head=z] for boolean labelings."""
    return jnp.where(
        zn,
        jnp.where(z, Vd[1, 1], Vd[1, 0]),
        jnp.where(z, Vd[0, 1], Vd[0, 0]),
    )


def _attributed_cost(z, theta0, theta1, V, in_blk):
    """Per-pixel cost map whose sum over any pixel set S = in_blk counts
    every edge touching S exactly once: head-in edges at the head (internal
    edges included once there), tail-in/head-out edges at the tail."""
    c = jnp.where(z, theta1, theta0)
    for d in range(NUM_DIRS):
        zn = geometry.shift_from_neighbor(z, d, fill=False)
        ec = _edge_cost(V[d], zn, z)
        c = c + jnp.where(in_blk, ec, 0.0)
        in_n = geometry.shift_from_neighbor(in_blk, d, fill=False)
        push = jnp.where(jnp.logical_and(~in_blk, in_n), ec, 0.0)
        c = c + geometry.shift_from_neighbor(push, OPP[d], fill=0.0)
    return c


def _block_resolve_aligned(z, theta0, theta1, V, par):
    """Exactly resolve every (0,0)-aligned 2x2 block of parity ``par``:
    each active block picks the best of its 16 cell patterns given the rest
    of the labeling fixed.  Blocks of one parity share no 4-edges (adjacent
    blocks differ by 1 in block coordinates), so the simultaneous argmin is
    the exact conditional optimum and never increases the energy.  H, W
    must be even (block_polish pads)."""
    H, W = z.shape
    ys = jnp.arange(H)[:, None] // 2
    xs = jnp.arange(W)[None, :] // 2
    cell = (jnp.arange(H)[:, None] % 2) * 2 + jnp.arange(W)[None, :] % 2
    active = (ys + xs) % 2 == par
    sums = []
    for p in range(16):
        bit = (p >> cell) & 1
        zp = jnp.where(active, bit == 1, z)
        ac = jnp.where(active,
                       _attributed_cost(zp, theta0, theta1, V, active), 0.0)
        sums.append(ac.reshape(H // 2, 2, W // 2, 2).sum(axis=(1, 3)))
    pbest = jnp.argmin(jnp.stack(sums, 0), axis=0).astype(jnp.int32)
    pb = jnp.repeat(jnp.repeat(pbest, 2, axis=0), 2, axis=1)
    bit = (pb >> cell) & 1
    return jnp.where(active, bit == 1, z)


def block_polish(z, theta0, theta1, V, rounds: int = 1):
    """Exact 2x2-block resolve over a block-checkerboard, all 4 offsets.

    The data-parallel analog of QPBO-I's fix-and-resolve on node *subsets*
    (QPBO_extra.cpp:1152-1225): where icm_polish resolves single pixels,
    this resolves every 2x2 window (at each of the 4 alignments) exactly —
    capturing the multi-pixel frustrated cores single-pixel ICM cannot
    leave (ROADMAP round-4: device < QPBO-I on 45/48 fuzz instances; with
    one block_polish round it matches or beats QPBO-I on 48/48, closing
    the former worst case +0.69%).  Monotone by construction: every phase
    is an exact conditional argmin over non-adjacent blocks.  Its fixed
    points are also single-flip optimal (Hamming-1 patterns are among the
    16), so it subsumes an ICM sweep.
    """
    H, W = z.shape
    for _ in range(rounds):
        for oy in (0, 1):
            for ox in (0, 1):
                Hp = -(-(H + oy) // 2) * 2
                Wp = -(-(W + ox) // 2) * 2
                pads = ((oy, Hp - H - oy), (ox, Wp - W - ox))
                # zero-padding V makes pad-edges free and pad unaries equal,
                # so padded cells ride in their blocks at zero cost
                pz = jnp.pad(z, pads)
                pt0 = jnp.pad(theta0, pads)
                pt1 = jnp.pad(theta1, pads)
                pV = jnp.pad(V, [(0, 0)] * 3 + list(pads))
                for par in (0, 1):
                    pz = _block_resolve_aligned(pz, pt0, pt1, pV, par)
                z = pz[oy:oy + H, ox:ox + W]
    return z


def binary_fuse(
    unary0: jax.Array,  # [H, W] unary cost of keeping the current label
    unary1: jax.Array,  # [H, W] unary cost of taking the proposal
    D0: jax.Array,  # [2, H, W] from fusion_problem
    Q: jax.Array,  # [4, 2, H, W]
    alphas: jax.Array,  # [4, H, W]
    *,
    kernel: int,
    tol,
    maxiter: int = 50,
    max_relgap: float = 1e-6,
    current_energy: jax.Array | None = None,
    check_every: int = 5,
    improve: int = 0,
    accept_method: str | None = None,
) -> FusionResult:
    """One fusion move; never increases the energy.

    The never-increase guarantee is enforced unconditionally: the energy of
    keeping the incumbent (all-False take) is one extra table evaluation, and
    the whole move reverts whenever the accepted configuration would exceed
    it — this covers both f32 rounding of the per-component sums and the
    (pathological) case where the connected-component flood hits its round
    cap and splits a component into edge-adjacent pieces whose deltas were
    computed jointly.  ``current_energy``, when provided, additionally caps
    the reported energy at the caller's incumbent value (API compatibility).
    ``improve`` > 0 runs that many checkerboard-ICM polish sweeps on the
    decoded mask before acceptance (the rd_mex QPBO-I analog;
    rd_mex.cpp:84-96).
    """
    H, W = unary0.shape
    dtype = unary0.dtype
    theta0, theta1 = unary0, unary1
    V = _tables(D0, Q, alphas, kernel, tol)
    cb = trws.checkerboard(H, W)
    gamma = trws.node_gamma(H, W, dtype)
    valid = jnp.stack(
        [geometry.valid_mask(H, W, d, dtype=dtype) for d in range(NUM_DIRS)], 0)
    black = cb == 0
    white = cb == 1

    M0 = jnp.zeros((NUM_DIRS, H, W), dtype)
    acc_t = jnp.promote_types(dtype, jnp.float32)

    def sweep(_, carry):
        M, _ = carry
        M, _ = _k2_phase(theta0, theta1, M, V, gamma, valid, black,
                         accumulate_lb=False)
        M, lb = _k2_phase(theta0, theta1, M, V, gamma, valid, white,
                          accumulate_lb=True)
        return M, lb

    def one_check(M):
        if check_every == 1:
            M, lb_sweep = sweep(0, (M, jnp.zeros((), acc_t)))
        else:
            M, lb_sweep = jax.lax.fori_loop(
                0, check_every, sweep, (M, jnp.zeros((), acc_t)))
        # blacks contribute their belief minima (trws.solve one_iteration)
        D0b, D1b = _beliefs(theta0, theta1, M)
        lb_black = jnp.sum(
            jnp.where(black, jnp.minimum(D0b, D1b), 0.0), dtype=acc_t)
        lb = lb_sweep + lb_black
        z = _k2_decode(theta0, theta1, M, V, cb)
        energy = _k2_energy(z, theta0, theta1, V)
        return M, energy, lb, z

    def cond(state):
        M, it, energy, lb, z = state
        relgap = jnp.where(energy != 0, (energy - lb) / energy, 0.0)
        return jnp.logical_and(
            it < maxiter, jnp.logical_or(it == 0, relgap >= max_relgap))

    def body(state):
        M, it, _, _, _ = state
        M, energy, lb, z = one_check(M)
        return (M, it + check_every, energy, lb, z)

    zero = jnp.zeros((), acc_t)
    state0 = (M0, jnp.zeros((), jnp.int32), zero, zero,
              jnp.zeros((H, W), bool))
    M, iters, _, lb, z = jax.lax.while_loop(cond, body, state0)

    if improve:
        z = icm_polish(z, theta0, theta1, V, cb, improve)
        # exact 2x2-block resolve: reaches the multi-pixel frustrated cores
        # single-pixel ICM cannot (matches or beats host QPBO-I on the full
        # fuzz family — see block_polish)
        z = block_polish(z, theta0, theta1, V, rounds=1)
    # per-component acceptance: flip exactly the improving components.
    # ``accept_method`` pins the verdict path ('sort' = reassociation-free
    # segmented scans — required for the sharded == single-device bitwise
    # guarantee of parallel/fusion_dist.py); None = the default ('sort').
    take = accept_components(z, theta0, theta1, V, method=accept_method)
    energy = _k2_energy(take, theta0, theta1, V)
    # unconditional never-increase backstop (see docstring): revert to the
    # incumbent whenever the accepted configuration is worse than keeping it
    e_keep = _k2_energy(jnp.zeros_like(take), theta0, theta1, V)
    incumbent = e_keep if current_energy is None else jnp.minimum(
        e_keep, jnp.asarray(current_energy, e_keep.dtype))
    worse = energy > incumbent
    take = jnp.where(worse, jnp.zeros_like(take), take)
    energy = jnp.where(worse, e_keep, energy)
    return FusionResult(take, energy, lb, iters)
