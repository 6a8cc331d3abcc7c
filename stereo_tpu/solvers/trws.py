"""Bipartite (checkerboard) TRW-S for simultaneous fusion on the pixel grid.

Data-parallel re-design of the reference's sequential TRW-S
(cpp/trw-s/minimize.cpp:31-116, typeStereoLinear.h:329-487,
typeStereoQuadratic.h).  Key idea: the 4-connected grid is bipartite; choosing
the node ordering "all black (y+x even) before all white" makes every
monotonic chain a single edge, and TRW-S's forward/backward sweeps collapse
into two *fully parallel* phases:

  forward  = every edge updates its message from its black endpoint,
  backward = every edge updates its message from its white endpoint,

with the per-node weights gamma = 1/max(nForward, nBackward)
(treeProbabilities.cpp:12-47) becoming gamma(p) = 1 / (2 * #neighbors(p))
(each neighbor pair carries two directed edges, one per measurement endpoint —
see stereo_tpu.energy).  This is *exactly* TRW-S for that ordering (no
approximation): within a phase no two updated nodes are adjacent, so the
parallel update equals the sequential one.  The lower bound is therefore
monotonically non-decreasing and identical in meaning to the reference's
(minimize.cpp:67-94); the stopping rule is the same
relative-gap / max-iteration test (minimize.cpp:100-112).

Potential family (the papers' custom edge type): for the directed edge
(tail n -> head p),

    V(k_n, k_p) = alpha_e * min(|Q[k_n] - D0[k_p]|^kernel, tol)

where Q[k] / D0[k] are the *continuous* disparities of label k's plane from n
resp. p evaluated at p's point.  The reference computes message updates in
O(K) with a lower-envelope distance transform over sorted positions
(typeStereoLinear.h:398-479); labels here are few (K <= ~32) while pixels are
~10^5, so the choice here is the opposite: a dense O(K^2) min-plus
reduction vectorized over all pixels — no sorts, no data-dependent loops.
(An envelope-scan path for large K can slot in behind the same interface.)

Message storage: one buffer per directed edge, M[d][k, y, x] = the message on
edge E(p, d) := (tail = neighbor of p in direction DIRS[d] -> head p), stored
at the head pixel.  Like the reference's single per-edge vector
(typeStereoLinear.h:274-311), its index meaning alternates: after the black
phase every buffer is a function of its white endpoint's labels and vice
versa.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from stereo_tpu import geometry
from stereo_tpu.energy import truncated_kernel
from stereo_tpu.geometry import DIRS, NUM_DIRS, OPP, take_plane


# Checkerboard H-compaction default (ops/checker.py), set from the H100
# measurement of compact against full-grid sweeps at K=15 and K=79.
COMPACT_DEFAULT = True


class TRWSResult(NamedTuple):
    labels: jax.Array  # [H, W] int32, argmin label per pixel
    energy: jax.Array  # scalar: energy of the decoded labeling
    lower_bound: jax.Array  # scalar: TRW-S dual lower bound
    iterations: jax.Array  # scalar int32
    messages: jax.Array  # [4, K, H, W] final message state


def checkerboard(H: int, W: int) -> jax.Array:
    """[H, W] int32: 0 for black (y+x even, processed first), 1 for white."""
    ys = jnp.arange(H)[:, None]
    xs = jnp.arange(W)[None, :]
    return ((ys + xs) % 2).astype(jnp.int32)


def node_gamma(H: int, W: int, dtype=jnp.float32) -> jax.Array:
    """gamma(p) = 1 / (2 * #neighbors(p)): the monotonic-chain weight.

    With the bipartite ordering every incident directed edge of a node points
    the same way, so max(nFwd, nBwd) = #incident edges = 2 * #neighbors.
    """
    deg = jnp.zeros((H, W), dtype)
    for d in range(NUM_DIRS):
        deg = deg + geometry.valid_mask(H, W, d, dtype=dtype)
    return 1.0 / (2.0 * deg)


def _node_beliefs(theta: jax.Array, M: jax.Array) -> jax.Array:
    """theta + sum of all 8 incident message buffers, for every pixel.

    Valid only at pixels whose incident buffers currently point *into* them;
    callers mask by checkerboard color.
    """
    D = theta
    for d in range(NUM_DIRS):
        # in-edge buffers E(p, d) live at p
        D = D + M[d]
        # out-edge buffers E(n, OPP(d)) live at the neighbor n = p + DIRS[d]
        D = D + geometry.shift_from_neighbor(M[OPP[d]], d, fill=0.0)
    return D


def _phase(theta, M, D0, Q, alphas, valid, gamma, cb, color, kernel, tol,
           accumulate_lb):
    """One half-iteration: update every edge's message from its `color` endpoint.

    Returns (new_M, lb_nodes, lb_msgs); the lb terms are zero arrays unless
    accumulate_lb (the white/backward phase, minimize.cpp:67-94).
    """
    dtype = theta.dtype
    Dall = _node_beliefs(theta, M)
    phase_mask = (cb == color)

    lb_nodes = jnp.zeros((), dtype)
    if accumulate_lb:
        vminD = jnp.min(Dall, axis=0)  # [H, W]
        Dall = Dall - vminD[None]
        lb_nodes = jnp.sum(jnp.where(phase_mask, vminD, 0.0),
                           dtype=jnp.promote_types(dtype, jnp.float32))

    gD = gamma[None] * Dall  # [K, H, W]

    newM = []
    lb_msgs = jnp.zeros((), dtype)
    from stereo_tpu.ops.minplus import minplus_pair_xla

    for d in range(NUM_DIRS):
        a = alphas[d]
        # Edge E(p, d): head p, tail n = p + DIRS[d].  Exactly one endpoint has
        # the phase color.
        # Variant A — source is the tail n: H[k] = gamma_n * D_n[k] - msg[k],
        # min-plus over the tail's positions Q[d], evaluated at D0.
        # Variant B — source is the head p: evaluated at the tail's positions.
        # Both come out of one fused pass over the pairwise terms.
        H_A = geometry.shift_from_neighbor(gD, d, fill=0.0) - M[d]
        H_B = gD - M[d]
        msgA, msgB = minplus_pair_xla(H_A, H_B, Q[d], D0, a, kernel, tol)

        src_is_head = phase_mask  # head p is the source iff p has phase color
        msg = jnp.where(src_is_head[None], msgB, msgA)
        vmin = jnp.min(msg, axis=0)
        msg = (msg - vmin[None]) * valid[d][None]
        newM.append(msg.astype(M.dtype))  # keep the storage dtype (bf16 opt)
        if accumulate_lb:
            lb_msgs = lb_msgs + jnp.sum(
                jnp.where(valid[d] > 0, vmin, 0.0),
                dtype=jnp.promote_types(dtype, jnp.float32),
            )
    return jnp.stack(newM, axis=0), lb_nodes, lb_msgs


def _phase_kernel_enabled() -> bool:
    """The one platform decision of the message update: the compacted phase
    runs as the Triton kernel (ops/phase_kernel.py) on GPUs and as the XLA
    reference (_compact_messages_xla) elsewhere."""
    return jax.default_backend() == "gpu"


def _compact_messages_xla(gD, gDn, Ms, Mo, Qs, Qo, D0s, D0o, a_s, a_o, v_s,
                          v_o, tol, kernel):
    """Plain XLA compacted phase; same contract as
    ops/phase_kernel.phase_messages_compact, which it is the reference of."""
    dtype = gD.dtype
    K = gD.shape[0]
    newMs_l, newMo_l, vmins_l, vmino_l = [], [], [], []
    for d in range(NUM_DIRS):
        # variant B at s-heads: msg[i] = min_j HB[j] + a*TR(Q_i - D0_j)
        HB = gD - Ms[d].astype(dtype)
        accB = None
        for j in range(K):
            term = a_s[d][None] * truncated_kernel(Qs[d] - D0s[j][None],
                                                   kernel, tol)
            contrib = HB[j][None] + term
            accB = contrib if accB is None else jnp.minimum(accB, contrib)
        vminB = jnp.min(accB, axis=0)
        newMs_l.append((accB - vminB[None]) * v_s[d][None])
        vmins_l.append(vminB)
        # variant A at o-heads: msg[j] = min_i HA[i] + a*TR(Q_i - D0_j)
        HA = gDn[d] - Mo[d].astype(dtype)
        rows = []
        for j in range(K):
            term = a_o[d][None] * truncated_kernel(Qo[d] - D0o[j][None],
                                                   kernel, tol)
            rows.append(jnp.min(HA + term, axis=0))
        msgA = jnp.stack(rows, axis=0)
        vminA = jnp.min(msgA, axis=0)
        newMo_l.append((msgA - vminA[None]) * v_o[d][None])
        vmino_l.append(vminA)
    return (jnp.stack(newMs_l, 0).astype(Ms.dtype),
            jnp.stack(newMo_l, 0).astype(Mo.dtype),
            jnp.stack(vmins_l, 0), jnp.stack(vmino_l, 0))


def _compact_phase_args(theta2, M2, D02, Q2, alphas2, valid2, gamma2, pix2,
                        s, kernel, tol, accumulate_lb):
    """Beliefs of a compacted half-iteration: -> (message-update args,
    lb_nodes).  The args are the shared contract of
    ops/phase_kernel.phase_messages_compact and _compact_messages_xla."""
    from stereo_tpu.ops import checker

    o = 1 - s
    dtype = theta2[s].dtype
    acc_t = jnp.promote_types(dtype, jnp.float32)
    H = int(pix2[2])  # full image height rides with the pixel masks

    # beliefs at the source color
    D = theta2[s]
    for d in range(NUM_DIRS):
        D = D + M2[s][d].astype(dtype)
        D = D + checker.cshift(M2[o][OPP[d]].astype(dtype), d, s, H)

    lb_nodes = jnp.zeros((), acc_t)
    if accumulate_lb:
        vminD = jnp.min(D, axis=0)
        D = D - vminD[None]
        lb_nodes = jnp.sum(jnp.where(pix2[s] > 0, vminD, 0.0), dtype=acc_t)

    gD = gamma2[s][None] * D  # [K, Hc, W]
    gDn = jnp.stack([checker.cshift(gD, d, o, H) for d in range(NUM_DIRS)], 0)
    args = (gD, gDn, M2[s], M2[o], Q2[s], Q2[o], D02[s], D02[o], alphas2[s],
            alphas2[o], valid2[s], valid2[o], tol, kernel)
    return args, lb_nodes


def _phase_compact(theta2, M2, D02, Q2, alphas2, valid2, gamma2, pix2, s,
                   kernel, tol, accumulate_lb):
    """Compacted half-iteration (ops/checker.py layout): update every edge's
    message from its color-``s`` endpoint, each variant computed once on its
    own half-grid.  M2/theta2/... are per-absolute-color pairs; returns
    (new_M2, lb_nodes, lb_msgs)."""
    args, lb_nodes = _compact_phase_args(theta2, M2, D02, Q2, alphas2,
                                         valid2, gamma2, pix2, s, kernel,
                                         tol, accumulate_lb)
    if _phase_kernel_enabled():
        from stereo_tpu.ops.phase_kernel import phase_messages_compact

        newMs, newMo, vmins, vmino = phase_messages_compact(*args)
    else:
        newMs, newMo, vmins, vmino = _compact_messages_xla(*args)

    acc_t = lb_nodes.dtype
    lb_msgs = jnp.zeros((), acc_t)
    if accumulate_lb:
        lb_msgs = (jnp.sum(jnp.where(valid2[s] > 0, vmins, 0.0), dtype=acc_t)
                   + jnp.sum(jnp.where(valid2[1 - s] > 0, vmino, 0.0),
                             dtype=acc_t))
    new_M2 = (newMs, newMo) if s == 0 else (newMo, newMs)
    return new_M2, lb_nodes, lb_msgs


def _decode(theta, M, D0, Q, alphas, valid, cb, kernel, tol):
    """Greedy conditioned decode + exact energy of the decoded labeling.

    Mirrors ComputeSolutionAndEnergy (minimize.cpp:223-264): blacks decode from
    beliefs (all buffers point into blacks after the white phase); whites
    decode conditioned on their black neighbors' solutions.
    """
    D_black = _node_beliefs(theta, M)
    sol_black = jnp.argmin(D_black, axis=0).astype(jnp.int32)  # [H, W]

    # whites: theta + sum over the 8 incident edges of V(. , sol_neighbor)
    cost = theta
    for d in range(NUM_DIRS):
        # in-edge E(p, d): V(k_n, k_p) with k_n fixed to the neighbor's label:
        # alpha[d, p] * TR(|Q[d, sol_n, p] - D0[k, p]|)
        sol_n = geometry.shift_from_neighbor(sol_black, d, fill=0)
        Q_sel = take_plane(Q[d], sol_n)  # [H, W]
        cost = cost + alphas[d][None] * truncated_kernel(
            Q_sel[None] - D0, kernel, tol
        )
        # out-edge E(n, OPP(d)) at neighbor n: V(k_p, k_n') as function of k_p,
        # alpha[OPP(d), n] * TR(|Q[OPP(d), k, n] - D0[sol_n', n]|), brought to p.
        D0_sel = take_plane(D0, sol_black)
        t = alphas[OPP[d]][None] * truncated_kernel(Q[OPP[d]] - D0_sel[None],
                                                    kernel, tol)
        cost = cost + geometry.shift_from_neighbor(t, d, fill=0.0)

    sol_white = jnp.argmin(cost, axis=0).astype(jnp.int32)
    labels = jnp.where(cb == 0, sol_black, sol_white)

    energy = labeling_energy(labels, theta, D0, Q, alphas, kernel, tol)
    return labels, energy


def labeling_energy(labels, theta, D0, Q, alphas, kernel, tol):
    """Exact MRF energy of an integer labeling [H, W] under the solver's data."""
    acc_dtype = jnp.promote_types(theta.dtype, jnp.float32)
    u = take_plane(theta, labels)
    E = jnp.sum(u, dtype=acc_dtype)
    D0_sel = take_plane(D0, labels)
    for d in range(NUM_DIRS):
        sol_n = geometry.shift_from_neighbor(labels, d, fill=0)
        Q_sel = take_plane(Q[d], sol_n)
        c = alphas[d] * truncated_kernel(Q_sel - D0_sel, kernel, tol)
        E = E + jnp.sum(c, dtype=acc_dtype)
    return E


def solve(
    unary: jax.Array,  # [K, H, W]
    positions: jax.Array,  # D0 [K, H, W]: label k's plane at p, eval at p
    nbr_positions: jax.Array,  # Q [4, K, H, W]: label k's plane at neighbor, eval at p
    alphas: jax.Array,  # [4, H, W] directed-edge weights (0 at borders)
    *,
    kernel: int,
    tol,
    maxiter: int = 1000,
    max_relgap: float = 1e-4,
    messages: jax.Array | None = None,  # warm start [4, K, H, W]
    mode: str = "trws",  # "trws" | "bp" (Minimize_BP, minimize.cpp:118-221)
    check_every: int = 1,  # decode + test the stopping rule every N iterations
    message_dtype=None,  # e.g. jnp.bfloat16: narrow message *storage*
    compact: bool = COMPACT_DEFAULT,  # checkerboard H-compaction
) -> TRWSResult:
    """Run checkerboard TRW-S (or plain loopy BP) to the reference's
    stopping rule.

    Equivalent of trws_mex.cpp:27-147 + Minimize_TRW_S (minimize.cpp:31-116);
    mode="bp" reproduces Minimize_BP: gamma = 1, no lower bound (returned
    lower bound stays 0, so the relgap rule degenerates to maxiter —
    matching the reference, which only stops BP on iterations).

    message_dtype narrows only the message *storage* (~4*K*H*W values);
    every phase upcasts to the problem dtype for compute and
    min-normalization, so the lower bound remains a valid dual value of the
    (rounded) reparametrization — bounds and energies drift by the bf16
    rounding of message entries but lb <= E always holds.  Oracle-exact
    parity tests require the default (None = problem dtype).
    """
    if mode not in ("trws", "bp"):
        raise ValueError(f"unknown mode {mode!r}")
    K, H, W = unary.shape
    dtype = unary.dtype
    theta = unary
    D0 = positions
    Q = nbr_positions
    cb = checkerboard(H, W)
    if mode == "bp":
        gamma = jnp.ones((H, W), dtype)  # minimize.cpp:160,188: gamma = 1
    else:
        gamma = node_gamma(H, W, dtype)
    valid = jnp.stack(
        [geometry.valid_mask(H, W, d, dtype=dtype) for d in range(NUM_DIRS)], 0
    )

    m_dtype = jnp.dtype(message_dtype) if message_dtype is not None else dtype
    if messages is None:
        messages = jnp.zeros((NUM_DIRS, K, H, W), m_dtype)
    elif messages.dtype != m_dtype:
        messages = messages.astype(m_dtype)

    accumulate_lb = mode == "trws"

    # Checkerboard H-compaction (ops/checker.py): each phase computes each
    # message variant once on its color's half-grid instead of both variants
    # everywhere + select — ~2x less sweep compute.  Decode/stop checks
    # expand back to the full grid (once per check_every sweeps).
    if compact:
        from stereo_tpu.ops import checker

        ch = lambda a: (checker.compact_h(a, 0), checker.compact_h(a, 1))
        theta2, D02, Q2, alphas2, valid2, gamma2 = map(
            ch, (theta, D0, Q, alphas, valid, gamma))
        pix_full = jnp.ones((H, W), dtype)
        pix2 = (checker.compact_h(pix_full, 0),
                checker.compact_h(pix_full, 1), H)

        def to_compact(M):
            return ch(M)

        def to_full(M2):
            return checker.expand_h(M2[0], M2[1], H)

    def message_passes(M):
        """check_every forward+backward sweeps; LB from the last sweep."""

        def sweep(_, carry):
            M, _ = carry
            if compact:
                M, _, _ = _phase_compact(theta2, M, D02, Q2, alphas2,
                                         valid2, gamma2, pix2, 0, kernel,
                                         tol, accumulate_lb=False)
                M, lb_nodes, lb_msgs = _phase_compact(
                    theta2, M, D02, Q2, alphas2, valid2, gamma2, pix2, 1,
                    kernel, tol, accumulate_lb=accumulate_lb)
                return M, (lb_nodes + lb_msgs).astype(dtype)
            M, _, _ = _phase(theta, M, D0, Q, alphas, valid, gamma, cb, 0,
                             kernel, tol, accumulate_lb=False)
            M, lb_nodes, lb_msgs = _phase(theta, M, D0, Q, alphas, valid,
                                          gamma, cb, 1, kernel, tol,
                                          accumulate_lb=accumulate_lb)
            return M, lb_nodes + lb_msgs
        if check_every == 1:
            return sweep(0, (M, jnp.zeros((), dtype)))
        return jax.lax.fori_loop(0, check_every, sweep,
                                 (M, jnp.zeros((), dtype)))

    def one_iteration(M):
        # forward (black) + backward (white) message sweeps
        # (minimize.cpp:33-95), check_every at a time
        M, lb_sweep = message_passes(M)
        if compact:
            M, Mc = to_full(M), M
        if accumulate_lb:
            # blacks contribute their belief minima to the bound (they have no
            # backward edges; minimize.cpp:69-83 visits them at the end of the
            # descending sweep)
            D_black = _node_beliefs(theta, M)
            lb_black = jnp.sum(
                jnp.where(cb == 0, jnp.min(D_black, axis=0), 0.0),
                dtype=jnp.promote_types(dtype, jnp.float32),
            )
            lb = lb_sweep + lb_black
        else:
            lb = jnp.zeros((), dtype)
        labels, energy = _decode(theta, M, D0, Q, alphas, valid, cb, kernel, tol)
        if compact:
            return Mc, energy, lb, labels
        return M, energy, lb, labels

    def cond(state):
        M, it, energy, lb, labels = state
        relgap = jnp.where(energy != 0, (energy - lb) / energy, 0.0)
        return jnp.logical_and(
            it < maxiter, jnp.logical_or(it == 0, relgap >= max_relgap)
        )

    def body(state):
        M, it, _, _, _ = state
        M, energy, lb, labels = one_iteration(M)
        return (M, it + check_every, energy, lb, labels)

    zero = jnp.zeros((), dtype)
    state0 = (
        to_compact(messages) if compact else messages,
        jnp.zeros((), jnp.int32),
        zero,
        zero,
        jnp.zeros((H, W), jnp.int32),
    )
    M, iters, energy, lb, labels = jax.lax.while_loop(cond, body, state0)
    if compact:
        M = to_full(M)
    return TRWSResult(labels, energy, lb, iters, M.astype(m_dtype))


class TRWSRun:
    """Prepared checkerboard solver: pack the problem once, sweep in jitted
    chunks (the BandedRun pattern applied to the public trws entry point).

    ``solve`` is designed to be *traced inside* a driver's jit; called
    eagerly, its setup glue (masks, gammas, compaction) dispatches op-by-op.
    TRWSRun hoists that into one jitted pack at construction; each ``run(state, sweeps)`` chunk is a single compiled
    program whose message state is donated, so a caller's second solve costs
    sweeps + decode only.

    Usage:
        r = TRWSRun(unary, D0, Q, alphas, kernel=1, tol=2.0)
        state = r.init_state()                     # or init_state(messages)
        state, energy, lb, labels = r.run(state, 100, decode_every=10)
        msgs = r.messages(state)                   # [4, K, H, W]
        e, lb, labels, iters = r.solve()           # the reference stopping
                                                   # rule, chunked driving

    Semantics: ``run`` performs a fixed budget of forward+backward sweeps,
    decoding every ``decode_every`` and keeping the best labeling seen (any
    decode is feasible, so the incumbent is never worse than the last —
    dispmap_super.m:191-197 keeps the last).  The message trajectory is
    iteration-exact with ``solve`` for matching compact settings
    (tests/test_trws_run.py pins messages bitwise).
    """

    def __init__(self, unary, positions, nbr_positions, alphas, *, kernel,
                 tol, mode: str = "trws", compact: bool = COMPACT_DEFAULT,
                 message_dtype=None):
        if mode not in ("trws", "bp"):
            raise ValueError(f"unknown mode {mode!r}")
        K, H, W = unary.shape
        self.K, self.H, self.W = K, H, W
        self.kernel, self.tol, self.mode = kernel, tol, mode
        self.dtype = unary.dtype
        self._m_dtype = (jnp.dtype(message_dtype) if message_dtype is not None
                         else self.dtype)
        self.compact = compact

        import functools

        @functools.partial(jax.jit, static_argnames=("mode", "compact"))
        def pack(theta, D0, Q, alphas, mode, compact):
            cb = checkerboard(H, W)
            if mode == "bp":
                gamma = jnp.ones((H, W), theta.dtype)
            else:
                gamma = node_gamma(H, W, theta.dtype)
            valid = jnp.stack(
                [geometry.valid_mask(H, W, d, dtype=theta.dtype)
                 for d in range(NUM_DIRS)], 0)
            full = (theta, D0, Q, alphas, cb, gamma, valid)
            if not compact:
                return full, None
            from stereo_tpu.ops import checker

            ch = lambda a: (checker.compact_h(a, 0), checker.compact_h(a, 1))
            pix_full = jnp.ones((H, W), theta.dtype)
            comp = (*map(ch, (theta, D0, Q, alphas, valid, gamma)),
                    ch(pix_full))
            return full, comp

        self._full, self._comp = pack(unary, positions, nbr_positions,
                                      alphas, mode, compact)
        self._chunk_cache = {}
        self._init_jit = None
        self._msg_jit = None

    # ------------------------------------------------------------- state
    def init_state(self, messages=None):
        """Message state in storage layout (compact pair or full buffer)."""
        if messages is None:
            messages = jnp.zeros((NUM_DIRS, self.K, self.H, self.W),
                                 self._m_dtype)
        elif messages.dtype != self._m_dtype:
            messages = messages.astype(self._m_dtype)
        if not self.compact:
            return messages
        if self._init_jit is None:
            from stereo_tpu.ops import checker

            self._init_jit = jax.jit(
                lambda M: (checker.compact_h(M, 0), checker.compact_h(M, 1)))
        return self._init_jit(messages)

    def messages(self, state):
        """[4, K, H, W] message buffer from a run state."""
        if not self.compact:
            return state
        if self._msg_jit is None:
            self._msg_jit = jax.jit(self._expand)
        return self._msg_jit(state)

    # -------------------------------------------------------------- runs
    def run(self, state, sweeps: int, decode_every: int | None = None):
        """``sweeps`` forward+backward passes; decode every ``decode_every``
        keeping the best labeling.  -> (state, best_energy, lb, best_labels).
        State is donated: pass the returned state to the next chunk."""
        if decode_every is None or decode_every >= sweeps:
            decode_every = sweeps
        sweeps = (sweeps // decode_every) * decode_every
        key = (sweeps, decode_every)
        fn = self._chunk_cache.get(key)
        if fn is None:
            n_seg = sweeps // decode_every
            kernel, tol, mode, compact = (self.kernel, self.tol, self.mode,
                                          self.compact)
            accumulate_lb = mode == "trws"
            dtype = self.dtype
            acc_t = jnp.promote_types(dtype, jnp.float32)

            def chunk(full, comp, M):
                theta, D0, Q, alphas, cb, gamma, valid = full
                if compact:
                    (theta2, D02, Q2, alphas2, valid2, gamma2,
                     pix2c) = comp
                    pix2 = (pix2c[0], pix2c[1], self.H)

                def sweep(_, carry):
                    M, _ = carry
                    if compact:
                        M, _, _ = _phase_compact(
                            theta2, M, D02, Q2, alphas2, valid2, gamma2,
                            pix2, 0, kernel, tol, accumulate_lb=False)
                        M, lb_nodes, lb_msgs = _phase_compact(
                            theta2, M, D02, Q2, alphas2, valid2, gamma2,
                            pix2, 1, kernel, tol,
                            accumulate_lb=accumulate_lb)
                    else:
                        M, _, _ = _phase(theta, M, D0, Q, alphas, valid,
                                         gamma, cb, 0, kernel, tol,
                                         accumulate_lb=False)
                        M, lb_nodes, lb_msgs = _phase(
                            theta, M, D0, Q, alphas, valid, gamma, cb, 1,
                            kernel, tol, accumulate_lb=accumulate_lb)
                    return M, (lb_nodes + lb_msgs).astype(acc_t)

                def segment(carry, _):
                    M, bestE, bestL = carry
                    M, lb_sweep = jax.lax.fori_loop(
                        0, decode_every, sweep,
                        (M, jnp.zeros((), acc_t)))
                    Mf = self._expand(M) if compact else M
                    if accumulate_lb:
                        D_black = _node_beliefs(theta, Mf)
                        lb_black = jnp.sum(
                            jnp.where(cb == 0, jnp.min(D_black, axis=0),
                                      0.0), dtype=acc_t)
                        lb = lb_sweep + lb_black
                    else:
                        lb = jnp.zeros((), acc_t)
                    labels, energy = _decode(theta, Mf, D0, Q, alphas,
                                             valid, cb, kernel, tol)
                    energy = energy.astype(acc_t)
                    better = energy < bestE
                    bestE = jnp.where(better, energy, bestE)
                    bestL = jnp.where(better, labels, bestL)
                    return (M, bestE, bestL), lb

                big = jnp.asarray(jnp.inf, acc_t)
                lab0 = jnp.zeros((self.H, self.W), jnp.int32)
                (M, bestE, bestL), lbs = jax.lax.scan(
                    segment, (M, big, lab0), jnp.arange(n_seg))
                return M, bestE, lbs[-1], bestL

            fn = jax.jit(chunk, donate_argnums=(2,))
            self._chunk_cache[key] = fn
        state, e, lb, labels = fn(self._full, self._comp, state)
        return state, e, lb, labels

    def _expand(self, M2):
        from stereo_tpu.ops import checker

        return checker.expand_h(M2[0], M2[1], self.H)

    def solve(self, maxiter: int = 1000, max_relgap: float = 1e-4,
              check_every: int = 8, chunk: int = 300, messages=None):
        """Chunked driving to the reference stopping rule
        (minimize.cpp:100-112): decode/test every ``check_every`` sweeps,
        stop on relgap < max_relgap or maxiter.  Returns a TRWSResult whose
        labels/energy are the best decode seen (incumbent semantics)."""
        state = self.init_state(messages)
        best_e = float("inf")
        best_labels = None
        lb = 0.0
        total = 0
        while total < maxiter:
            n = min(chunk, maxiter - total)
            n = max(check_every, (n // check_every) * check_every)
            state, e, lb, labels = self.run(state, n, check_every)
            total += n
            ef = float(e)
            if ef < best_e:
                best_e, best_labels = ef, labels
            if ef != 0 and (ef - float(lb)) / ef < max_relgap:
                break
        return TRWSResult(best_labels, jnp.asarray(best_e),
                          jnp.asarray(lb), jnp.asarray(total, jnp.int32),
                          self.messages(state))
