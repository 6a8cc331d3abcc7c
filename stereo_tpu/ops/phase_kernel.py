"""Checkerboard-phase message update as a Pallas kernel through Triton.

One compacted half-iteration (solvers/trws._phase_compact over the
ops/checker.py layout) updates, for each direction d, two message families:

  variant B at the phase color's heads:  msg[i] = min_j HB[j] + a TR(Q_i - D0_j)
  variant A at the other color's heads:  msg[j] = min_i HA[i] + a TR(Q_i - D0_j)

Both are one *send*: targets t with positions P_t, sources s with heights
h_s = g_s - M_s and positions R_s,

    msg[t] = min_s h_s + a * TR(P_t - R_s),   then msg -= min_t msg, * valid

(TR is even, so operand order is immaterial).  The plain XLA version of
variant A is K separate reductions, each re-reading the [K, Hc, W] source
stack; this kernel loads every source row once per pixel block and keeps all
K targets of the block in registers.

Grid: (direction, pixel block).  The pixel axis is the flattened compact
half-grid (Hc * W), cut into power-of-two blocks with a masked ragged tail;
targets are held in KT-row tiles (KT a power of two, rows >= K masked); the
walk over sources is a ``fori_loop``, so the program does not grow with K^2.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from stereo_tpu.energy import truncated_kernel


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def tile_sizes(K: int) -> tuple[int, int]:
    """(KT, BP): target-tile rows and pixels per program.

    The block holds ceil(K/KT)*KT targets x BP pixels twice (accumulators and
    target positions); BP shrinks with K to keep that near 8K floats, i.e.
    about 64 registers a thread at 4 warps."""
    KT = min(16, _next_pow2(K))
    rows = -(-K // KT) * KT
    BP = max(32, min(256, _next_pow2(4096 // rows + 1) // 2))
    return KT, BP


def _send_kernel(tol_ref, g_ref, m_ref, tpos_ref, spos_ref, a_ref, v_ref,
                 out_ref, vmin_ref, *, kernel: int, K: int, N: int, KT: int,
                 BP: int, g_dir: bool, t_dir: bool, s_dir: bool):
    d = pl.program_id(0)
    p0 = pl.program_id(1) * BP
    pm = p0 + jnp.arange(BP) < N
    cdt = g_ref.dtype
    inf = jnp.asarray(jnp.inf, cdt)
    tol = plgpu.load(tol_ref.at[0])

    def lead(per_dir):
        return (d,) if per_dir else ()

    alpha = plgpu.load(a_ref.at[d, pl.ds(p0, BP)], mask=pm, other=0.0)
    # target tiles start at traced offsets: static slice starts are
    # bounds-checked, and the last tile runs past K (masked rows)
    blocks = []
    for t0 in range(0, K, KT):
        rm = t0 + jnp.arange(KT) < K
        tp = plgpu.load(
            tpos_ref.at[(*lead(t_dir), pl.ds(jnp.int32(t0), KT),
                         pl.ds(p0, BP))],
            mask=rm[:, None] & pm[None, :], other=0.0)
        blocks.append((rm, tp))

    def body(s, accs):
        g = plgpu.load(g_ref.at[(*lead(g_dir), s, pl.ds(p0, BP))],
                       mask=pm, other=0.0)
        m = plgpu.load(m_ref.at[d, s, pl.ds(p0, BP)], mask=pm, other=0.0)
        r = plgpu.load(spos_ref.at[(*lead(s_dir), s,
                                    pl.ds(p0, BP))], mask=pm, other=0.0)
        h = g - m.astype(cdt)
        return tuple(
            jnp.minimum(acc, h[None, :] + alpha[None, :]
                        * truncated_kernel(tp - r[None, :], kernel, tol))
            for acc, (_, tp) in zip(accs, blocks))

    accs = lax.fori_loop(
        0, K, body, tuple(jnp.full((KT, BP), inf, cdt) for _ in blocks))
    vmin = None
    for acc, (rm, _) in zip(accs, blocks):
        bm = jnp.min(jnp.where(rm[:, None], acc, inf), axis=0)
        vmin = bm if vmin is None else jnp.minimum(vmin, bm)
    valid = plgpu.load(v_ref.at[d, pl.ds(p0, BP)], mask=pm, other=0.0)
    for t0, (acc, (rm, _)) in zip(range(0, K, KT), zip(accs, blocks)):
        msg = (acc - vmin[None, :]) * valid[None, :]
        plgpu.store(out_ref.at[d, pl.ds(jnp.int32(t0), KT), pl.ds(p0, BP)],
                    msg.astype(out_ref.dtype),
                    mask=rm[:, None] & pm[None, :])
    plgpu.store(vmin_ref.at[d, pl.ds(p0, BP)], vmin, mask=pm)


@functools.partial(jax.jit, static_argnames=("kernel", "interpret"))
def send4(g, M, tpos, spos, alpha, valid, tol, kernel: int,
          interpret: bool = False):
    """Four directions' sends in one Pallas call.

    M: [4, K, Hc, W] (storage dtype); g, tpos, spos: [4, K, Hc, W] or a
    direction-shared [K, Hc, W]; alpha, valid: [4, Hc, W].  Returns
    (msg [4, K, Hc, W] in M's dtype, min-normalized and masked by valid,
    vmin [4, Hc, W] in g's dtype)."""
    _, K, Hc, W = M.shape
    N = Hc * W
    KT, BP = tile_sizes(K)
    flat = lambda a: a.reshape(a.shape[:-2] + (N,))  # noqa: E731
    args = (jnp.asarray(tol, g.dtype).reshape(1),) + tuple(
        map(flat, (g, M, tpos, spos, alpha, valid)))
    body = functools.partial(
        _send_kernel, kernel=kernel, K=K, N=N, KT=KT, BP=BP,
        g_dir=g.ndim == 4, t_dir=tpos.ndim == 4, s_dir=spos.ndim == 4)
    msg, vmin = pl.pallas_call(
        body,
        grid=(4, pl.cdiv(N, BP)),
        out_shape=[jax.ShapeDtypeStruct((4, K, N), M.dtype),
                   jax.ShapeDtypeStruct((4, N), g.dtype)],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="trws_phase_send",
    )(*args)
    return msg.reshape(4, K, Hc, W), vmin.reshape(4, Hc, W)


def phase_messages_compact(gD_s, gDn, M_s, M_o, Q_s, Q_o, D0_s, D0_o, a_s,
                           a_o, valid_s, valid_o, tol, kernel: int,
                           interpret: bool = False):
    """Compacted phase (ops/checker.py layout): variant B on the source
    color's half-grid, variant A on the other's.

    gD_s, D0_*: [K, Hc, W]; gDn (tail beliefs at o-heads), M_*, Q_*:
    [4, K, Hc, W]; a_*, valid_*: [4, Hc, W].  Returns
    (newM_s, newM_o, vmin_s, vmin_o)."""
    newMs, vmins = send4(gD_s, M_s, Q_s, D0_s, a_s, valid_s, tol, kernel,
                         interpret=interpret)
    newMo, vmino = send4(gDn, M_o, D0_o, Q_o, a_o, valid_o, tol, kernel,
                         interpret=interpret)
    return newMs, newMo, vmins, vmino
