"""Min-plus message update, the hot operation of TRW-S (plain XLA reference).

For every pixel and an edge family with source positions P[K], dest positions
R[K], weight alpha and truncation tol:

    msgA[j] = min_i ( H_A[i] + alpha * TR(|P[i] - R[j]|) )   (source = tail)
    msgB[i] = min_j ( H_B[j] + alpha * TR(|P[i] - R[j]|) )   (source = head)

The reference computes the same update in O(K) per edge with a lower-envelope
scan over sorted positions (typeStereoLinear.h:329-487,
typeStereoQuadratic.h).  At this problem family's label counts (K <= ~100)
the update here is the dense K^2 min-plus, exact for both kernels; the O(K)
envelope is kept in the host oracle (native/trws.cpp:37-164).  Whether the
envelope wins at K=79 on a GPU, where per-pixel gathers are native, is
unmeasured.
"""

from __future__ import annotations

import jax.numpy as jnp

from stereo_tpu.energy import truncated_kernel


def minplus_pair_xla(H_A, H_B, P, R, alpha, kernel: int, tol):
    """Reference XLA implementation. H_A/H_B/P/R: [K, H, W]; alpha: [H, W].

    Returns (msgA, msgB), each [K, H, W].
    """
    K = P.shape[0]
    msgA = []
    accB = jnp.full_like(H_B, jnp.inf)
    for j in range(K):
        term = alpha[None] * truncated_kernel(P - R[j][None], kernel, tol)
        msgA.append(jnp.min(H_A + term, axis=0))
        accB = jnp.minimum(accB, H_B[j][None] + term)
    return jnp.stack(msgA, axis=0), accB
