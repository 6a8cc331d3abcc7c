"""Occlusion interaction detection — the find_interactions equivalent.

The reference's mex (imrender/ojw/find_interactions.cxx:48-72) scans points
sorted by projected x; every pair within ``dist`` in both x and y interacts,
ordered (occluder, occluded) by depth z.  It emits a variable-length pair
list into a bounded buffer (MAX_MEAN_INTERACTIONS per point).

Array-program form: static shapes — for each point a and each forward offset
o in 1..max_offsets, report whether (a, a+o) interact and which of the two
occludes, as dense [N, O] masks.  Because x is sorted, all interactions of a
lie within a bounded forward window (the same assumption as the mex's
buffer bound).  Downstream consumers (visibility edges for the fusion graph,
ibr_fuse_depths.m:104-127) read the masks directly or compact them on host.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def find_interactions(
    x: jax.Array,  # [N] projected x, sorted ascending
    y: jax.Array,  # [N]
    z: jax.Array,  # [N] depth (smaller = nearer = occluder)
    dist: float = 0.5,
    max_offsets: int = 32,
):
    """Returns (partner [N, O] int32, occluder_first [N, O] bool,
    valid [N, O] bool): for valid (a, o), the pair is (a, partner[a, o]) and
    occluder_first says whether a (not the partner) is the occluder."""
    N = x.shape[0]
    O = max_offsets
    idx = jnp.arange(N)

    partners = []
    valids = []
    firsts = []
    for o in range(1, O + 1):
        b = jnp.clip(idx + o, 0, N - 1)
        in_range = idx + o <= N - 1
        xb = x[b]
        yb = y[b]
        zb = z[b]
        ok = in_range & (xb <= x + dist) & (jnp.abs(yb - y) <= dist)
        partners.append(b.astype(jnp.int32))
        valids.append(ok)
        firsts.append(z < zb)  # a occludes b iff a is nearer
    return (
        jnp.stack(partners, axis=1),
        jnp.stack(firsts, axis=1),
        jnp.stack(valids, axis=1),
    )


def interactions_to_pairs(partner, occluder_first, valid):
    """Host-side compaction to an (occluder, occluded) index list [M, 2]."""
    import numpy as np

    partner = np.asarray(partner)
    first = np.asarray(occluder_first)
    valid = np.asarray(valid)
    a_idx = np.broadcast_to(
        np.arange(partner.shape[0])[:, None], partner.shape
    )
    a = a_idx[valid]
    b = partner[valid]
    f = first[valid]
    occluder = np.where(f, a, b)
    occluded = np.where(f, b, a)
    return np.stack([occluder, occluded], axis=1)
