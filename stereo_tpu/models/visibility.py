"""Geometric visibility/occlusion terms for scalar-disparity fusion.

The signature piece of the bundled CVPR'08 pipeline
(imrender/ojw/ibr_fuse_depths.m:57-139): when fusing two candidate disparity
maps D1/D2, every (pixel, candidate-surface) sample is projected into every
input view; a binary *sample node* per (pixel, surface, view) decides whether
that sample claims photoconsistency there ("visible", paying its photo cost)
or is occluded (paying ``occl_cost``).  Geometry couples the nodes: if a
nearer projected point lands within 0.5 px of a sample in some view and the
nearer point's pixel *selects* that occluding surface, the sample may not
claim visibility — encoded as a pairwise term of weight Kinf = occl_cost + 1
between the occluder's pixel node and the occluded sample node
(ibr_fuse_depths.m:104-127).

Device/host split: projection, photoconsistency and interaction detection are
dense device programs (ops/photo, ops/interp, ops/interactions); the graph is
assembled on the host and solved by the native QPBO (solvers/qpbo_host), the
same device/host boundary as the reference's MATLAB/mex split.

Compression: samples with no incident occlusion edge have independent optimal
labels, so their cost folds into the pixel unary as min(photo, occl) — the
main effect of the reference's compress_graph (ibr_fuse_depths.m:394-424);
only interacting samples become auxiliary QPBO nodes.  (With the reference's
occl_val = occl_const + log 2 > max ephoto, the fold is just the photo cost.)
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from stereo_tpu.ops import photo
from stereo_tpu.ops.interactions import find_interactions, interactions_to_pairs
from stereo_tpu.ops.interp import interp2


def project_candidates(D1, D2, P_view, images_view, R, col_thresh,
                       oobv=-1000.0):
    """Project both candidate surfaces into one input view.

    D1/D2: [H, W] raw disparities; P_view: [3, 4]; R: [H, W, C] reference
    colors.  Returns (u, v, z, photo_cost), each [2, H, W] (surface axis
    first; z = T3 / d, the reference's depth proxy, ibr_fuse_depths.m:106).
    """
    H, W = D1.shape
    from stereo_tpu import geometry

    xs, ys = geometry.grid_points(H, W, dtype=D1.dtype)
    C = images_view.shape[-1]
    disp = jnp.stack([D1, D2], axis=0)  # [2, H, W]
    T1 = P_view[0, 0] * xs + P_view[0, 1] * ys + P_view[0, 2] + P_view[0, 3] * disp
    T2 = P_view[1, 0] * xs + P_view[1, 1] * ys + P_view[1, 2] + P_view[1, 3] * disp
    T3 = P_view[2, 0] * xs + P_view[2, 1] * ys + P_view[2, 2] + P_view[2, 3] * disp
    n = 1.0 / T3
    u = T1 * n
    v = T2 * n
    z = T3 / disp
    M = interp2(images_view, u, v, oobv=oobv)  # [2, H, W, C]
    pc = photo.ephoto(M - R[None], col_thresh, C)
    return u, v, z, pc


def view_interactions(u, v, z, dist=0.5, max_offsets=48):
    """Occluding (occluder_point, occluded_point) pairs among the 2*tp
    projected candidate points of one view.

    Points are flat indices into [2, H, W] (surface-major: i // tp is the
    surface, i % tp the pixel).  Pairs between the two surfaces of the same
    pixel are dropped (ibr_fuse_depths.m:110).
    """
    tp = u.shape[-2] * u.shape[-1]
    uf = u.reshape(-1)
    vf = v.reshape(-1)
    zf = z.reshape(-1)
    order = jnp.argsort(uf)
    partner, first, valid = find_interactions(
        uf[order], vf[order], zf[order], dist=dist, max_offsets=max_offsets)
    pairs = interactions_to_pairs(partner, first, valid)  # sorted-space
    o = np.asarray(order)
    pairs = o[pairs]  # unsort to original point ids
    same_pixel = (np.abs(pairs[:, 0].astype(np.int64)
                         - pairs[:, 1].astype(np.int64)) == tp)
    return pairs[~same_pixel]


def build_visibility_terms(D1, D2, images, Ps, R, col_thresh, occl_cost,
                           dist=0.5, max_offsets=48):
    """Assemble the visibility QPBO terms for one fusion move.

    images: list of input-view arrays [H', W', C]; Ps: [num_in, 3, 4]; R:
    [H, W, C] reference colors.  Pixel node convention: label 0 keeps D1,
    label 1 takes D2.

    Returns a dict with:
      unary0/unary1 [tp]: folded per-pixel visibility unaries,
      aux0/aux1 [A]: auxiliary sample-node unaries (zeros; kept for shape),
      edges: (tails, heads, E00, E01, E10, E11) with sample nodes indexed
             tp..tp+A-1 (data edges pixel<->own sample + Kinf occlusion
             edges occluder-pixel<->occluded sample),
      samples: (pixel, surface, view) per aux node — for visibility maps,
      photo/occl arrays for calc_vis_energy.
    """
    tp = D1.shape[-2] * D1.shape[-1]
    Kinf = float(occl_cost) + 1.0

    photo_cost = []  # [num_in][2, tp]
    inter = []  # per view pairs [M, 2]
    for a, (im, P) in enumerate(zip(images, Ps)):
        u, v, z, pc = project_candidates(D1, D2, jnp.asarray(P, D1.dtype),
                                         jnp.asarray(im, D1.dtype), R,
                                         col_thresh)
        photo_cost.append(np.asarray(pc, np.float64).reshape(2, tp))
        inter.append(view_interactions(u, v, z, dist=dist,
                                       max_offsets=max_offsets))

    # which (view, surface, pixel) samples are ever occluded -> aux nodes
    occluded_sets = []
    for a, pairs in enumerate(inter):
        occ = np.zeros(2 * tp, bool)
        if len(pairs):
            occ[pairs[:, 1]] = True
        occluded_sets.append(occ)

    U0 = np.zeros(tp)
    U1 = np.zeros(tp)
    sample_pix, sample_surf, sample_view, photo_aux = [], [], [], []
    aux_of = []  # per view: point id -> aux node id (or -1)
    n_aux = 0
    for a in range(len(images)):
        pc = photo_cost[a]
        occ = occluded_sets[a]
        # fold non-interacting samples: optimal independent label
        U0 += np.where(~occ[:tp], np.minimum(pc[0], occl_cost), 0.0)
        U1 += np.where(~occ[tp:], np.minimum(pc[1], occl_cost), 0.0)
        points = np.nonzero(occ)[0]
        lookup = np.full(2 * tp, -1, np.int64)
        lookup[points] = tp + n_aux + np.arange(len(points))
        aux_of.append(lookup)
        n_aux += len(points)
        sample_pix.append(points % tp)
        sample_surf.append(points // tp)
        sample_view.append(np.full(len(points), a))
        photo_aux.append(pc[points // tp, points % tp])

    sample_pix = np.concatenate(sample_pix).astype(np.int64)
    sample_surf = np.concatenate(sample_surf).astype(np.int64)
    sample_view = np.concatenate(sample_view).astype(np.int64)
    photo_aux = np.concatenate(photo_aux)
    A = n_aux

    # data edges: pixel p <-> its own occludable sample s (sample label 1 =
    # visible).  Surface-1 sample matters when the pixel keeps D1 (label 0):
    # (0, invisible) -> occl, (0, visible) -> photo; free otherwise.
    c0 = sample_surf == 0
    d_tails = sample_pix
    d_heads = tp + np.arange(A)
    dE00 = np.where(c0, occl_cost, 0.0)
    dE01 = np.where(c0, photo_aux, 0.0)
    dE10 = np.where(c0, 0.0, occl_cost)
    dE11 = np.where(c0, 0.0, photo_aux)

    # occlusion edges: occluder point i = (pixel pi, surface ci); if pi
    # selects surface ci, the occluded sample may not claim visibility
    o_tails, o_heads, oE01, oE11 = [], [], [], []
    for a, pairs in enumerate(inter):
        if not len(pairs):
            continue
        pi = pairs[:, 0] % tp
        ci = pairs[:, 0] // tp
        s = aux_of[a][pairs[:, 1]]
        o_tails.append(pi.astype(np.int64))
        o_heads.append(s)
        oE01.append(np.where(ci == 0, Kinf, 0.0))
        oE11.append(np.where(ci == 0, 0.0, Kinf))
    zeros0 = np.zeros(0)
    o_tails = np.concatenate(o_tails) if o_tails else zeros0.astype(np.int64)
    o_heads = np.concatenate(o_heads) if o_heads else zeros0.astype(np.int64)
    oE01 = np.concatenate(oE01) if oE01 else zeros0
    oE11 = np.concatenate(oE11) if oE11 else zeros0

    return {
        "unary0": U0,
        "unary1": U1,
        "aux0": np.zeros(A),
        "aux1": np.zeros(A),
        "edges": (
            np.concatenate([d_tails, o_tails]),
            np.concatenate([d_heads, o_heads]),
            np.concatenate([dE00, np.zeros_like(oE01)]),
            np.concatenate([dE01, oE01]),
            np.concatenate([dE10, np.zeros_like(oE01)]),
            np.concatenate([dE11, oE11]),
        ),
        "samples": (sample_pix, sample_surf, sample_view),
        "photo_aux": photo_aux,
        "photo_cost": photo_cost,
        "occluded": occluded_sets,
        "interactions": inter,
        "occl_cost": float(occl_cost),
        "tp": tp,
    }


def calc_vis_energy(terms, labels):
    """Visibility-term energy of a pixel labeling (0 = D1, 1 = D2), with the
    sample nodes minimized out exactly (they couple only to pixels).

    The calc_vis_energy equivalent (ibr_fuse_depths.m:377-392), except
    samples not forced occluded take min(photo, occl) instead of an
    arbitrary QPBO assignment.  Returns (energy, vis) where vis[a] is the
    [2*tp] visibility mask of view a under that minimization.
    """
    tp = terms["tp"]
    occl = terms["occl_cost"]
    labels = np.asarray(labels).reshape(-1)[:tp]
    e = 0.0
    vis_maps = []
    for a, pc in enumerate(terms["photo_cost"]):
        # forced occlusions: occluder pixel selects the occluding surface
        forced = np.zeros(2 * tp, bool)
        pairs = terms["interactions"][a]
        if len(pairs):
            ci = pairs[:, 0] // tp
            pi = pairs[:, 0] % tp
            active = labels[pi] == ci
            forced[pairs[active, 1]] = True
        # a sample only matters when its pixel selects its surface
        sel0 = labels == 0
        sel1 = labels == 1
        cost0 = np.where(forced[:tp], occl, np.minimum(pc[0], occl))
        cost1 = np.where(forced[tp:], occl, np.minimum(pc[1], occl))
        e += float(cost0[sel0].sum() + cost1[sel1].sum())
        vis = np.concatenate([
            ~forced[:tp] & (pc[0] <= occl),
            ~forced[tp:] & (pc[1] <= occl),
        ])
        vis_maps.append(vis)
    return e, vis_maps
