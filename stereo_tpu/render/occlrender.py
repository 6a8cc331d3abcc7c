"""Occlusion-aware new-view renderer (ibr_occlrender.m — Woodford et al.
BMVC'07, "On New View Synthesis Using Multiview Stereo").

The reference (imrender/ojw/ibr_occlrender.m) reconstructs an explicit depth
map for the *output* view by sweeping fronto-parallel disparity planes and
QPBO-fusing each against the current map, with geometric occlusion
modelling: every (pixel, label, view) photoconsistency sample owns a binary
*visibility node*; data cliques couple a pixel to its occludable samples'
nodes (ibr_gen_cliques.cxx:232-441), and Kinf edges forbid "visible" when a
nearer projected point selects the occluding surface (ibr_occlrender.m:
174-185).  Optional texture regularization multiplies the smoothness terms
by truncated-quadratic dictionary costs (truncquad_edges).

Device/host split: projection, colour sampling, occlusion detection, means
and SSD costs are dense device programs over the [2, H, W] candidate-surface
stack (ops/interp, ops/interactions); clique assembly is vectorized
host-side classification by occluder count (the gen_cliques switch);
fusion is the native QPBO with Freedman-Drineas triple reduction
(solvers/qpbo_host.solve_with_triples).  Deviations from the mex, recorded
here: energies stay float64 (the reference saturate-casts to int32 —
no integer scaling is needed without integer maxflow), and only samples
that are ever occluded materialize visibility nodes (the others'
contributions are unconditional unaries, same fold as ibr_fuse_depths'
compress_graph).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from stereo_tpu.ops.interactions import find_interactions, interactions_to_pairs
from stereo_tpu.ops.interp import interp2
from stereo_tpu.render import edges as edges_mod
from stereo_tpu.render.edgemodes import sample_depth_colors
from stereo_tpu.solvers import qpbo_host

OOBV = -1000.0
KINF = float(2 ** 28)  # ibr_occlrender.m:102


@dataclasses.dataclass(frozen=True)
class OcclRenderOptions:
    """The option fields ibr_occlrender consumes, reference defaults
    (ojw_default_options.m 'bmvc07' branch)."""

    col_thresh: float = 30.0
    lambda_: float = 0.02
    disp_thresh: float = 2.0
    smoothness_kernel: int = 1
    tex_weight: float = 0.0
    tex_thresh: float | None = None
    visibility: bool = True
    connect: int = 4
    num_loops: int = 2
    improve: bool = False


@dataclasses.dataclass
class OcclRenderResult:
    image: np.ndarray        # [H, W, C]
    depth: np.ndarray        # [H, W] selected disparities
    visibility: np.ndarray   # [H, W, N] bool
    energies: list           # per-fusion energy trace
    unlabelled: list         # per-fusion unlabelled counts


def _project(images, P, D_pair, sz):
    """Project the [2, H, W] candidate-surface stack into every view.

    Returns per view (colors [2, H, W, C], u, v, zrel) where zrel = T3/d —
    the reference's relative-depth proxy (ibr_occlrender.m:166)."""
    H, W = sz
    dtype = D_pair.dtype
    xs, ys = jnp.meshgrid(jnp.arange(1, W + 1, dtype=dtype),
                          jnp.arange(1, H + 1, dtype=dtype))
    out = []
    for a in range(len(images)):
        Pa = jnp.asarray(P[a], dtype)
        T1 = Pa[0, 0] * xs + Pa[0, 1] * ys + Pa[0, 2] + Pa[0, 3] * D_pair
        T2 = Pa[1, 0] * xs + Pa[1, 1] * ys + Pa[1, 2] + Pa[1, 3] * D_pair
        T3 = Pa[2, 0] * xs + Pa[2, 1] * ys + Pa[2, 2] + Pa[2, 3] * D_pair
        n = 1.0 / T3
        u = T1 * n
        v = T2 * n
        z = T3 / D_pair
        cols = interp2(jnp.asarray(images[a], dtype), u, v, oobv=OOBV)
        out.append((cols, u, v, z))
    return out


def _occluding_pairs(u, v, z, tp, dist=0.5, max_offsets=48):
    """(occluder, occluded) point pairs in the joint [2, H, W] point set of
    one view, same-pixel pairs removed (ibr_occlrender.m:167-170)."""
    uf = u.reshape(-1)
    order = jnp.argsort(uf)
    partner, first, valid = find_interactions(
        uf[order], v.reshape(-1)[order], z.reshape(-1)[order],
        dist=dist, max_offsets=max_offsets)
    pairs = interactions_to_pairs(partner, first, valid)
    pairs = np.asarray(order)[pairs]
    keep = (np.abs(pairs[:, 0].astype(np.int64)
                   - pairs[:, 1].astype(np.int64)) != tp)
    return pairs[keep]


def _ssd_trunc(samples, mean, Kocc):
    """sum_c (mean_c - sample_c)^2 truncated at Kocc
    (ibr_gen_cliques.cxx:168-177, ssd method)."""
    d = mean - samples
    return np.minimum(np.einsum("...c,...c->...", d, d), Kocc)


def gen_cliques(IA, VA, V, Kocc):
    """Vectorized ibr_gen_cliques (method=ssd).

    IA: [2*tp, C, N] samples (point-major: point = label*tp + pixel);
    VA: [2*tp, N] exact visibility (False = occluded by someone);
    V:  [2*tp, N] approximate visibility (False = occluded by an old-surface
    point) — used for the mean when a point has >2 occluders.

    Returns (U [tp, 2], pairs, triples) where pairs is a dict of equal-length
    arrays {pixel, view, label, e_occl, e_vis} — the clique against visnode
    (pixel, label, view): pixel==label & visnode==0 -> e_occl,
    visnode==1 -> e_vis — and triples is a list of
    (pixel, label, v1, v2, table4) with table4 = costs at
    (vn1, vn2) in [(0,0), (0,1), (1,0), (1,1)].
    """
    P2, C, N = IA.shape
    tp = P2 // 2
    VA = np.asarray(VA, bool)
    V = np.asarray(V, bool)
    n_occ = N - VA.sum(axis=1)  # occluder count per point

    U = np.zeros((tp, 2))
    pix = np.arange(P2) % tp
    lab = np.arange(P2) // tp

    def masked_mean(mask):
        # mean over mask-selected views; all-occluded -> OOBV fill
        num = mask.sum(axis=1)
        s = np.einsum("pcn,pn->pc", IA, mask.astype(IA.dtype))
        m = s / np.maximum(num, 1)[:, None]
        return np.where(num[:, None] > 0, m, OOBV)

    mean_all = IA.mean(axis=2)  # [2tp, C]

    def total_cost(mean, vis=None):
        # sum over views of truncated ssd against `mean`; views flagged
        # occluded by `vis` pay Kocc + 1 instead (gen_cliques.cxx:305-317)
        costs = _ssd_trunc(np.moveaxis(IA, 2, 1), mean[:, None, :], Kocc)
        if vis is None:
            return costs.sum(axis=1)
        return np.where(vis, costs, Kocc + 1.0).sum(axis=1)

    # --- 0 occluders: plain unary -------------------------------------
    m0 = n_occ == 0
    if m0.any():
        u_all = total_cost(mean_all)
        np.add.at(U, (pix[m0], lab[m0]), u_all[m0])

    # --- 1 occluder: pairwise with that view's visnode ----------------
    pr_pix, pr_view, pr_lab, pr_occl, pr_vis = [], [], [], [], []
    m1 = n_occ == 1
    if m1.any():
        views = np.argmin(VA, axis=1)  # the single occluded view
        mean_vis = masked_mean(VA)
        e_occl = total_cost(mean_vis, VA)
        e_vis = total_cost(mean_all)
        p1 = np.nonzero(m1)[0]
        pr_pix.append(pix[p1])
        pr_view.append(views[p1])
        pr_lab.append(lab[p1])
        pr_occl.append(e_occl[p1])
        pr_vis.append(e_vis[p1])

    # --- 2 occluders: triple with both views' visnodes -----------------
    triples = []
    m2 = n_occ == 2
    if m2.any():
        occ_idx = np.argsort(VA, axis=1, kind="stable")  # occluded first
        v1 = occ_idx[:, 0]
        v2 = occ_idx[:, 1]
        t00 = total_cost(masked_mean(VA), VA)
        va_v2 = VA.copy()
        va_v2[np.arange(P2), v2] = True
        t01 = total_cost(masked_mean(va_v2), va_v2)
        va_v1 = VA.copy()
        va_v1[np.arange(P2), v1] = True
        t10 = total_cost(masked_mean(va_v1), va_v1)
        t11 = total_cost(mean_all)
        for p in np.nonzero(m2)[0]:
            triples.append((int(pix[p]), int(lab[p]), int(v1[p]),
                            int(v2[p]),
                            (float(t00[p]), float(t01[p]),
                             float(t10[p]), float(t11[p]))))

    # --- >2 occluders: per-view approximate edges ----------------------
    mm = n_occ > 2
    if mm.any():
        mean_apx = masked_mean(V)
        costs = _ssd_trunc(np.moveaxis(IA, 2, 1), mean_apx[:, None, :], Kocc)
        pu, bu = np.nonzero(mm[:, None] & VA)  # visible views -> unary
        np.add.at(U, (pix[pu], lab[pu]), costs[pu, bu])
        pe, be = np.nonzero(mm[:, None] & ~VA)  # occluded views -> edges
        pr_pix.append(pix[pe])
        pr_view.append(be)
        pr_lab.append(lab[pe])
        pr_occl.append(np.full(len(pe), Kocc + 1.0))
        pr_vis.append(costs[pe, be])

    cat = lambda xs, dt: (np.concatenate(xs).astype(dt) if xs
                          else np.zeros(0, dt))
    pairs = {
        "pixel": cat(pr_pix, np.int64),
        "view": cat(pr_view, np.int64),
        "label": cat(pr_lab, np.int64),
        "e_occl": cat(pr_occl, np.float64),
        "e_vis": cat(pr_vis, np.float64),
    }
    return U, pairs, triples


def _smoothness_edges(sz, connect):
    """4/8-connect (tail, head) pixel-index pairs (ibr_occlrender.m:106-115).
    Returns (tails, heads) flat row-major indices."""
    H, W = sz
    nid = np.arange(H * W).reshape(H, W)
    t = [nid[:-1, :].ravel(), nid[:, :-1].ravel()]
    h = [nid[1:, :].ravel(), nid[:, 1:].ravel()]
    if connect == 8:
        t += [nid[:-1, :-1].ravel(), nid[1:, :-1].ravel()]
        h += [nid[1:, 1:].ravel(), nid[:-1, 1:].ravel()]
    return np.concatenate(t), np.concatenate(h)


def render_occl(images, P, disps, sz, options: OcclRenderOptions | None = None,
                *, max_offsets: int = 48) -> OcclRenderResult:
    """Render the output view by occlusion-aware depth sweeping.

    images: list of input views [Hin, Win, C]; P: [N, 3, 4] projections
    relative to the output view (acting on [x, y, 1, d]); disps: descending
    disparity ladder; sz: (H, W) output size."""
    opt = options or OcclRenderOptions()
    H, W = sz
    tp = H * W
    images = [np.asarray(im, np.float32) for im in images]
    C = images[0].shape[-1]
    N = len(images)
    disps = np.asarray(disps, np.float64)

    # constants (ibr_occlrender.m:40-58)
    col_thresh = opt.col_thresh * N / max(N - 1, 1)
    Kocc = float(col_thresh) ** 2 * C
    dstep = float(np.mean(np.abs(np.diff(disps)))) if len(disps) > 1 else 1.0
    disp_thresh = opt.disp_thresh * dstep
    if opt.smoothness_kernel == 2:
        disp_thresh = disp_thresh ** 2
    lam = opt.lambda_ * Kocc * N / disp_thresh
    if opt.connect == 8:
        lam /= 2.0

    tex_weight = float(opt.tex_weight)
    if tex_weight:
        tex_thresh = (opt.tex_thresh if opt.tex_thresh is not None
                      else opt.col_thresh)
        tex_thresh = tex_thresh ** 2 * C * 2
        tex_weight = tex_weight / tex_thresh
        # cached per-pixel sample library over (view, depth)
        lib = sample_depth_colors(images, P, disps, sz)  # [N, M, H, W, C]
        lib = jnp.transpose(lib, (2, 3, 4, 0, 1)).reshape(H, W, C, -1)

    s_tails, s_heads = _smoothness_edges(sz, opt.connect)

    D = np.full((H, W), disps[0])
    energies, unlabelled = [], []

    for loop in range(opt.num_loops):
        D_old_loop = D.copy()
        sweep = disps[1:] if loop == 0 else disps
        for d in sweep:
            D_new = np.full((H, W), d)
            D_pair = jnp.asarray(np.stack([D, D_new]), jnp.float32)
            proj = _project(images, P, D_pair, sz)

            IA = np.stack([np.asarray(p[0], np.float64).reshape(2 * tp, C)
                           for p in proj], axis=2)  # [2tp, C, N]
            V = np.ones((2 * tp, N), bool)
            VA = np.ones((2 * tp, N), bool)
            oc_pt, oc_occ, oc_view = [], [], []  # occlusion-edge arrays
            for a, (_, u, v, z) in enumerate(proj):
                prs = _occluding_pairs(u, v, z, tp, max_offsets=max_offsets)
                if not len(prs):
                    continue
                old_occ = prs[:, 0] < tp
                V[prs[old_occ, 1], a] = False
                if opt.visibility:
                    VA[prs[:, 1], a] = False
                    oc_pt.append(prs[:, 1])
                    oc_occ.append(prs[:, 0])
                    oc_view.append(np.full(len(prs), a))

            U, dpairs, dtriples = gen_cliques(IA, VA, V, Kocc)

            # visibility-node ids: one per VA-occluded (point, view)
            vn_index = np.full((2 * tp, N), -1, np.int64)
            occ_pts, occ_views = np.nonzero(~VA)
            vn_index[occ_pts, occ_views] = tp + np.arange(len(occ_pts))
            n_nodes = tp + len(occ_pts)

            U0 = np.zeros(n_nodes)
            U1 = np.zeros(n_nodes)
            U0[:tp] = U[:, 0]
            U1[:tp] = U[:, 1]

            # data cliques against visnodes: label 0 fills (E00, E01),
            # label 1 fills (E10, E11)
            dp = dpairs
            d0 = dp["label"] == 0
            d_tails = dp["pixel"]
            d_heads = vn_index[dp["label"] * tp + dp["pixel"], dp["view"]]
            dE00 = np.where(d0, dp["e_occl"], 0.0)
            dE01 = np.where(d0, dp["e_vis"], 0.0)
            dE10 = np.where(d0, 0.0, dp["e_occl"])
            dE11 = np.where(d0, 0.0, dp["e_vis"])

            triples = []
            for pxl, label, v1, v2, tab in dtriples:
                s1 = vn_index[label * tp + pxl, v1]
                s2 = vn_index[label * tp + pxl, v2]
                full = np.zeros((2, 2, 2))
                full[label] = np.asarray(tab).reshape(2, 2)
                triples.append((pxl, s1, s2, full))

            # Kinf occlusion edges (ibr_occlrender.m:178-184): occluder pixel
            # selecting the occluding surface forbids "visible"
            if oc_pt:
                o_pt = np.concatenate(oc_pt)
                o_occ = np.concatenate(oc_occ)
                o_view = np.concatenate(oc_view)
                o0 = o_occ < tp  # occluder from the old surface (label 0)
                o_tails = o_occ % tp
                o_heads = vn_index[o_pt, o_view]
                oE01 = np.where(o0, KINF, 0.0)
                oE11 = np.where(o0, 0.0, KINF)
                zo = np.zeros(len(o_pt))
            else:
                o_tails = o_heads = np.zeros(0, np.int64)
                oE01 = oE11 = zo = np.zeros(0)

            tails = [d_tails, o_tails]
            heads = [d_heads, o_heads]
            E = [[np.zeros(len(d_tails)), zo],
                 [dE01, oE01],
                 [dE10, np.zeros(len(o_tails))],
                 [dE11, oE11]]
            E[0][0] = dE00

            # smoothness (+ texture modulation)
            dv = np.stack([D.ravel(), D_new.ravel()])  # [2, tp]
            se = np.empty((4, len(s_tails)))
            for li, (lt, lh) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
                diff = dv[lt, s_tails] - dv[lh, s_heads]
                se[li] = (diff ** 2 if opt.smoothness_kernel == 2
                          else np.abs(diff))
            se = np.minimum(se, disp_thresh)
            if tex_weight:
                mean_v = np.where(
                    V.sum(1)[:, None] > 0,
                    np.einsum("pcn,pn->pc", IA, V.astype(np.float64))
                    / np.maximum(V.sum(1), 1)[:, None], OOBV)
                modes = jnp.asarray(
                    mean_v.reshape(2, H, W, C).transpose(1, 2, 0, 3),
                    jnp.float32)  # [H, W, 2, C]
                tcost = _texture_tables(lib, modes, s_tails, s_heads, sz,
                                        tex_thresh, tex_weight)
                se = (1.0 + tcost) * se
            se *= lam
            tails.append(s_tails)
            heads.append(s_heads)
            for li in range(4):
                E[li].append(se[li])

            labels, e, lb, n_unlab, *_ = qpbo_host.solve_with_triples(
                U0, U1, np.concatenate(tails), np.concatenate(heads),
                *[np.concatenate(x) for x in E], triples,
                improve=opt.improve)
            take = labels[:tp] == 1
            D = np.where(take.reshape(H, W), D_new, D)
            energies.append(float(e))
            unlabelled.append(int(n_unlab))
        if np.array_equal(D, D_old_loop):
            break  # no progress this loop (ibr_occlrender.m:308-311)

    # final render: sample at the solved depth, mean over visible views
    # (single surface -> no same-pixel pairs to filter)
    proj = _project(images, P, jnp.asarray(D[None], jnp.float32), sz)
    vis = np.ones((tp, N), bool)
    samples = np.empty((tp, C, N))
    for a, (cols, u, v, z) in enumerate(proj):
        samples[:, :, a] = np.asarray(cols, np.float64)[0].reshape(tp, C)
        prs = _occluding_pairs(u, v, z, tp, max_offsets=max_offsets)
        if len(prs):
            vis[prs[:, 1], a] = False
    num = np.maximum(vis.sum(axis=1), 1)
    img = (np.einsum("pcn,pn->pc", samples, vis.astype(np.float64))
           / num[:, None])
    return OcclRenderResult(
        image=img.reshape(H, W, C),
        depth=D,
        visibility=vis.reshape(H, W, N),
        energies=energies,
        unlabelled=unlabelled,
    )


def _texture_tables(lib, modes, s_tails, s_heads, sz, tex_thresh, tex_weight):
    """Per-edge texture multipliers via truncquad_edges over the cached
    sample library (ibr_occlrender.m:219-227).  Returns [4, E] costs in the
    [00, 01, 10, 11] layout of the smoothness table (tail mode first)."""
    H, W = sz
    lib_f = lib.reshape(H * W, *lib.shape[2:])       # [tp, C, L]
    modes_f = modes.reshape(H * W, 2, -1)            # [tp, 2, C]
    t = edges_mod.truncquad_edges(
        lib_f[s_tails], lib_f[s_heads], modes_f[s_tails], modes_f[s_heads],
        tex_thresh, tex_weight)                      # [E, 2, 2]
    t = np.asarray(t, np.float64)
    return t.reshape(len(s_tails), 4).T
