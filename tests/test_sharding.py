"""Distribution layer: sharded TRW-S must equal the single-device result."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from stereo_tpu.parallel import mesh as mesh_mod
from stereo_tpu.solvers import trws

import oracles


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    H, W = 16, 24
    K = 5
    theta, D0, Q, alphas = oracles.grid_trws_inputs(rng, H, W, K)
    return tuple(jnp.asarray(x) for x in (theta, D0, Q, alphas))


def test_eight_device_mesh_available():
    assert len(jax.devices()) >= 8


@pytest.mark.parametrize("batch,x", [(1, 8), (2, 4)])
def test_sharded_equals_single_device(inputs, batch, x):
    theta, D0, Q, alphas = inputs
    ref = trws.solve(theta, D0, Q, alphas, kernel=1, tol=1.0, maxiter=6,
                     max_relgap=0.0)

    m = mesh_mod.make_mesh(batch * x, batch=batch)
    res = mesh_mod.sharded_solve(m, theta, D0, Q, alphas, kernel=1, tol=1.0,
                                 maxiter=6, max_relgap=0.0)
    assert float(res.energy) == pytest.approx(float(ref.energy), rel=1e-12)
    assert float(res.lower_bound) == pytest.approx(float(ref.lower_bound), rel=1e-12)
    np.testing.assert_array_equal(np.asarray(res.labels), np.asarray(ref.labels))


@pytest.mark.parametrize("batch,x", [(1, 8), (2, 4)])
def test_sharded_compact_equals_single_device(inputs, batch, x):
    """The compacted sweeps (ops/checker.py) partition over the 'x' axis
    exactly like the standard path: sharded == single-device for matching
    compact settings."""
    theta, D0, Q, alphas = inputs
    ref = trws.solve(theta, D0, Q, alphas, kernel=1, tol=1.0, maxiter=6,
                     max_relgap=0.0, compact=True)

    m = mesh_mod.make_mesh(batch * x, batch=batch)
    res = mesh_mod.sharded_solve(m, theta, D0, Q, alphas, kernel=1, tol=1.0,
                                 maxiter=6, max_relgap=0.0, compact=True)
    assert float(res.energy) == pytest.approx(float(ref.energy), rel=1e-12)
    assert float(res.lower_bound) == pytest.approx(float(ref.lower_bound),
                                                   rel=1e-12)
    np.testing.assert_array_equal(np.asarray(res.labels),
                                  np.asarray(ref.labels))
    np.testing.assert_allclose(np.asarray(res.messages),
                               np.asarray(ref.messages), rtol=1e-12,
                               atol=1e-12)


def test_batched_pairs_over_mesh(inputs):
    theta, D0, Q, alphas = inputs
    # two stereo "pairs": the same problem and a scaled copy
    thetaB = jnp.stack([theta, theta * 1.5])
    D0B = jnp.stack([D0, D0])
    QB = jnp.stack([Q, Q])
    alphasB = jnp.stack([alphas, alphas * 0.5])

    m = mesh_mod.make_mesh(8, batch=2)
    res = mesh_mod.sharded_solve(m, thetaB, D0B, QB, alphasB, kernel=1,
                                 tol=1.0, maxiter=5, max_relgap=0.0)
    assert res.energy.shape == (2,)
    for b, (th, al) in enumerate([(theta, alphas), (theta * 1.5, alphas * 0.5)]):
        ref = trws.solve(th, D0, Q, al, kernel=1, tol=1.0, maxiter=5,
                         max_relgap=0.0)
        assert float(res.energy[b]) == pytest.approx(float(ref.energy), rel=1e-12)
        assert float(res.lower_bound[b]) == pytest.approx(
            float(ref.lower_bound), rel=1e-12
        )


def test_model_level_batched_fusion():
    """Two NCC models fused simultaneously over a (2, 4) mesh match their
    individually-solved results."""
    import copy

    from stereo_tpu.models.ncc import DispMapNCC
    from stereo_tpu.parallel import batch as batch_mod
    from stereo_tpu import geometry as geom

    rng = np.random.default_rng(0)
    H, W = 16, 24

    def make_model(seed):
        r = np.random.default_rng(seed)
        im1 = r.uniform(0, 255, (H, W, 3))
        im0 = np.roll(im1, 3, axis=1) + r.normal(0, 2, (H, W, 3))
        return DispMapNCC([im0, im1], np.arange(0, 7), kernel=1,
                          unary_weight=40.0, tol=8.0)

    models = [make_model(1), make_model(2)]
    props = [
        [geom.fronto_parallel(H, W, float(d), models[0].dtype) for d in (0, 3, 6)]
        for _ in models
    ]

    # individual reference solves at the same fixed iteration budget
    from stereo_tpu.parallel.batch import batched_problem

    unary, D0, Q, alphas, stacks = batched_problem(models, props)
    singles = []
    for b in range(2):
        r = trws.solve(unary[b], D0[b], Q[b], alphas[b], kernel=1,
                       tol=models[0].tol, maxiter=4, max_relgap=0.0)
        singles.append((float(r.energy), float(r.lower_bound)))

    m = mesh_mod.make_mesh(8, batch=2)
    out = batch_mod.simultaneous_fusion_batched(models, props, m,
                                                maxiter=4, max_relgap=0.0)
    for (e_b, lb_b, it_b), (e_s, lb_s) in zip(out, singles):
        assert it_b == 4
        assert e_b == pytest.approx(e_s, rel=1e-10)
        assert lb_b == pytest.approx(lb_s, rel=1e-10)
    # and the fused assignments carry the decoded labels
    for dm in models:
        assert np.isfinite(dm.energy())


def _pool_models(n, H=16, W=24):
    from stereo_tpu.models.ncc import DispMapNCC
    from stereo_tpu import geometry as geom

    models, props = [], []
    for seed in range(1, n + 1):
        r = np.random.default_rng(seed)
        im1 = r.uniform(0, 255, (H, W, 3))
        im0 = np.roll(im1, 3, axis=1) + r.normal(0, 2, (H, W, 3))
        dm = DispMapNCC([im0, im1], np.arange(0, 7), kernel=1,
                        unary_weight=40.0, tol=8.0)
        models.append(dm)
        props.append([geom.fronto_parallel(H, W, float(d), dm.dtype)
                      for d in (0, 3, 6)])
    return models, props


def test_pool_per_pair_convergence_and_eviction():
    """N = 3 pairs stream through B = 2 slots; pairs converge at their own
    iteration counts and every result matches an individual solve run to the
    same stopping rule."""
    from stereo_tpu.parallel import batch as batch_mod

    models, props = _pool_models(3)
    singles = []
    for dm, pr in zip(models, props):
        unary, D0, Q, alphas, _ = batch_mod.batched_problem([dm], [pr])
        r = trws.solve(unary[0], D0[0], Q[0], alphas[0], kernel=1,
                       tol=dm.tol, maxiter=200, max_relgap=1e-4,
                       check_every=5)
        singles.append(r)

    m = mesh_mod.make_mesh(8, batch=2)
    out = batch_mod.simultaneous_fusion_pool(
        models, props, m, maxiter=200, max_relgap=1e-4, check_every=5)
    assert len(out) == 3
    for res, ref in zip(out, singles):
        assert res["status"] in ("converged", "maxiter")
        assert res["energy"] == pytest.approx(float(ref.energy), rel=1e-6)
        assert res["lower_bound"] == pytest.approx(float(ref.lower_bound),
                                                   rel=1e-6)
        assert res["iterations"] >= int(ref.iterations)
        # chunked restart checks every 5 sweeps like the reference run
        assert res["iterations"] - int(ref.iterations) <= 5
    for dm in models:
        assert np.isfinite(dm.energy())


def test_pool_failure_graceful(monkeypatch):
    """A persistently-failing backend ends the pool gracefully: models keep
    their incumbents, unfinished pairs report status 'failed'
    (ojw_stereo_optim.m:116-127 behavior)."""
    from stereo_tpu.parallel import batch as batch_mod

    models, props = _pool_models(2)
    before = [np.asarray(dm.assignment).copy() for dm in models]

    def boom(*a, **k):
        raise RuntimeError("injected backend drop")

    monkeypatch.setattr(batch_mod.mesh_mod, "sharded_solve", boom)
    m = mesh_mod.make_mesh(8, batch=2)
    out = batch_mod.simultaneous_fusion_pool(
        models, props, m, maxiter=50, max_relgap=1e-4, check_every=5,
        max_retries=1)
    assert all(r["status"] == "failed" for r in out)
    for dm, b in zip(models, before):
        np.testing.assert_array_equal(np.asarray(dm.assignment), b)


# ------------------------------------------------------- banded gy-stripes
def _banded_ref_and_dist(H, W, K, Bh, Bw, kernel, n, sweeps, dec, seed=0,
                         warm=False):
    from stereo_tpu.solvers import banded, banded_dist

    rng = np.random.default_rng(seed)
    theta, D0, Q, alphas = (jnp.asarray(x)
                            for x in oracles.grid_trws_inputs(rng, H, W, K))
    run = banded.BandedRun(theta, D0, Q, alphas, kernel=kernel, tol=1.0,
                           Bh=Bh, Bw=Bw)
    st = run.init_state()
    msgs_in = None
    if warm:
        st, _, _, _ = run.run(st, 2, 2)
        msgs_in = run.messages(st)
        st = run.init_state(msgs_in)
    st, bestE, lb, bestL = run.run(st, sweeps, dec)

    mesh = banded_dist.make_y_mesh(n)
    res = banded_dist.sharded_banded_run(
        mesh, theta, D0, Q, alphas, kernel=kernel, tol=1.0, Bh=Bh, Bw=Bw,
        sweeps=sweeps, decode_every=dec, messages=msgs_in)
    return (bestE, lb, bestL, run.messages(st)), res


@pytest.mark.parametrize("n,Bh,Bw,kernel", [(2, 4, 4, 1), (4, 4, 4, 1),
                                            (8, 2, 3, 2), (4, 4, 5, 2)])
def test_sharded_banded_equals_single_device(n, Bh, Bw, kernel):
    """Banded TRW-S over gy stripes: labels bitwise-equal to the
    single-device solver; messages to reassociation noise (different XLA
    programs may contract FMAs differently — observed <= 1 ulp)."""
    H, W, K = 32, 13, 4  # ragged W (x-padding exercised in every config)
    ref, res = _banded_ref_and_dist(H, W, K, Bh, Bw, kernel, n,
                                    sweeps=6, dec=3)
    bestE, lb, bestL, msgs = ref
    np.testing.assert_array_equal(np.asarray(res.labels), np.asarray(bestL))
    np.testing.assert_allclose(np.asarray(res.messages), np.asarray(msgs),
                               rtol=0, atol=1e-12)
    assert float(res.energy) == pytest.approx(float(bestE), rel=1e-12)
    assert float(res.lower_bound) == pytest.approx(float(lb), rel=1e-9)


def test_sharded_banded_ragged_rows_and_warm_start():
    """Last stripe carries the image's padded rows; warm-started messages
    round-trip through the stripe layout bitwise."""
    ref, res = _banded_ref_and_dist(30, 11, 3, 4, 4, 1, n=4, sweeps=4,
                                    dec=2, seed=3, warm=True)
    bestE, lb, bestL, msgs = ref
    np.testing.assert_array_equal(np.asarray(res.labels), np.asarray(bestL))
    np.testing.assert_allclose(np.asarray(res.messages), np.asarray(msgs),
                               rtol=0, atol=1e-12)
    assert float(res.energy) == pytest.approx(float(bestE), rel=1e-12)


def test_sharded_banded_rejects_uneven_stripes():
    from stereo_tpu.solvers import banded_dist

    rng = np.random.default_rng(0)
    theta, D0, Q, alphas = (jnp.asarray(x)
                            for x in oracles.grid_trws_inputs(rng, 12, 8, 3))
    mesh = banded_dist.make_y_mesh(8)
    with pytest.raises(ValueError, match="block-rows"):
        banded_dist.sharded_banded_run(mesh, theta, D0, Q, alphas, kernel=1,
                                       tol=1.0, Bh=2, Bw=4, sweeps=2)


def test_sharded_banded_batched_pairs():
    """(2, 4) mesh: two stereo pairs over 'batch', each pair's gy stripes
    over 'y' — labels bitwise per pair vs single-device BandedRun."""
    from stereo_tpu.solvers import banded, banded_dist

    rng = np.random.default_rng(1)
    H, W, K, Bh, Bw = 24, 10, 3, 3, 4
    a = oracles.grid_trws_inputs(rng, H, W, K)
    b = oracles.grid_trws_inputs(rng, H, W, K)
    stack = [jnp.stack([jnp.asarray(x), jnp.asarray(y)])
             for x, y in zip(a, b)]

    mesh = banded_dist.make_y_mesh(8, batch=2)
    res = banded_dist.sharded_banded_run(
        mesh, *stack, kernel=1, tol=1.0, Bh=Bh, Bw=Bw, sweeps=4,
        decode_every=2)
    assert res.energy.shape == (2,)
    for i, inp in enumerate((a, b)):
        run = banded.BandedRun(*(jnp.asarray(x) for x in inp), kernel=1,
                               tol=1.0, Bh=Bh, Bw=Bw)
        _, bestE, lb, bestL = run.run(run.init_state(), 4, 2)
        np.testing.assert_array_equal(np.asarray(res.labels[i]),
                                      np.asarray(bestL))
        assert float(res.energy[i]) == pytest.approx(float(bestE), rel=1e-12)
        assert float(res.lower_bound[i]) == pytest.approx(float(lb),
                                                          rel=1e-9)


# ------------------------------------------------------ distributed fusion
def _fusion_inputs(H, W, seed=0):
    rng = np.random.default_rng(seed)

    def planes(r):
        p = r.standard_normal((4, H, W))
        p[2] = np.sign(p[2]) * (np.abs(p[2]) + 0.5)
        return jnp.asarray(p)

    from stereo_tpu import energy as energy_mod

    cur = planes(rng)
    prop = planes(rng)
    w = energy_mod.default_weights(H, W, dtype=jnp.float64)
    U0 = jnp.asarray(rng.uniform(0, 3, (H, W)))
    U1 = jnp.asarray(rng.uniform(0, 3, (H, W)))
    return cur, prop, U0, U1, w


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("kernel", [1, 2])
def test_sharded_fusion_step_bitwise(n, kernel):
    """One fusion move sharded over n column stripes: take-mask and fused
    planes bitwise-equal to the single-device move (same sort-based
    acceptance), energy/lb to reassociation."""
    from stereo_tpu.parallel import fusion_dist
    from stereo_tpu.solvers import binary
    from stereo_tpu import energy as energy_mod

    H, W, tol = 12, 24, 0.9
    cur, prop, U0, U1, w = _fusion_inputs(H, W, seed=n + 10 * kernel)

    D0, Q = binary.fusion_problem(cur, prop)
    ref = binary.binary_fuse(U0, U1, D0, Q, w, kernel=kernel, tol=tol,
                             maxiter=30, max_relgap=0.0,
                             accept_method="sort")
    ref_fused = energy_mod.fuse_labelling(cur, prop, ref.take)

    m = mesh_mod.make_mesh(n, batch=1)
    fused, take, e, lb = fusion_dist.sharded_fusion_step(
        m, cur, prop, U0, U1, w, kernel=kernel, tol=tol, maxiter=30,
        max_relgap=0.0)
    np.testing.assert_array_equal(np.asarray(take), np.asarray(ref.take))
    np.testing.assert_array_equal(np.asarray(fused), np.asarray(ref_fused))
    assert float(e) == pytest.approx(float(ref.energy), rel=1e-12)
    assert float(lb) == pytest.approx(float(ref.lower_bound), rel=1e-9)
    # never-increase under sharding: vs the keep-everything energy
    e_keep = binary._k2_energy(jnp.zeros((H, W), bool), U0, U1,
                               binary._tables(D0, Q, w, kernel, tol))
    assert float(e) <= float(e_keep) + 1e-9


def test_sharded_connected_components_cross_shard():
    """Components that snake across every shard cut (U-shapes spanning the
    full width, single-pixel bridges at alternating ends) get one id each —
    the shift-doubling flood merges across cuts exactly as within a shard."""
    from stereo_tpu.solvers import binary
    from jax.sharding import NamedSharding, PartitionSpec as P

    H, W = 16, 24
    z = np.zeros((H, W), bool)
    # serpentine: rows 0,2,4,... full-width, connected by end bridges
    for r in range(0, H, 2):
        z[r, :] = True
    for r in range(1, H - 1, 2):
        z[r, -1 if (r // 2) % 2 == 0 else 0] = True
    ref = np.asarray(binary.connected_components(jnp.asarray(z)))

    m = mesh_mod.make_mesh(8, batch=1)
    zs = jax.device_put(jnp.asarray(z), NamedSharding(m, P(None, "x")))
    with m:
        out = jax.jit(binary.connected_components,
                      out_shardings=NamedSharding(m, P(None, "x")))(zs)
    np.testing.assert_array_equal(np.asarray(out), ref)
    # the serpentine is a single component: one unique id over its pixels
    assert len(np.unique(ref[z])) == 1


def test_sharded_fusion_sweep_matches_per_move():
    """A 6-proposal stream through sharded_fusion_sweep equals the per-move
    single-device loop bitwise (planes), with a monotone energy trace; padded
    (live=False) entries are identities."""
    from stereo_tpu.parallel import fusion_dist
    from stereo_tpu.solvers import binary
    from stereo_tpu import energy as energy_mod
    import jax.tree_util as jtu

    H, W, tol, kernel = 12, 24, 0.9, 1
    rng = np.random.default_rng(5)

    def planes(r):
        p = r.standard_normal((4, H, W))
        p[2] = np.sign(p[2]) * (np.abs(p[2]) + 0.5)
        return jnp.asarray(p)

    cur = planes(rng)
    props = [planes(rng) for _ in range(6)]
    w = energy_mod.default_weights(H, W, dtype=jnp.float64)
    base = jnp.asarray(rng.uniform(0, 3, (H, W)))

    def unary_fn(base, p):
        return base + 0.3 * jnp.abs(p[3])

    unary_p = jtu.Partial(unary_fn, base)

    # per-move single-device reference (sort acceptance, same budget)
    ref = cur
    es_ref = []
    for p in props:
        U0 = unary_p(ref)
        U1 = unary_p(p)
        D0, Q = binary.fusion_problem(ref, p)
        r = binary.binary_fuse(U0, U1, D0, Q, w, kernel=kernel, tol=tol,
                               maxiter=30, max_relgap=0.0,
                               accept_method="sort")
        ref = energy_mod.fuse_labelling(ref, p, r.take)
        es_ref.append(float(r.energy))

    m = mesh_mod.make_mesh(4, batch=1)
    stack = jnp.stack(props + [props[-1]] * 2, 0)  # 2 padded entries
    live = jnp.arange(8) < 6
    fused, es, lbs = fusion_dist.sharded_fusion_sweep(
        m, cur, stack, w, unary_p, kernel=kernel, tol=tol, live=live,
        maxiter=30, max_relgap=0.0)
    np.testing.assert_array_equal(np.asarray(fused), np.asarray(ref))
    np.testing.assert_allclose(np.asarray(es)[:6], np.asarray(es_ref),
                               rtol=1e-12)
    # monotone non-increasing energy trace over the live moves
    assert all(b <= a + 1e-9 for a, b in zip(es_ref, es_ref[1:]))
