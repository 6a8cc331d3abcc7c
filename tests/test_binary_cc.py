"""Segmented-min scan + connected components: exactness on random masks."""

import numpy as np
import jax.numpy as jnp
import pytest

from stereo_tpu.solvers import binary


def _ref_segmented_min(m, live, axis, reverse):
    """Sequential fold of the scan monoid: at a wall the fold restarts at
    the wall's own value (combine(a, b) = b.min when b is a wall)."""
    mm = np.moveaxis(np.asarray(m), axis, -1)
    ll = np.moveaxis(np.asarray(live), axis, -1)
    out = np.empty_like(mm)
    n = mm.shape[-1]
    order = range(n - 1, -1, -1) if reverse else range(n)
    for line in np.ndindex(mm.shape[:-1]):
        acc = None
        for i in order:
            v = mm[line + (i,)]
            if not ll[line + (i,)]:
                res = v
            else:
                res = v if acc is None else min(acc, v)
            out[line + (i,)] = res
            acc = res
    return np.moveaxis(out, -1, axis)


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_segmented_min_scan_matches_reference(axis, reverse, seed):
    rng = np.random.default_rng(seed)
    H, W = 13, 17
    m = rng.integers(0, 1000, (H, W)).astype(np.int32)
    live = rng.random((H, W)) < 0.6
    got = np.asarray(binary._segmented_min_scan(
        jnp.asarray(m), jnp.asarray(live), axis, reverse))
    want = _ref_segmented_min(m, live, axis, reverse)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 3, 7, 11])
@pytest.mark.parametrize("p", [0.3, 0.55, 0.8])
def test_connected_components_match_scipy_style_labeling(seed, p):
    rng = np.random.default_rng(seed)
    H, W = 21, 18
    z = rng.random((H, W)) < p
    comp = np.asarray(binary.connected_components(jnp.asarray(z)))
    # reference: BFS flood fill, component id = min flat index
    want = np.full((H, W), H * W, np.int32)
    seen = np.zeros((H, W), bool)
    for y in range(H):
        for x in range(W):
            if not z[y, x] or seen[y, x]:
                continue
            stack = [(y, x)]
            seen[y, x] = True
            members = []
            while stack:
                cy, cx = stack.pop()
                members.append((cy, cx))
                for dy, dx in ((0, 1), (0, -1), (1, 0), (-1, 0)):
                    ny, nx = cy + dy, cx + dx
                    if (0 <= ny < H and 0 <= nx < W and z[ny, nx]
                            and not seen[ny, nx]):
                        seen[ny, nx] = True
                        stack.append((ny, nx))
            mid = min(my * W + mx for my, mx in members)
            for my, mx in members:
                want[my, mx] = mid
    np.testing.assert_array_equal(comp, want)


def test_accept_components_sort_matches_scatter():
    """The sort+segmented-scan verdict path is exact: identical take masks
    to the scatter-add path on fuzzed instances."""
    import jax.numpy as jnp
    from stereo_tpu import energy as energy_mod
    from stereo_tpu.solvers import binary

    rng = np.random.default_rng(5)
    for trial in range(6):
        H, W = rng.integers(5, 40), rng.integers(5, 40)
        z = jnp.asarray(rng.random((H, W)) < rng.uniform(0.2, 0.8))
        theta0 = jnp.asarray(rng.standard_normal((H, W)))
        theta1 = jnp.asarray(rng.standard_normal((H, W)))
        w = energy_mod.default_weights(int(H), int(W), dtype=jnp.float64)
        planes0 = jnp.asarray(rng.standard_normal((4, H, W)))
        planes1 = jnp.asarray(rng.standard_normal((4, H, W)))
        D0, Q = binary.fusion_problem(planes0, planes1)
        V = binary._tables(D0, Q, w, 1, 1.0)
        a = binary.accept_components(z, theta0, theta1, V, method="scatter")
        b = binary.accept_components(z, theta0, theta1, V, method="sort")
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("method", ["sort", "scatter"])
def test_accept_components_repeatable(method):
    """The same decoded mask accepted twice gives the same take-mask."""
    rng = np.random.default_rng(21)
    H, W = 24, 31
    z = jnp.asarray(rng.random((H, W)) < 0.5)
    theta0, theta1 = (jnp.asarray(rng.normal(0, 1, (H, W)), jnp.float32)
                      for _ in range(2))
    V = jnp.asarray(rng.normal(0, 1, (4, 2, 2, H, W)), jnp.float32)
    a = binary.accept_components(z, theta0, theta1, V, method=method)
    b = binary.accept_components(z, theta0, theta1, V, method=method)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
