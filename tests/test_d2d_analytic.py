"""Analytic D2D derivatives vs the autodiff oracle (ops/d2d.py) —
the correctness check SURVEY.md §7 calls essential for hand-derived
`derivativesNDT` replacements."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ndt_feature_graph_tpu.config import MatcherParams, NDTMapParams
from ndt_feature_graph_tpu.ops import d2d, d2d_analytic, ndt_map

MAP = NDTMapParams(
    resolution=0.5, size_x=30.0, size_y=30.0, sensor_range=15.0,
    max_points_per_scan=512, max_cells=256,
)
MATCH = MatcherParams()


def _world(key):
    import sys

    sys.path.insert(0, "tests")
    from test_d2d import build, make_world

    pts = make_world(key)
    grid = build(pts)
    tgt = d2d.make_dense_target(grid, MAP)
    src = ndt_map.to_cell_list(grid, MAP)
    return src, tgt


@pytest.mark.parametrize(
    "d_eval",
    [
        (0.0, 0.0, 0.0),
        (0.05, -0.03, 0.02),
        (-0.2, 0.15, -0.12),
        (0.4, 0.3, 0.35),
    ],
)
def test_dense_fgh_matches_autodiff(d_eval):
    src, tgt = _world(jax.random.PRNGKey(0))
    T0 = jnp.array([0.1, -0.05, 0.07])
    d = jnp.array(d_eval, jnp.float32)

    def score(dd):
        return d2d.d2d_score_dense(dd, T0, src, tgt, MAP, MATCH)

    f_ref = float(score(d))
    g_ref = np.asarray(jax.grad(score)(d))
    H_ref = np.asarray(jax.jacfwd(jax.grad(score))(d))

    f, g, H = d2d_analytic.fgh_dense(d, T0, src, tgt, MAP, MATCH)
    np.testing.assert_allclose(float(f), f_ref, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(np.asarray(g), g_ref, rtol=2e-3,
                               atol=2e-2)
    np.testing.assert_allclose(np.asarray(H), H_ref, rtol=2e-3,
                               atol=5e-1)
    # Relative Hessian agreement (H entries are O(1e3+)).
    scale = np.abs(H_ref).max()
    np.testing.assert_allclose(
        np.asarray(H) / scale, H_ref / scale, atol=2e-4
    )


def test_paired_fgh_matches_autodiff():
    key = jax.random.PRNGKey(1)
    means = jax.random.uniform(key, (32, 2), minval=-5.0, maxval=5.0)
    covs = jnp.tile(jnp.eye(2) * 2e-4, (32, 1, 1))
    mask = jnp.ones(32, bool)
    tgt = ndt_map.CellList(means, covs, mask)
    from ndt_feature_graph_tpu.core import se2

    src = ndt_map.CellList(
        se2.transform_points(jnp.array([-0.3, 0.2, -0.1]), means),
        covs, mask,
    )
    T0 = jnp.array([0.05, 0.1, 0.04])
    d = jnp.array([0.1, -0.08, 0.06])

    def score(dd):
        return d2d.d2d_score_paired(dd, T0, src, tgt, MATCH)

    f_ref = float(score(d))
    g_ref = np.asarray(jax.grad(score)(d))
    H_ref = np.asarray(jax.jacfwd(jax.grad(score))(d))

    f, g, H = d2d_analytic.fgh_paired(d, T0, src, tgt, MATCH)
    np.testing.assert_allclose(float(f), f_ref, rtol=1e-5, atol=1e-5)
    scale = max(np.abs(g_ref).max(), 1e-9)
    np.testing.assert_allclose(
        np.asarray(g) / scale, g_ref / scale, atol=1e-4
    )
    scale = max(np.abs(H_ref).max(), 1e-9)
    np.testing.assert_allclose(
        np.asarray(H) / scale, H_ref / scale, atol=1e-4
    )


def test_mahalanobis_fgh():
    Q = jnp.asarray(np.diag([4.0, 2.0, 8.0]).astype(np.float32))
    d = jnp.array([0.5, -1.0, 0.25])

    def score(dd):
        return d2d.mahalanobis_score(dd, Q)

    f, g, H = d2d_analytic.fgh_mahalanobis(d, Q)
    np.testing.assert_allclose(float(f), float(score(d)), rtol=1e-6)
    np.testing.assert_allclose(
        np.asarray(g), np.asarray(jax.grad(score)(d)), atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(H), np.asarray(jax.hessian(score)(d)), atol=1e-5
    )


def test_wide_batch_matches_flat_batch():
    """The win-row batched fgh (fgh_dense_wide_batch over
    d2d.build_wide_table) must match fgh_dense_flat_batch exactly:
    same rows, same masks, (2n+1)x fewer gather transactions.
    Coverage includes source cells whose CENTRE column is just off the
    grid (ix0 in [-n, -1] / [w, w+n-1]) but whose windows still touch
    valid target cells — the edge band where the pre-padded-layout
    wide path diverged (ADVICE round 4)."""
    import numpy as np

    from ndt_feature_graph_tpu.ops import d2d
    from ndt_feature_graph_tpu.ops.ndt_map import CellList

    rng = np.random.default_rng(7)
    h = w = 24
    b, n_src = 3, 21
    n_nodes = b
    packed = np.zeros((n_nodes, h * w, 8), np.float32)
    packed[:] = np.asarray(d2d.empty_pack_row())
    for k in range(n_nodes):
        filled = rng.choice(h * w, 120, replace=False)
        # Valid target cells ON the vertical edges (rows around h/2,
        # where the rigged off-grid-centre source cells land) so those
        # windows have in-grid cells to score against.
        edge_rows = np.arange(h // 2 - 3, h // 2 + 4)
        filled = np.concatenate(
            [filled, edge_rows * w, edge_rows * w + 1,
             edge_rows * w + (w - 1), edge_rows * w + (w - 2)]
        )
        for c in filled:
            mean = rng.normal(0, 4.0, 2)
            a = rng.uniform(0.01, 0.05)
            cc = rng.uniform(0.01, 0.05)
            bb = rng.uniform(-0.005, 0.005)
            packed[k, c] = [mean[0], mean[1], a, bb, cc, 1.0, 0, 0]
    m = MatcherParams()

    # Origins so some windows fall off every edge.
    origins = rng.uniform(-7.0, -4.0, (b, 2)).astype(np.float32)
    d_b = rng.normal(0, 0.1, (b, 3)).astype(np.float32)
    T0_b = rng.normal(0, 0.2, (b, 3)).astype(np.float32)
    res = 0.5

    # Re-point the edge cells' gaussian means near their own cell's
    # world position so the rigged off-grid-centre windows produce
    # non-underflowing scores (otherwise the edge-band coverage would
    # degenerate to comparing 0 == 0).
    edge_rows = np.arange(h // 2 - 3, h // 2 + 4)
    for k in range(n_nodes):
        for ecol in (0, 1, w - 2, w - 1):
            for r in edge_rows:
                cx = origins[k, 0] + (ecol + 0.5) * res
                cy = origins[k, 1] + (r + 0.5) * res
                packed[k, r * w + ecol, 0] = cx + rng.normal(0, 0.2)
                packed[k, r * w + ecol, 1] = cy + rng.normal(0, 0.2)
    packed = jnp.asarray(packed)

    src_means = rng.normal(0, 4.0, (b, n_src, 2)).astype(np.float32)
    # Rig the last 4 means per lane so their TRANSFORMED positions land
    # at centre columns ix0 = -1, -2, w, w+1 (off-grid centres with
    # in-grid window cells).  mean = T^{-1}(target_world).
    for i in range(b):
        ci, si = np.cos(d_b[i, 2]), np.sin(d_b[i, 2])
        tx = ci * T0_b[i, 0] - si * T0_b[i, 1] + d_b[i, 0]
        ty = si * T0_b[i, 0] + ci * T0_b[i, 1] + d_b[i, 1]
        th = d_b[i, 2] + T0_b[i, 2]
        c, s = np.cos(th), np.sin(th)
        ymid = origins[i, 1] + h * res / 2.0
        for k, ix0_want in enumerate((-1, -2, w, w + 1)):
            wx = origins[i, 0] + (ix0_want + 0.5) * res
            dxv, dyv = wx - tx, ymid - ty
            src_means[i, n_src - 1 - k] = (
                c * dxv + s * dyv, -s * dxv + c * dyv
            )
    src = CellList(
        means=jnp.asarray(src_means),
        covs=jnp.asarray(
            np.tile(
                (np.eye(2) * 0.03).astype(np.float32),
                (b, n_src, 1, 1),
            )
        ),
        mask=jnp.asarray(
            np.concatenate(
                [rng.random((b, n_src - 4)) > 0.2,
                 np.ones((b, 4), bool)], axis=1
            )
        ),
    )
    origins = jnp.asarray(origins)
    d_b = jnp.asarray(d_b)
    T0_b = jnp.asarray(T0_b)
    row_offsets = jnp.arange(b, dtype=jnp.int32) * (h * w)

    flat8 = packed.reshape(-1, 8)
    f1, g1, H1 = d2d_analytic.fgh_dense_flat_batch(
        d_b, T0_b, src, flat8, origins, row_offsets, h, w, res, m
    )
    wide = d2d.build_wide_table(packed, h, w, m.n_neighbours)
    wide_flat = wide.reshape(-1, wide.shape[-1])
    f2, g2, H2 = d2d_analytic.fgh_dense_wide_batch(
        d_b, T0_b, src, wide_flat, origins, h, w, res, m
    )
    np.testing.assert_allclose(
        np.asarray(f1), np.asarray(f2), rtol=1e-6, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(g1), np.asarray(g2), rtol=1e-5, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(H1), np.asarray(H2), rtol=1e-5, atol=1e-5
    )
    # The rigged off-grid-centre cells must actually contribute
    # (guards the edge-band coverage against degenerating to 0 == 0).
    rig_mask = np.zeros((b, n_src), bool)
    rig_mask[:, -4:] = True
    rig = CellList(
        means=src.means, covs=src.covs, mask=jnp.asarray(rig_mask)
    )
    fr, _, _ = d2d_analytic.fgh_dense_flat_batch(
        d_b, T0_b, rig, flat8, origins, row_offsets, h, w, res, m
    )
    assert np.all(np.asarray(fr) < -1e-4), np.asarray(fr)
    # WIN-BLOCK table (one gathered row per source cell): identical to
    # the flat path everywhere too — same windows, same masks, via the
    # doubly-padded block layout.  Window = the whole grid here.
    blockf, cell0 = d2d.build_window_block_tables(
        packed, origins, origins + (h * res / 2.0), h, w,
        m.n_neighbours, min(h, w), res, bf16=False,
    )
    hp = min(h, w) + 2 * m.n_neighbours
    f3, g3, H3 = d2d_analytic.fgh_dense_block_batch(
        d_b, T0_b, src, blockf.reshape(b * hp * hp, -1), cell0,
        origins, min(h, w), res, m,
    )
    np.testing.assert_allclose(
        np.asarray(f1), np.asarray(f3), rtol=1e-6, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(g1), np.asarray(g3), rtol=1e-5, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(H1), np.asarray(H3), rtol=1e-5, atol=1e-5
    )
    # And the flat-batch form itself agrees with per-lane fgh_dense_flat.
    for i in range(b):
        src_i = CellList(
            means=src.means[i], covs=src.covs[i], mask=src.mask[i]
        )
        fi, gi, Hi = d2d_analytic.fgh_dense_flat(
            d_b[i], T0_b[i], src_i, flat8, origins[i],
            row_offsets[i], h, w, res, m,
        )
        np.testing.assert_allclose(
            np.asarray(f1)[i], np.asarray(fi), rtol=1e-5, atol=1e-5
        )


def test_wide_batch_explicit_row_offsets():
    """fgh_dense_wide_batch with EXPLICIT per-lane table-slab offsets
    (the pair-registration shape: several lanes reading the same ref
    node's slab) must equal the flat path with the same mapping."""
    rng = np.random.default_rng(11)
    h = w = 16
    n_nodes, b, n_src = 3, 5, 9
    packed = np.zeros((n_nodes, h * w, 8), np.float32)
    packed[:] = np.asarray(d2d.empty_pack_row())
    for k in range(n_nodes):
        for c in rng.choice(h * w, 80, replace=False):
            mean = rng.normal(0, 3.0, 2)
            packed[k, c] = [mean[0], mean[1],
                            rng.uniform(0.01, 0.05),
                            rng.uniform(-0.005, 0.005),
                            rng.uniform(0.01, 0.05), 1.0, 0, 0]
    packed = jnp.asarray(packed)
    m = MatcherParams()
    from ndt_feature_graph_tpu.ops.ndt_map import CellList

    ref = jnp.asarray([2, 0, 2, 1, 0], jnp.int32)   # repeated slabs
    origins = jnp.asarray(
        rng.uniform(-5.0, -3.0, (n_nodes, 2)).astype(np.float32)
    )[ref]
    src = CellList(
        means=jnp.asarray(
            rng.normal(0, 3.0, (b, n_src, 2)).astype(np.float32)
        ),
        covs=jnp.asarray(np.tile(
            (np.eye(2) * 0.03).astype(np.float32), (b, n_src, 1, 1)
        )),
        mask=jnp.ones((b, n_src), bool),
    )
    d_b = jnp.asarray(rng.normal(0, 0.1, (b, 3)).astype(np.float32))
    T0_b = jnp.asarray(rng.normal(0, 0.2, (b, 3)).astype(np.float32))
    res = 0.5

    f1, g1, H1 = d2d_analytic.fgh_dense_flat_batch(
        d_b, T0_b, src, packed.reshape(-1, 8), origins,
        ref * (h * w), h, w, res, m,
    )
    wide = d2d.build_wide_table(packed, h, w, m.n_neighbours)
    stride = d2d.wide_row_stride(h, w, m.n_neighbours)
    f2, g2, H2 = d2d_analytic.fgh_dense_wide_batch(
        d_b, T0_b, src, wide.reshape(-1, wide.shape[-1]), origins,
        h, w, res, m, row_offsets=ref * stride,
    )
    np.testing.assert_allclose(np.asarray(f1), np.asarray(f2),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g2),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(H1), np.asarray(H2),
                               rtol=1e-5, atol=1e-5)


def _random_pairs(key, n, k):
    """Random pair geometry for _fgh_reduce: moved source cells (n,),
    gathered targets (n, k), an increment d, and a validity mask."""
    ks = jax.random.split(key, 7)
    means = 3.0 * jax.random.normal(ks[0], (n, 2))
    L = 0.2 * jax.random.normal(ks[1], (n, 2, 2))
    covs = L @ jnp.swapaxes(L, -1, -2) + 0.02 * jnp.eye(2)
    mask = jax.random.bernoulli(ks[2], 0.9, (n,))
    t_means = means[:, None, :] + 0.5 * jax.random.normal(ks[3], (n, k, 2))
    Lt = 0.2 * jax.random.normal(ks[4], (n, k, 2, 2))
    t_covs = Lt @ jnp.swapaxes(Lt, -1, -2) + 0.05 * jnp.eye(2)
    t_valid = jax.random.bernoulli(ks[5], 0.7, (n, k))
    d = 0.1 * jax.random.normal(ks[6], (3,))
    moved = ndt_map.CellList(means, covs, mask)
    return d, moved, t_means, t_covs, t_valid


def _per_pair_reference(d, moved, t_means, t_covs, t_valid, m):
    """Pair by pair: autodiff of one pair's Gaussian-overlap score in
    the left increment p applied on top of d, summed in float64 over
    the valid pairs only."""
    def pair_score(p, x, c, tm, tc):
        c_, s_ = jnp.cos(p[2]), jnp.sin(p[2])
        R = jnp.array([[c_, -s_], [s_, c_]])
        mu = R @ (x - d[:2]) + d[:2] + p[:2] - tm
        S = R @ c @ R.T + tc
        q = mu @ jnp.linalg.solve(S, mu)
        return -m.lfd1 * jnp.exp(-0.5 * m.lfd2 * q)

    p0 = jnp.zeros(3)
    fgh = jax.jit(lambda *a: (
        pair_score(p0, *a), jax.grad(pair_score)(p0, *a),
        jax.hessian(pair_score)(p0, *a),
    ))
    ok = np.asarray(t_valid) & np.asarray(moved.mask)[:, None]
    f, g, H = 0.0, np.zeros(3), np.zeros((3, 3))
    for i, j in zip(*np.nonzero(ok)):
        s, gi, Hi = fgh(moved.means[i], moved.covs[i], t_means[i, j],
                        t_covs[i, j])
        f += float(s)
        g += np.asarray(gi, np.float64)
        H += np.asarray(Hi, np.float64)
    return f, g, H


def test_fgh_reduce_matches_per_pair_reference():
    """The shared pair-derivative reduction over random pairs equals
    the pair-by-pair autodiff reference."""
    args = _random_pairs(jax.random.PRNGKey(0), n=12, k=25)
    f, g, H = d2d_analytic._fgh_reduce(*args, MATCH)
    f_ref, g_ref, H_ref = _per_pair_reference(*args, MATCH)
    np.testing.assert_allclose(float(f), f_ref, rtol=1e-4)
    np.testing.assert_allclose(
        np.asarray(g), g_ref, rtol=2e-3, atol=1e-4 * np.abs(g_ref).max()
    )
    np.testing.assert_allclose(
        np.asarray(H), H_ref, rtol=2e-3, atol=1e-4 * np.abs(H_ref).max()
    )


def test_fgh_reduce_padding_is_masked():
    """Masked pairs contribute nothing, whatever they hold: sizes that
    fill no block, and garbage in every masked slot."""
    d, moved, t_means, t_covs, t_valid = _random_pairs(
        jax.random.PRNGKey(1), n=3, k=7
    )
    f, g, H = d2d_analytic._fgh_reduce(
        d, moved, t_means, t_covs, t_valid, MATCH
    )
    ok = t_valid & moved.mask[:, None]
    junk = jnp.where(ok[..., None], t_means, 1e3)
    junk_cov = jnp.where(ok[..., None, None], t_covs, 0.0)
    f2, g2, H2 = d2d_analytic._fgh_reduce(
        d, moved, junk, junk_cov, t_valid, MATCH
    )
    np.testing.assert_array_equal(np.asarray(f2), np.asarray(f))
    np.testing.assert_array_equal(np.asarray(g2), np.asarray(g))
    np.testing.assert_array_equal(np.asarray(H2), np.asarray(H))
    f_ref, g_ref, _ = _per_pair_reference(
        d, moved, t_means, t_covs, t_valid, MATCH
    )
    np.testing.assert_allclose(float(f), f_ref, rtol=1e-4)
    np.testing.assert_allclose(
        np.asarray(g), g_ref, rtol=2e-3, atol=1e-4 * np.abs(g_ref).max()
    )
