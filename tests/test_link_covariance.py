"""Link-covariance calibration: the Hessian-derived registration
covariance (d2d.cov_from_hessian — the ONE convention every consumer
uses) validated against an empirical Monte-Carlo
covariance from re-registering noise-perturbed scan pairs.  Reference
contract: NDTMatcherD2D::covariance feeding link cov_3d at
ndt_feature_graph.cpp:298-330.

Also pins the PSD guarantee that motivated graph/optimize.spd_info_np:
solver information built from device-produced covariances must be
symmetric positive definite (indefinite info was measured to corrupt
the 570-node solve with negative chi2 contributions).
"""

import jax
import jax.numpy as jnp
import numpy as np

from ndt_feature_graph_tpu.config import MatcherParams, NDTMapParams
from ndt_feature_graph_tpu.graph import optimize as opt_mod
from ndt_feature_graph_tpu.ops import d2d, ndt_map

MAP = NDTMapParams(
    resolution=0.5,
    size_x=30.0,
    size_y=30.0,
    max_points_per_scan=512,
    max_cells=256,
)
MATCH = MatcherParams()


def make_world(key, n=400):
    """Structured world (walls + clutter), as in test_d2d."""
    k1, k2, k3 = jax.random.split(key, 3)
    wall1 = jnp.stack(
        [jnp.linspace(-8.0, 8.0, n // 2),
         2.5 + 0.03 * jax.random.normal(k1, (n // 2,))], -1
    )
    wall2 = jnp.stack(
        [-3.0 + 0.03 * jax.random.normal(k2, (n // 4,)),
         jnp.linspace(-6.0, 6.0, n // 4)], -1
    )
    clutter = jax.random.uniform(
        k3, (n - n // 2 - n // 4, 2), minval=-7.0, maxval=7.0
    )
    return jnp.concatenate([wall1, wall2, clutter])


def test_hessian_covariance_tracks_monte_carlo():
    """Re-register 96 observation-noise-perturbed copies of a scan
    against the same target; the spread of the estimates is the
    empirical pose covariance.  The Hessian covariance must (a) be
    finite and PSD, (b) track the Monte-Carlo covariance's scale
    within an order of magnitude on the position diagonal under the
    default cov_scale, and (c) preserve the x-vs-y anisotropy
    ordering.  This calibrates the solver's link-vs-odometry
    information weighting with something measured rather than
    assumed."""
    pts = make_world(jax.random.PRNGKey(0))
    mask = jnp.ones(len(pts), bool)
    grid = ndt_map.build_from_scan(
        MAP, jnp.zeros(2), jnp.zeros(2), pts, mask
    )
    tgt = d2d.make_dense_target(grid, MAP)

    sigma = 0.03  # lidar-class range noise, metres

    @jax.jit
    def register(key):
        noisy = pts + sigma * jax.random.normal(key, pts.shape)
        g = ndt_map.build_from_scan(
            MAP, jnp.zeros(2), jnp.zeros(2), noisy, mask
        )
        src = ndt_map.to_cell_list(g, MAP)
        res = d2d.match_d2d.__wrapped__(
            tgt, src, jnp.zeros(3), MAP, MATCH
        )
        return res.T, res.converged

    keys = jax.random.split(jax.random.PRNGKey(1), 96)
    Ts, conv = jax.vmap(register)(keys)
    Ts = np.asarray(Ts)
    conv = np.asarray(conv)
    assert conv.mean() > 0.9, conv.mean()
    Ts = Ts[conv]
    mc_cov = np.cov(Ts.T)

    # Hessian covariance at the unperturbed optimum.
    src0 = ndt_map.to_cell_list(grid, MAP)
    h_cov = np.asarray(
        d2d.covariance_d2d(tgt, src0, jnp.zeros(3), MAP, MATCH)
    )

    # (a) finite + PSD after the solver-side guard.
    assert np.isfinite(h_cov).all()
    info = opt_mod.spd_info_np(h_cov)
    w = np.linalg.eigvalsh(0.5 * (info + info.T))
    assert (w > 0).all(), w
    assert w.max() <= 1.01e6  # eps=1e-6 floor caps the information

    # (b) CALIBRATED scale agreement: cov_scale (config.MatcherParams)
    # is fitted so the Hessian covariance tracks the Monte-Carlo spread
    # at this noise level (sigma = 0.03, lidar-class) — every diagonal
    # ratio must fall within 3x (measured spread across worlds at the
    # fitted scale is within 2x; see test_covariance_calibration_fit
    # for the multi-world check and the sigma^2 caveat).
    ratios = np.diag(mc_cov) / np.diag(h_cov)
    print(f"MC/Hessian covariance diag ratios (x, y, th): {ratios}")
    assert (ratios > 1 / 3.0).all() and (ratios < 3.0).all(), ratios

    # (c) anisotropy: both agree on which translational direction is
    # better constrained (within noise, allow ties up to 1.5x).
    mc_ratio = mc_cov[0, 0] / mc_cov[1, 1]
    h_ratio = h_cov[0, 0] / h_cov[1, 1]
    assert (mc_ratio - 1) * (h_ratio - 1) > 0 or (
        0.66 < mc_ratio < 1.5
    ), (mc_ratio, h_ratio)


def test_covariance_calibration_fit():
    """Multi-world calibration check at the fitted noise level AND the
    documented limitation: the NDT score Hessian is nearly noise-BLIND
    (its curvature is set by map structure / cell quantization), while
    the true estimator spread scales ~sigma^2.  Measured MC/Hessian
    ratios move ~0.1 -> ~0.6 -> ~2 across sigma 0.01/0.03/0.06
    (cov_scale=1); the fitted cov_scale=0.6 therefore calibrates AT
    sigma=0.03 — asserted within 3x across worlds here — and the
    sigma-dependence is pinned by asserting the 0.01-noise ratio sits
    well BELOW the 0.03 one (if this ever fails, the Hessian has
    become noise-aware and the fit should be revisited)."""
    sigma = 0.03
    ratio_mid = []
    ratio_low = None
    for seed in (5, 9):
        pts = make_world(jax.random.PRNGKey(seed))
        mask = jnp.ones(len(pts), bool)
        grid = ndt_map.build_from_scan(
            MAP, jnp.zeros(2), jnp.zeros(2), pts, mask
        )
        tgt = d2d.make_dense_target(grid, MAP)

        def mc_ratio(sig, n=64):
            @jax.jit
            def register(key):
                noisy = pts + sig * jax.random.normal(key, pts.shape)
                g = ndt_map.build_from_scan(
                    MAP, jnp.zeros(2), jnp.zeros(2), noisy, mask
                )
                src = ndt_map.to_cell_list(g, MAP)
                res = d2d.match_d2d.__wrapped__(
                    tgt, src, jnp.zeros(3), MAP, MATCH
                )
                return res.T, res.converged

            keys = jax.random.split(jax.random.PRNGKey(seed + 100), n)
            Ts, conv = jax.vmap(register)(keys)
            Ts = np.asarray(Ts)[np.asarray(conv)]
            mc = np.cov(Ts.T)
            src0 = ndt_map.to_cell_list(grid, MAP)
            h = np.asarray(
                d2d.covariance_d2d(tgt, src0, jnp.zeros(3), MAP, MATCH)
            )
            return np.diag(mc) / np.diag(h)

        r = mc_ratio(sigma)
        ratio_mid.append(r)
        assert (r > 1 / 3.0).all() and (r < 3.0).all(), (seed, r)
        if ratio_low is None:
            ratio_low = mc_ratio(0.01)
    # sigma^2 dependence: cleaner sensor -> materially smaller spread
    # for the same Hessian (the documented limitation).
    assert np.median(ratio_low) < 0.5 * np.median(
        np.concatenate(ratio_mid)
    ), (ratio_low, ratio_mid)


def test_spd_info_repairs_indefinite_covariance():
    """spd_info_np must return PSD information even for the indefinite
    covariances f32 eig-reconstruction can produce (measured on the
    570-node study: cov min-eig -4.4e-4 -> info eigs to -3.6e6)."""
    v = np.array([0.6, -0.8, 0.0])
    cov = np.diag([1e4, 1e-7, 1e-5]) - 4e-4 * np.outer(v, v)
    w0 = np.linalg.eigvalsh(cov)
    assert w0.min() < 0  # genuinely indefinite input
    info = opt_mod.spd_info_np(cov)
    w = np.linalg.eigvalsh(0.5 * (info + info.T))
    assert (w > 0).all()
    assert w.max() <= 1.01e6
