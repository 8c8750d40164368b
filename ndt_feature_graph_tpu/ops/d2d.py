"""NDT distribution-to-distribution (D2D) registration.

Batched replacement of NDTMatcherD2D / NDTMatcherD2D_2D /
NDTMatcherFeatureD2D and the first-party fusion Newton loop
(ndt_matcher_d2d_fusion.h:797-1155).  See SURVEY.md §2.3 / §7.3.

Design choices vs the reference:
  * SE(2)-native 3-DoF state `d` = (dx, dy, dtheta), a *global-frame
    left increment* on the initial transform — exactly the role of
    `pose_local_v` in the reference loop (fusion.h:1040-1045).
  * Score / gradient / Hessian come from JAX autodiff (forward-over-
    reverse) of the Gaussian-overlap cost, replacing the hand-derived
    `derivativesNDT` (Magnusson 2009).  Exact to machine precision —
    verified against finite differences in tests/test_d2d.py.
  * The Newton iteration with eigenvalue regularization, LDLT solve,
    line search, and best-score fallback (fusion.h:922-1079) is a single
    `lax.while_loop` — one XLA computation, no host round-trips.
  * More-Thuente line search + eigenvalue shift (fusion.h:390-793,
    922-940 — branch-heavy and host-sequential) are replaced by
    Levenberg-Marquardt adaptive damping with Armijo acceptance: same
    bounded-step safeguard, one fixed-shape loop; convergence validated
    on the reference's perturbation sweeps (tests/test_d2d.py).

Cell association: the target is a *dense grid*, so the neighbour search
of LazyGrid (n_neighbours shells, NDTMatcherD2D::derivativesNDT) becomes
a static (2n+1)^2 window gather around each transformed source mean.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ndt_feature_graph_tpu.config import MatcherParams, NDTMapParams
from ndt_feature_graph_tpu.core import se2
from ndt_feature_graph_tpu.ops import ndt_map
from ndt_feature_graph_tpu.ops.ndt_map import CellList


class DenseTarget(NamedTuple):
    """Finalized target map fields for window gathers.

    `packed` carries all per-cell fields channel-packed in ONE flat
    (H*W, 8) array so a registration evaluation performs a SINGLE
    gather of its (N, K) window rows instead of three separate gathers
    (means/covs/valid) of the same rows.  Channels:
    [mean_x, mean_y, c00, c01, c11, valid, 0, 0] (8 for alignment)."""

    origin: jnp.ndarray   # (2,)
    means: jnp.ndarray    # (H, W, 2)
    covs: jnp.ndarray     # (H, W, 2, 2)
    valid: jnp.ndarray    # (H, W)
    packed: jnp.ndarray   # (H * W, 8)


class PackedTarget(NamedTuple):
    """Slim registration target: origin + the (H*W, 8) channel-packed
    table ONLY — what the production graph paths actually read (flat
    gathers + origin).  Node banks store this instead of a full
    DenseTarget: the unpacked means/covs/valid duplicated the packed
    channels and made bank-sized (N, H, W, 2, 2) intermediates.
    means/covs/valid views are derivable by slicing (unpack_fields /
    dense_from_packed)."""

    origin: jnp.ndarray   # (2,)
    packed: jnp.ndarray   # (H * W, 8)


def unpack_fields(packed, h: int, w: int):
    """Inverse of _pack_fields: (means (H,W,2), covs (H,W,2,2),
    valid (H,W)) views sliced out of the packed channels."""
    g = packed.reshape(h, w, 8)
    means = g[..., 0:2]
    c00, c01, c11 = g[..., 2], g[..., 3], g[..., 4]
    covs = jnp.stack(
        [
            jnp.stack([c00, c01], -1),
            jnp.stack([c01, c11], -1),
        ],
        -2,
    )
    valid = g[..., 5] > 0.5
    return means, covs, valid


def dense_from_packed(pt: "PackedTarget", h: int, w: int) -> "DenseTarget":
    """Full DenseTarget view of a PackedTarget (tests/examples that
    drive fgh_dense directly)."""
    means, covs, valid = unpack_fields(pt.packed, h, w)
    return DenseTarget(pt.origin, means, covs, valid, pt.packed)


def _pack_fields(means, covs, valid):
    h, w = valid.shape
    ch = jnp.stack(
        [
            means[..., 0], means[..., 1],
            covs[..., 0, 0], covs[..., 0, 1], covs[..., 1, 1],
            valid.astype(jnp.float32),
            jnp.zeros((h, w), jnp.float32),
            jnp.zeros((h, w), jnp.float32),
        ],
        -1,
    )
    return ch.reshape(h * w, 8)


def make_dense_target(grid: ndt_map.NDTGrid, params: NDTMapParams) -> DenseTarget:
    means, covs, valid = ndt_map.finalize(grid, params)
    return DenseTarget(
        grid.origin, means, covs, valid,
        _pack_fields(means, covs, valid),
    )


def pack_rows(mean, cov, valid):
    """Channel-pack per-cell fields with ANY leading shape into packed
    rows (..., 8) — the row form of `_pack_fields` (same channel
    order)."""
    z = jnp.zeros(valid.shape, jnp.float32)
    return jnp.stack(
        [
            mean[..., 0], mean[..., 1],
            cov[..., 0, 0], cov[..., 0, 1], cov[..., 1, 1],
            valid.astype(jnp.float32), z, z,
        ],
        -1,
    )


def empty_pack_row(dtype=jnp.float32):
    """The packed row of a never-observed cell — exactly what
    finalize_stats produces for zero statistics (mean 0, conditioned
    cov replaced by eye*1e-3, valid False)."""
    return jnp.asarray([0.0, 0.0, 1e-3, 0.0, 1e-3, 0.0, 0.0, 0.0], dtype)


def packed_from_grid(grid: ndt_map.NDTGrid, params: NDTMapParams):
    """Full (H*W, 8) packed table from a grid (initialization /
    verification; the per-scan path refreshes rows incrementally)."""
    return _pack_fields(*ndt_map.finalize(grid, params))


def refresh_packed(packed, grid: ndt_map.NDTGrid, params: NDTMapParams,
                   flat_idx):
    """Incrementally refresh the packed registration target after a
    scan's points were scattered into `grid`.

    `flat_idx` (P,) are the touched flat cell indices from
    ndt_map.add_points_touched (sentinel h*w = dropped point).  Only
    those cells' sufficient statistics changed, so only their packed
    rows are re-finalized (gather P rows -> finalize_stats -> scatter
    back) instead of the full-grid make_dense_target re-finalize;
    refreshing <=P rows is ~50x less work.  Duplicate indices write
    identical rows — scatter-set is deterministic here.

    Invariant: packed == packed_from_grid(grid, params) to f32 ulp
    tolerance after every update (tests/test_fuser.py::
    test_incremental_packed_matches_full_refinalize)."""
    h, w = params.grid_h, params.grid_w
    fi = jnp.minimum(flat_idx, h * w - 1)          # clamp sentinel reads
    n = grid.count.reshape(-1)[fi]
    ps = grid.psum.reshape(-1, 2)[fi]
    op = grid.outer.reshape(-1, 2, 2)[fi]
    mean, cov, valid = ndt_map.finalize_stats(n, ps, op, params)
    rows = pack_rows(mean, cov, valid)
    return packed.at[flat_idx].set(rows, mode="drop")


def gather_windows_flat(
    packed_flat, h: int, w: int, iy0, ix0, n: int, row_offset=0
):
    """Window gather against a FLAT packed table — the (H*W, 8) table
    of one target, or a stacked node bank reshaped to (N*H*W, 8) with
    `row_offset = node_idx * H * W` selecting the node.

    The bank form is what makes batched pair registration cheap: under
    vmap, `bank.packed[node_idx]` is itself a gather that materializes
    a (B, H*W, 8) per-pair copy of every target grid (~330 MB at the
    canonical 256-pair batch) BEFORE the window gather reads ~2% of its
    rows; indexing the shared flat table with an offset skips that copy
    entirely — one gather, straight from the bank.

    Returns (t_means (..., K, 2), t_covs (..., K, 2, 2),
    t_valid (..., K)) with K = (2n+1)^2.
    """
    win = 2 * n + 1
    offs = jnp.arange(-n, n + 1)
    dy = jnp.repeat(offs, win)
    dx = jnp.tile(offs, win)
    iy = iy0[..., None] + dy[None, :]   # (..., K)
    ix = ix0[..., None] + dx[None, :]
    inb = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
    flat = jnp.clip(iy, 0, h - 1) * w + jnp.clip(ix, 0, w - 1)

    Wn = packed_flat[row_offset + flat]   # (..., K, 8) — the gather
    t_means = Wn[..., 0:2]
    c00 = Wn[..., 2]
    c01 = Wn[..., 3]
    c11 = Wn[..., 4]
    t_covs = jnp.stack(
        [
            jnp.stack([c00, c01], -1),
            jnp.stack([c01, c11], -1),
        ],
        -2,
    )
    t_valid = (Wn[..., 5] > 0.5) & inb
    return t_means, t_covs, t_valid


def gather_windows(tgt: DenseTarget, iy0, ix0, n: int):
    """Gather each source cell's (2n+1)^2 target window rows with ONE
    gather from the packed field.

    Returns (t_means (N, K, 2), t_covs (N, K, 2, 2), t_valid (N, K))
    with K = (2n+1)^2 — equivalent to gathering means/covs/valid
    separately with an explicit in-bounds mask, up to ENFORCED
    covariance symmetry: the pack stores one off-diagonal (c01) and
    mirrors it into c10, whereas condition_cov's f32 eigen-
    reconstruction is not exactly symmetric, so results can differ
    from the old three-gather path at float-ulp level (the
    symmetrization is the better behavior — asymmetric covariances
    are what produced the indefinite-information disaster, see
    cov_from_hessian).
    """
    h, w = tgt.valid.shape
    return gather_windows_flat(tgt.packed, h, w, iy0, ix0, n)


def _apply_increment(d, T0):
    """Left global-frame increment: T = Trans(dx,dy) Rot(dtheta) ∘ T0
    (reference TR*T, fusion.h:1036-1040)."""
    inc = jnp.stack([d[0], d[1], d[2]], -1)
    return se2.compose(inc, T0)


def pair_score(mu_d, cov_sum, lfd1, lfd2):
    """Gaussian-overlap score of one cell pair:
      -d1 * exp(-d2/2 * mu^T (Sigma1 + Sigma2)^{-1} mu)
    (Magnusson 2009 D2D cost as used by NDTMatcherD2D).  Batched over
    leading dims; 2x2 inverse in closed form."""
    a = cov_sum[..., 0, 0]
    b = cov_sum[..., 0, 1]
    c = cov_sum[..., 1, 1]
    det = a * c - b * b
    inv_det = 1.0 / jnp.maximum(det, 1e-12)
    x, y = mu_d[..., 0], mu_d[..., 1]
    mahal = (c * x * x - 2.0 * b * x * y + a * y * y) * inv_det
    return -lfd1 * jnp.exp(-0.5 * lfd2 * mahal)


def d2d_score_dense(
    d,
    T0,
    src: CellList,
    tgt: DenseTarget,
    map_params: NDTMapParams,
    m: MatcherParams,
):
    """Total D2D score of the source cell list against the dense target
    under pose `_apply_increment(d, T0)`.  Differentiable in `d`."""
    T = _apply_increment(d, T0)
    moved = src.transform(T)
    n = m.n_neighbours

    rel = (moved.means - tgt.origin) / map_params.resolution
    ix0 = jnp.floor(rel[..., 0]).astype(jnp.int32)
    iy0 = jnp.floor(rel[..., 1]).astype(jnp.int32)
    t_means, t_covs, t_valid = gather_windows(tgt, iy0, ix0, n)

    mu_d = moved.means[:, None, :] - t_means
    cov_sum = moved.covs[:, None, :, :] + t_covs
    s = pair_score(mu_d, cov_sum, m.lfd1, m.lfd2)
    ok = t_valid & moved.mask[:, None]
    return jnp.sum(jnp.where(ok, s, 0.0))


def d2d_score_dense_flat(
    d, T0, src: CellList, packed_flat, origin, row_offset,
    h: int, w: int, resolution: float, m: MatcherParams,
):
    """d2d_score_dense against a target selected by `row_offset` out of
    a FLAT packed table ((H*W, 8), or a stacked bank reshaped to
    (N*H*W, 8)) — score-only counterpart of
    d2d_analytic.fgh_dense_flat.  Differentiable in `d`."""
    T = _apply_increment(d, T0)
    moved = src.transform(T)
    n = m.n_neighbours

    rel = (moved.means - origin) / resolution
    ix0 = jnp.floor(rel[..., 0]).astype(jnp.int32)
    iy0 = jnp.floor(rel[..., 1]).astype(jnp.int32)
    t_means, t_covs, t_valid = gather_windows_flat(
        packed_flat, h, w, iy0, ix0, n, row_offset
    )
    mu_d = moved.means[:, None, :] - t_means
    cov_sum = moved.covs[:, None, :, :] + t_covs
    s = pair_score(mu_d, cov_sum, m.lfd1, m.lfd2)
    ok = t_valid & moved.mask[:, None]
    return jnp.sum(jnp.where(ok, s, 0.0))


def d2d_score_paired(
    d, T0, src: CellList, tgt: CellList, m: MatcherParams
):
    """Correspondence-restricted D2D (NDTMatcherFeatureD2D semantics):
    src[i] scores only against tgt[i]."""
    T = _apply_increment(d, T0)
    moved = src.transform(T)
    mu_d = moved.means - tgt.means
    cov_sum = moved.covs + tgt.covs
    s = pair_score(mu_d, cov_sum, m.lfd1, m.lfd2)
    ok = src.mask & tgt.mask
    return jnp.sum(jnp.where(ok, s, 0.0))


def mahalanobis_score(d, Q):
    """Soft odometry constraint d^T Q d on the accumulated increment
    (computeScoreMahalanobis, fusion.h:25-28; no 1/2 factor — gradient is
    (Q+Q^T) d as in computeGradientMahalanobis)."""
    return d @ Q @ d


class NewtonResult(NamedTuple):
    d: jnp.ndarray           # (3,) final increment
    T: jnp.ndarray           # (3,) final pose (increment ∘ T0)
    score: jnp.ndarray       # final (best) score
    iterations: jnp.ndarray  # int
    converged: jnp.ndarray   # bool — gradient vanished within budget


def _min_eig_sym3(H):
    """Smallest eigenvalue of a symmetric 3x3 matrix, closed form
    (trigonometric method) — avoids jnp.linalg.eigh in the hot loop."""
    q = jnp.trace(H) / 3.0
    B = H - q * jnp.eye(3, dtype=H.dtype)
    p2 = jnp.sum(B * B) / 6.0
    p = jnp.sqrt(jnp.maximum(p2, 1e-30))
    detB = jnp.linalg.det(B)
    r = jnp.clip(detB / (2.0 * p * p * p), -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0
    # Eigenvalues are q + 2p*cos(phi + 2k*pi/3); the smallest uses
    # k = 1 shifted by 2pi/3 twice.
    lam_min = q + 2.0 * p * jnp.cos(phi + 2.0 * jnp.pi / 3.0)
    return jnp.where(p2 < 1e-28, q, lam_min)


def _psd_project(H):
    """Shift the Hessian to be PSD (trust-region analogue of the
    reference's eigenvalue regularization, fusion.h:922-940; the LM
    damping supplies the rest of the positive shift adaptively).
    Diagonal shift by the negative part of the smallest eigenvalue —
    closed form, no factorization."""
    lam_min = _min_eig_sym3(H)
    shift = jnp.maximum(-lam_min, 0.0)
    return H + shift * jnp.eye(3, dtype=H.dtype)


def newton_match(
    score_fn, d_init, m: MatcherParams, fgh_fn=None
) -> tuple:
    """Generic jitted damped-Newton (Levenberg-Marquardt) minimizer over
    the 3-DoF increment.

    Serves the role of the matchFusion iteration (fusion.h:856-1079):
    derivatives -> PSD regularization -> damped solve -> monotone
    acceptance, with best-score tracking and the same convergence tests
    (gradient norm <= DELTA_SCORE, iteration cap).  The reference's
    More-Thuente line search (branch-heavy, host-sequential) is replaced
    by adaptive damping with Armijo acceptance — the same bounded-step
    safeguard in one fixed-shape loop.

    Cost shape: the trial loop pays EXACTLY ONE fgh evaluation per
    trial: the trial point's derivatives double as the next
    iteration's linearization (fgh-reuse), instead of a separate
    score probe followed by a fresh fgh.  Convergence quality is validated on the reference's perturbation
    sweeps in tests/test_d2d.py.

    Returns (d, score_best, trials, converged).
    """
    if fgh_fn is None:
        grad_fn = jax.grad(score_fn)
        hess_fn = jax.jacfwd(jax.grad(score_fn))

        def fgh_fn(dd):
            return score_fn(dd), grad_fn(dd), hess_fn(dd)

    max_trials = 2 * m.itr_max
    lam_min = jnp.float32(1e-6)
    lam_max = jnp.float32(1e7)
    eye = jnp.eye(3, dtype=jnp.float32)

    # Fixed-trip scan with masked updates instead of lax.while_loop:
    # a while loop pays a condition check (on the GPU, a predicate
    # copy to the host) per iteration, far more than the 3-DoF math,
    # whereas a static unrolled scan pipelines.  The budget is spent in CHUNKS of
    # `trial_chunk` trials; between chunks a lax.cond skips the entire
    # remaining work once `stop` is set — so a run converging in ~8
    # trials pays for ~12, not the full 60.  Under vmap the cond
    # degrades to the masked behaviour (both branches execute) — no
    # regression.
    def body(state, _):
        d, f, g, H, lam, best_d, best_f, itr, stop = state
        Hp = _psd_project(H)
        gnorm = jnp.linalg.norm(g)
        grad_vanished = gnorm <= m.delta_score

        delta = -jnp.linalg.solve(Hp + lam * eye, g)
        # ONE evaluation per trial: score AND derivatives at the trial
        # point (the derivatives are reused as the next linearization
        # on acceptance — no separate probe eval).
        f_new, g_new, H_new = fgh_fn(d + delta)
        # Sufficient decrease (Armijo against the model's directional
        # derivative).
        accept = (f_new <= f + 1e-4 * jnp.dot(delta, g)) & ~stop

        d_next = jnp.where(accept, d + delta, d)
        f_next = jnp.where(accept, f_new, f)
        g_next = jnp.where(accept, g_new, g)
        H_next = jnp.where(accept, H_new, H)
        if m.step_control:
            lam_new = jnp.where(
                accept, jnp.maximum(lam * 0.33, lam_min), lam * 6.0
            )
            lam_new = jnp.where(stop, lam, lam_new)
        else:
            lam_new = lam_min

        better = f_next < best_f
        best_f2 = jnp.where(better, f_next, best_f)
        best_d2 = jnp.where(better, d_next, best_d)

        # Convergence: gradient vanished, damping exhausted, or an
        # accepted step no longer improves the score by DELTA_SCORE
        # (the reference's score-delta test, fusion.h:1070-1079).
        score_converged = accept & (f - f_new <= m.delta_score)
        stop_new = stop | grad_vanished | (lam_new > lam_max) | (
            score_converged
        )
        itr_new = jnp.where(stop, itr, itr + 1)
        return (
            d_next, f_next, g_next, H_next, lam_new,
            best_d2, best_f2, itr_new, stop_new,
        ), None

    d0 = jnp.asarray(d_init, jnp.float32)
    f0, g0, H0 = fgh_fn(d0)
    init = (
        d0,
        f0,
        g0,
        H0,
        jnp.float32(1e-3),
        d0,
        f0,
        jnp.int32(0),
        jnp.bool_(False),
    )

    trial_chunk = 6
    n_chunks = -(-max_trials // trial_chunk)

    def chunk(state, _):
        def run(st):
            out, _ = jax.lax.scan(body, st, None, length=trial_chunk)
            return out

        state = jax.lax.cond(state[-1], lambda st: st, run, state)
        return state, None

    (d, f, g, H, lam, best_d, best_f, itr, stop), _ = jax.lax.scan(
        chunk, init, None, length=n_chunks
    )

    # Best fallback (fusion.h:945-952 "crap iterations" path).
    use_best = f > best_f
    d_out = jnp.where(use_best, best_d, d)
    f_out = jnp.where(use_best, best_f, f)
    return d_out, f_out, itr, stop


@functools.partial(jax.jit, static_argnames=("map_params", "m"))
def match_d2d(
    tgt: DenseTarget,
    src: CellList,
    T_init,
    map_params: NDTMapParams,
    m: MatcherParams,
) -> NewtonResult:
    """Plain D2D registration (NDTMatcherD2D::match equivalent, used for
    link refinement at ndt_feature_graph.cpp:273)."""

    from ndt_feature_graph_tpu.ops import d2d_analytic

    def score_fn(d):
        return d2d_score_dense(d, T_init, src, tgt, map_params, m)

    def fgh_fn(d):
        return d2d_analytic.fgh_dense(d, T_init, src, tgt, map_params, m)

    d, f, itr, conv = newton_match(score_fn, jnp.zeros(3), m, fgh_fn)
    return NewtonResult(
        d=d,
        T=_apply_increment(d, T_init),
        score=f,
        iterations=itr,
        converged=conv,
    )


def cov_from_hessian(H, m: MatcherParams):
    """THE pose-covariance convention: cov = cov_scale * H^-1 with the
    Hessian eigenvalues floored at 1e-6 (NDTMatcherD2D::covariance
    semantics).  Every consumer of a registration covariance — link
    refinement (graph/links.py), fuser covariance accumulation — must
    use this one function so the solver's information weighting is
    consistent.  The reconstruction is
    explicitly symmetrized: in f32, V diag(1/w) V^T with a wide
    eigenvalue spread loses symmetry at the ~1e-3 absolute level,
    enough to make the smallest covariance eigenvalue negative and the
    downstream information matrix indefinite (measured: info eigs to
    -3.6e6 on the 570-node study — negative chi2, corrupted GN)."""
    evals, evecs = jnp.linalg.eigh(H)
    evals = jnp.maximum(evals, 1e-6)
    cov = (evecs / evals[None, :]) @ evecs.T
    cov = 0.5 * (cov + cov.T)
    return m.cov_scale * cov


@functools.partial(jax.jit, static_argnames=("map_params", "m"))
def covariance_d2d(
    tgt: DenseTarget,
    src: CellList,
    T,
    map_params: NDTMapParams,
    m: MatcherParams,
):
    """Pose covariance from the inverse Hessian of the D2D cost at the
    estimate (NDTMatcherD2D::covariance semantics, used for link
    covariances at ndt_feature_graph.cpp:298-330).  Returns (3, 3)."""

    from ndt_feature_graph_tpu.ops import d2d_analytic

    _, _, H = d2d_analytic.fgh_dense(
        jnp.zeros(3), T, src, tgt, map_params, m
    )
    return cov_from_hessian(H, m)


def newton_match_batch(d_init_b, m: MatcherParams, fgh_fn_batch):
    """Batched `newton_match`: B independent 3-DoF LM minimizations
    advancing in lockstep with per-lane masks.

    `fgh_fn_batch((B, 3)) -> (f (B,), g (B, 3), H (B, 3, 3))` evaluates
    ALL lanes in one call — the point of this variant: the caller can
    issue the window gather with flattened 1-D indices
    (d2d_analytic.fgh_dense_flat_batch) instead of a vmapped
    batched-index gather, which can lower to a per-lane broadcast of
    the shared bank.

    Identical trial logic to newton_match (fgh-reuse trials, PSD
    projection, LM damping, Armijo acceptance, best-score fallback,
    chunked early exit — the chunk skips only when EVERY lane has
    stopped, matching vmap(newton_match)'s masked behaviour).

    Returns (d (B, 3), score (B,), trials (B,), converged (B,)).
    """
    b = d_init_b.shape[0]
    max_trials = 2 * m.itr_max
    lam_min = jnp.float32(1e-6)
    lam_max = jnp.float32(1e7)
    eye = jnp.eye(3, dtype=jnp.float32)

    psd_project = jax.vmap(_psd_project)

    def body(state, _):
        d, f, g, H, lam, best_d, best_f, itr, stop = state
        Hp = psd_project(H)
        gnorm = jnp.linalg.norm(g, axis=-1)
        grad_vanished = gnorm <= m.delta_score

        delta = -jnp.linalg.solve(
            Hp + lam[:, None, None] * eye, g[..., None]
        )[..., 0]
        f_new, g_new, H_new = fgh_fn_batch(d + delta)
        accept = (
            f_new <= f + 1e-4 * jnp.einsum("bi,bi->b", delta, g)
        ) & ~stop

        d_next = jnp.where(accept[:, None], d + delta, d)
        f_next = jnp.where(accept, f_new, f)
        g_next = jnp.where(accept[:, None], g_new, g)
        H_next = jnp.where(accept[:, None, None], H_new, H)
        if m.step_control:
            lam_new = jnp.where(
                accept, jnp.maximum(lam * 0.33, lam_min), lam * 6.0
            )
            lam_new = jnp.where(stop, lam, lam_new)
        else:
            lam_new = jnp.full_like(lam, lam_min)

        better = f_next < best_f
        best_f2 = jnp.where(better, f_next, best_f)
        best_d2 = jnp.where(better[:, None], d_next, best_d)

        score_converged = accept & (f - f_new <= m.delta_score)
        stop_new = stop | grad_vanished | (lam_new > lam_max) | (
            score_converged
        )
        itr_new = jnp.where(stop, itr, itr + 1)
        return (
            d_next, f_next, g_next, H_next, lam_new,
            best_d2, best_f2, itr_new, stop_new,
        ), None

    d0 = jnp.asarray(d_init_b, jnp.float32)
    f0, g0, H0 = fgh_fn_batch(d0)
    init = (
        d0, f0, g0, H0,
        jnp.full(b, 1e-3, jnp.float32),
        d0, f0,
        jnp.zeros(b, jnp.int32),
        jnp.zeros(b, bool),
    )

    trial_chunk = 6
    n_chunks = -(-max_trials // trial_chunk)

    def chunk(state, _):
        def run(st):
            out, _ = jax.lax.scan(body, st, None, length=trial_chunk)
            return out

        state = jax.lax.cond(
            jnp.all(state[-1]), lambda st: st, run, state
        )
        return state, None

    (d, f, g, H, lam, best_d, best_f, itr, stop), _ = jax.lax.scan(
        chunk, init, None, length=n_chunks
    )

    use_best = f > best_f
    d_out = jnp.where(use_best[:, None], best_d, d)
    f_out = jnp.where(use_best, best_f, f)
    return d_out, f_out, itr, stop


def build_wide_table(packed, h: int, w: int, n: int = 2):
    """(..., H*W, 8) packed table -> (..., H*(W+2n), (2n+1)*8) WIN-ROW
    table over a HORIZONTALLY PADDED column layout: entry (iy, jx) for
    jx in [0, W+2n) is the win-row centred at grid column ix = jx - n,
    carrying the channel blocks of cells (iy, ix-n .. ix+n) with
    out-of-grid cells filled with the empty pack row (valid=0).

    Why the padding: centre columns just OFF the grid (ix in [-n, -1]
    or [W, W+n-1]) still have in-grid window cells; clipping them onto
    column 0 / W-1 would return a SHIFTED window (wrong cells), and
    masking them entirely diverges from the per-cell bounds of the
    flat path at the horizontal map edges.  With the
    padded layout every centre column whose window intersects the grid
    has its own exact win-row, and per-cell validity comes from the
    empty padding — fgh_dense_wide_batch is numerically identical to
    fgh_dense_flat_batch everywhere, including the edge bands.

    Why the win-row shape at all: a (2n+1)^2 window around a cell is
    (2n+1) vertically-adjacent win-rows, so gathering from this table
    needs (2n+1) rows per source cell instead of (2n+1)^2 — 5x fewer
    gathered rows at the canonical 5x5 window.  Derived
    per scan step (or per offline batch) from the incrementally-
    maintained 8-channel table; the derivation is pure slicing/concat
    (no gathers).  Row offsets into a stacked bank are multiples of
    H*(W+2n) (see wide_row_stride).
    """
    lead = packed.shape[:-2]
    g = packed.reshape(lead + (h, w, 8))
    empty = empty_pack_row(packed.dtype)
    # Padded grid: columns [-n .. W-1+n], off-grid = empty row.
    padc = jnp.broadcast_to(empty, lead + (h, n, 8))
    gp = jnp.concatenate([padc, g, padc], axis=-2)   # (..., h, w+2n, 8)
    wp = w + 2 * n
    parts = []
    for o in range(-n, n + 1):
        # part_o[jx] = gp[jx + o] (cell at centre+o), out-of-range empty.
        if o < 0:
            sl = gp[..., : wp + o, :]
            pad = jnp.broadcast_to(empty, lead + (h, -o, 8))
            part = jnp.concatenate([pad, sl], axis=-2)
        elif o > 0:
            sl = gp[..., o:, :]
            pad = jnp.broadcast_to(empty, lead + (h, o, 8))
            part = jnp.concatenate([sl, pad], axis=-2)
        else:
            part = gp
        parts.append(part)
    wide = jnp.concatenate(parts, axis=-1)
    return wide.reshape(lead + (h * wp, (2 * n + 1) * 8))


def wide_row_stride(h: int, w: int, n: int) -> int:
    """Rows per grid in a stacked win-row table (build_wide_table)."""
    return h * (w + 2 * n)


def build_window_tables(
    packed_b,        # (B, H*W, 8) per-stream packed tables
    origins,         # (B, 2) grid origins (world)
    centers,         # (B, 2) world points to centre the windows on
    h: int,
    w: int,
    n: int,
    win_cells: int,
    resolution: float,
    bf16: bool = False,
):
    """Per-stream SENSOR-WINDOW win-row tables: slice a
    (win_cells, win_cells) cell window around each stream's predicted
    pose out of its full packed table, then build the win-row gather
    table over the window only.

    Why: a registration gather only ever reads rows within the sensor
    disc of the pose (~2*sensor_range/resolution cells), but the
    full-map table spans the whole grid — at the canonical op point
    40k rows/stream of which a scan touches <15%; the window table
    shrinks rows by (win_cells^2 / (H*W)).  EXACT vs the
    full-grid table when win_cells covers every source cell's
    neighbourhood (config.FuserParams.gather_window_cells bound);
    windows are clamped inside the grid so edge poses keep full
    coverage of the in-grid sensor disc.

    With bf16=True the table is stored in bfloat16 with CELL-RELATIVE
    means (mean minus the cell's world centre, |.| <= resolution/2, so
    quantization is ~resolution/256; see config.gather_table_bf16) —
    halving bytes again.  Consumers add the centres back after the
    gather (d2d_analytic.fgh_dense_window_batch).

    Returns (wide (B, win_cells*(win_cells+2n), (2n+1)*8) in f32 or
    bf16, cell0 (B, 2) int32 = (wx0, wy0) window-corner cell coords).
    """
    b = packed_b.shape[0]
    wc = int(win_cells)
    grids = packed_b.reshape(b, h, w, 8)

    pcell = jnp.floor((centers - origins) / resolution).astype(jnp.int32)
    wx0 = jnp.clip(pcell[:, 0] - wc // 2, 0, w - wc)
    wy0 = jnp.clip(pcell[:, 1] - wc // 2, 0, h - wc)

    def slice_one(g, y0, x0):
        return jax.lax.dynamic_slice(g, (y0, x0, 0), (wc, wc, 8))

    win = jax.vmap(slice_one)(grids, wy0, wx0)       # (B, wc, wc, 8)

    if bf16:
        iy = jnp.arange(wc, dtype=jnp.float32)
        ix = jnp.arange(wc, dtype=jnp.float32)
        cx = (
            origins[:, None, 0]
            + (wx0[:, None].astype(jnp.float32) + ix + 0.5) * resolution
        )                                             # (B, wc)
        cy = (
            origins[:, None, 1]
            + (wy0[:, None].astype(jnp.float32) + iy + 0.5) * resolution
        )
        win = win.at[..., 0].add(-cx[:, None, :])     # mean_x - centre_x
        win = win.at[..., 1].add(-cy[:, :, None])     # mean_y - centre_y
        win = win.astype(jnp.bfloat16)

    wide = build_wide_table(win.reshape(b, wc * wc, 8), wc, wc, n)
    return wide, jnp.stack([wx0, wy0], -1)


def build_window_block_tables(
    packed_b,        # (B, H*W, 8)
    origins,         # (B, 2)
    centers,         # (B, 2)
    h: int,
    w: int,
    n: int,
    win_cells: int,
    resolution: float,
    bf16: bool = False,
):
    """WIN-BLOCK window tables: entry (iy, jx) of a (wc+2n)^2 padded
    window layout carries the channel blocks of ALL (2n+1)^2 cells of
    the window centred at cell (iy-n, jx-n) — so a registration
    evaluation gathers exactly ONE row per source cell instead of
    (2n+1) win-rows or (2n+1)^2 cell rows.

    Why: the per-trial Newton gather then moves one contiguous
    (2n+1)^2*8-channel row (~400 B in bf16) per source cell.  The
    table is (2n+1)^2/(2n+1) = 5x larger than the
    win-row form but windowed + bf16 keeps it ~8 MB/stream at the
    canonical op point.

    Both padded axes give every centre whose window intersects the
    window slice an exact row with per-cell validity from the empty
    padding — numerically identical to the flat/win-row paths
    everywhere (tests/test_d2d_analytic.py::test_block_matches_flat).

    Returns (block (B, (wc+2n)^2 rows, (2n+1)^2*8) in f32 or bf16,
    cell0 (B, 2) int32 window-corner cell coords).
    """
    b = packed_b.shape[0]
    wc = int(win_cells)
    win = 2 * n + 1
    hp = wc + 2 * n
    grids = packed_b.reshape(b, h, w, 8)

    pcell = jnp.floor((centers - origins) / resolution).astype(jnp.int32)
    wx0 = jnp.clip(pcell[:, 0] - wc // 2, 0, w - wc)
    wy0 = jnp.clip(pcell[:, 1] - wc // 2, 0, h - wc)

    def slice_one(g, y0, x0):
        return jax.lax.dynamic_slice(g, (y0, x0, 0), (wc, wc, 8))

    wnd = jax.vmap(slice_one)(grids, wy0, wx0)       # (B, wc, wc, 8)

    if bf16:
        iy = jnp.arange(wc, dtype=jnp.float32)
        ix = jnp.arange(wc, dtype=jnp.float32)
        cx = (
            origins[:, None, 0]
            + (wx0[:, None].astype(jnp.float32) + ix + 0.5) * resolution
        )
        cy = (
            origins[:, None, 1]
            + (wy0[:, None].astype(jnp.float32) + iy + 0.5) * resolution
        )
        wnd = wnd.at[..., 0].add(-cx[:, None, :])
        wnd = wnd.at[..., 1].add(-cy[:, :, None])
        wnd = wnd.astype(jnp.bfloat16)

    empty = empty_pack_row(wnd.dtype)
    # Doubly-padded grid: coords (iyp, jxp) = cell (iyp-n, jxp-n).
    pv = jnp.broadcast_to(empty, (b, n, wc, 8))
    gp = jnp.concatenate([pv, wnd, pv], axis=1)      # (B, hp, wc, 8)
    ph = jnp.broadcast_to(empty, (b, hp, n, 8))
    gp = jnp.concatenate([ph, gp, ph], axis=2)       # (B, hp, hp, 8)

    def shift2(a, dy, dx):
        """a shifted so out[iy, jx] = a[iy+dy, jx+dx], empty fill."""
        out = a
        if dy < 0:
            out = jnp.concatenate(
                [jnp.broadcast_to(empty, (b, -dy) + out.shape[2:]),
                 out[:, : hp + dy]], axis=1)
        elif dy > 0:
            out = jnp.concatenate(
                [out[:, dy:],
                 jnp.broadcast_to(empty, (b, dy) + out.shape[2:])],
                axis=1)
        if dx < 0:
            out = jnp.concatenate(
                [jnp.broadcast_to(
                    empty, out.shape[:2] + (-dx, 8)),
                 out[:, :, : hp + dx]], axis=2)
        elif dx > 0:
            out = jnp.concatenate(
                [out[:, :, dx:],
                 jnp.broadcast_to(empty, out.shape[:2] + (dx, 8))],
                axis=2)
        return out

    parts = [
        shift2(gp, dy, dx)
        for dy in range(-n, n + 1)
        for dx in range(-n, n + 1)
    ]
    block = jnp.concatenate(parts, axis=-1)          # (B, hp, hp, K*8)
    return (
        block.reshape(b, hp * hp, win * win * 8),
        jnp.stack([wx0, wy0], -1),
    )
