"""Batched RANSAC feature-set matcher.

Batched re-design of flirtlib's RansacFeatureSetMatcher (three
reference parameterizations — fuser 0.0599/0.9/0.1/0.6/0.0499 at
ndt_feature_fuser_hmt.h:213, flirtlib_ros 0.0599/0.95/0.4/0.4/0.0384 at
flirtlib.cpp:73, startup 0.98 at startup_loc.cpp:181; all expressible
via FeatureParams.replace).

Sequential adaptive RANSAC becomes a *fixed-budget parallel hypothesis
fan-out* (SURVEY.md §7.5): descriptor chi2 matrix → top-C candidate
correspondences → M vmapped 2-point SE(2) hypotheses → MSAC scoring
(sum of min(r^2, acceptance) — identical to flirtlib's inlier-residual
+ outlier-penalty objective) → closed-form Procrustes refinement on the
winner's inliers.  One jit, no data-dependent shapes.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ndt_feature_graph_tpu.config import FeatureParams
from ndt_feature_graph_tpu.features.detector import FeatureSet
from ndt_feature_graph_tpu.features.distance import symmetric_chi2_matrix


class MatchResult(NamedTuple):
    T: jnp.ndarray            # (3,) mov -> ref SE(2) transform
    score: jnp.ndarray        # MSAC score (lower better)
    num_inliers: jnp.ndarray  # int32
    corr_ref: jnp.ndarray     # (C,) candidate ref indices
    corr_mov: jnp.ndarray     # (C,) candidate mov indices
    corr_mask: jnp.ndarray    # (C,) candidate validity
    inlier_mask: jnp.ndarray  # (C,) inliers under final T
    valid: jnp.ndarray        # bool — enough inliers for a pose


def _procrustes(a, b, w):
    """Weighted 2D rigid fit: argmin_T sum w |a - T(b)|^2.
    a, b: (C, 2); w: (C,).  Returns (3,) pose."""
    wsum = jnp.maximum(jnp.sum(w), 1e-9)
    ca = jnp.sum(a * w[:, None], 0) / wsum
    cb = jnp.sum(b * w[:, None], 0) / wsum
    a0 = a - ca
    b0 = b - cb
    sxx = jnp.sum(w * (b0[:, 0] * a0[:, 0] + b0[:, 1] * a0[:, 1]))
    sxy = jnp.sum(w * (b0[:, 0] * a0[:, 1] - b0[:, 1] * a0[:, 0]))
    theta = jnp.arctan2(sxy, sxx)
    c, s = jnp.cos(theta), jnp.sin(theta)
    tx = ca[0] - (c * cb[0] - s * cb[1])
    ty = ca[1] - (s * cb[0] + c * cb[1])
    return jnp.stack([tx, ty, theta])


def _apply(T, pts):
    c, s = jnp.cos(T[..., 2]), jnp.sin(T[..., 2])
    x = c * pts[..., 0] - s * pts[..., 1] + T[..., 0]
    y = s * pts[..., 0] + c * pts[..., 1] + T[..., 1]
    return jnp.stack([x, y], -1)


@functools.partial(jax.jit, static_argnames=("params",))
def match_sets(
    params: FeatureParams,
    ref: FeatureSet,
    ref_desc,
    mov: FeatureSet,
    mov_desc,
    key,
) -> MatchResult:
    """RansacFeatureSetMatcher::matchSets equivalent: estimate the SE(2)
    transform carrying `mov` features onto `ref` features."""
    c_cap = params.max_correspondences
    m_hyp = params.ransac_hypotheses
    acc = params.ransac_acceptance

    # 1. Descriptor distances, invalid -> +inf.
    dist = symmetric_chi2_matrix(ref_desc, mov_desc)
    bad = ~(ref.mask[:, None] & mov.mask[None, :])
    dist = jnp.where(bad, jnp.inf, dist)

    # 2. Candidate correspondences, flirtlib-style: ONE candidate per
    # moving point — its best-matching reference point below the
    # descriptor gate (RansacFeatureSetMatcher builds
    # possibleCorrespondences as per-data-point best matches).  Taking
    # top-K over the full matrix instead admits duplicate matches of
    # the same moving point, which double-count in MSAC and bias the
    # Procrustes refinement.  Padded to C = max_correspondences by
    # keeping the C best moving points.
    best_ref = jnp.argmin(dist, axis=0)               # (Fmov,)
    best_d = jnp.min(dist, axis=0)                    # (Fmov,)
    neg_topk, mov_sel = jax.lax.top_k(-best_d, min(c_cap, best_d.shape[0]))
    if mov_sel.shape[0] < c_cap:
        padn = c_cap - mov_sel.shape[0]
        mov_sel = jnp.concatenate([mov_sel, jnp.zeros(padn, mov_sel.dtype)])
        neg_topk = jnp.concatenate(
            [neg_topk, jnp.full((padn,), -jnp.inf, neg_topk.dtype)]
        )
    cd = -neg_topk
    corr_mov = mov_sel
    corr_ref = best_ref[mov_sel]
    corr_mask = cd < params.ransac_dist_threshold

    a = ref.pts[corr_ref]      # (C, 2) target positions
    b = mov.pts[corr_mov]      # (C, 2) source positions

    # 3. M two-point hypotheses, drawn among VALID candidates only
    # (flirtlib samples from the actual correspondence list).  The
    # candidates are distance-sorted, so the corr_mask prefix of
    # length n_valid is exactly the valid set — sample uniform
    # indices below it.
    n_valid = jnp.sum(corr_mask).astype(jnp.float32)
    ki, _ = jax.random.split(key)
    u = jax.random.uniform(ki, (m_hyp, 2))
    pair_idx = jnp.floor(u * jnp.maximum(n_valid, 1.0)).astype(jnp.int32)
    pair_idx = jnp.clip(pair_idx, 0, c_cap - 1)
    i0, i1 = pair_idx[:, 0], pair_idx[:, 1]
    a0, a1 = a[i0], a[i1]
    b0, b1 = b[i0], b[i1]
    da = a1 - a0
    db = b1 - b0
    seg_len = jnp.linalg.norm(db, axis=-1)
    theta = jnp.arctan2(da[:, 1], da[:, 0]) - jnp.arctan2(
        db[:, 1], db[:, 0]
    )
    ch, sh = jnp.cos(theta), jnp.sin(theta)
    tx = a0[:, 0] - (ch * b0[:, 0] - sh * b0[:, 1])
    ty = a0[:, 1] - (sh * b0[:, 0] + ch * b0[:, 1])
    hyp_T = jnp.stack([tx, ty, theta], -1)           # (M, 3)
    # Rigidity gate: the two segments must have similar length
    # (flirtlib's rigidity sigma^2 check) and be non-degenerate.
    len_diff2 = (seg_len - jnp.linalg.norm(da, axis=-1)) ** 2
    hyp_ok = (
        (seg_len > 0.2)
        & (len_diff2 < params.ransac_rigidity * 4.0)
        & corr_mask[i0]
        & corr_mask[i1]
        & (i0 != i1)
    )

    # 4. MSAC scoring over all candidates for every hypothesis.
    proj = _apply(hyp_T[:, None, :].reshape(m_hyp, 1, 3), b[None])  # (M, C, 2)
    r2_raw = jnp.sum((a[None] - proj) ** 2, -1)       # (M, C)
    r2 = jnp.where(corr_mask[None, :], r2_raw, acc)   # outliers: fixed cost
    msac = jnp.sum(jnp.minimum(r2, acc), axis=1)
    msac = jnp.where(hyp_ok, msac, jnp.inf)

    # 4b. Hypothesis budget from the RANSAC stopping bound
    # N(w) = log(1-p) / log(1-w^2) — this is how flirtlib's
    # RansacFeatureSetMatcher turns (success probability, inlier ratio)
    # into its iteration count, so the three reference
    # parameterizations (p=0.9/0.95/0.98, w=0.1/0.4) genuinely differ
    # in matching effort here too.  Static: params is a static arg.
    p_succ = min(max(params.ransac_success_prob, 1e-6), 1.0 - 1e-9)
    w0 = min(max(params.ransac_inlier_ratio, 1e-6), 1.0 - 1e-9)
    n_budget = int(
        math.ceil(math.log1p(-p_succ) / math.log1p(-w0 * w0))
    )
    considered = jnp.arange(m_hyp) < min(max(n_budget, 1), m_hyp)
    if params.ransac_adaptive:
        # Adaptive variant (the flag the reference leaves false):
        # hypothesis i is still drawn only while i < N(best inlier
        # ratio seen before i) — emulated exactly on fixed shapes via
        # a running max, since N(w) is non-increasing in w.
        n_cand = jnp.maximum(jnp.sum(corr_mask), 1).astype(jnp.float32)
        inl_cnt = jnp.sum((r2_raw < acc) & corr_mask[None, :], axis=1)
        ratio = jnp.where(hyp_ok, inl_cnt / n_cand, 0.0)
        run = jax.lax.cummax(jnp.maximum(ratio, w0))
        run_prev = jnp.concatenate([jnp.full((1,), w0), run[:-1]])
        w2 = jnp.clip(run_prev * run_prev, 1e-9, 1.0 - 1e-6)
        bound = math.log1p(-p_succ) / jnp.log1p(-w2)
        considered &= jnp.arange(m_hyp) < jnp.ceil(bound)
    msac = jnp.where(considered, msac, jnp.inf)

    best = jnp.argmin(msac)
    T0 = hyp_T[best]
    any_hyp = jnp.isfinite(msac[best])

    # 5. Procrustes refinement on the winner's inliers (2 passes).
    def refine(T, _):
        r2 = jnp.sum((a - _apply(T, b)) ** 2, -1)
        w = ((r2 < acc) & corr_mask).astype(jnp.float32)
        enough = jnp.sum(w) >= 2
        T_new = jnp.where(enough, _procrustes(a, b, w), T)
        return T_new, None

    T_fit, _ = jax.lax.scan(refine, T0, None, length=2)
    T_fit = jnp.where(any_hyp, T_fit, jnp.zeros(3))

    r2 = jnp.sum((a - _apply(T_fit, b)) ** 2, -1)
    inlier = (r2 < acc) & corr_mask & any_hyp
    n_in = jnp.sum(inlier).astype(jnp.int32)
    score = jnp.sum(
        jnp.where(corr_mask, jnp.minimum(r2, acc), acc)
    )
    return MatchResult(
        T=T_fit,
        score=score,
        num_inliers=n_in,
        corr_ref=corr_ref,
        corr_mov=corr_mov,
        corr_mask=corr_mask,
        inlier_mask=inlier,
        valid=any_hyp & (n_in >= 2),
    )


def to_paired_cells(result: MatchResult, ref: FeatureSet, mov: FeatureSet,
                    cov_xy: float = 2e-4):
    """Turn RANSAC correspondences into paired fixed-covariance pseudo-
    cell lists for the fusion matcher (replacing
    convertCorrespondencesToCellvectorsFixedCovWithCorr,
    conversions.h:12-84; fixed covariance diag(2e-4, 2e-4) from
    fuser_hmt.cpp:249)."""
    from ndt_feature_graph_tpu.ops.ndt_map import CellList

    c = result.corr_ref.shape[0]
    eye = jnp.eye(2, dtype=jnp.float32) * cov_xy
    covs = jnp.tile(eye[None], (c, 1, 1))
    tgt = CellList(
        means=ref.pts[result.corr_ref], covs=covs, mask=result.inlier_mask
    )
    src = CellList(
        means=mov.pts[result.corr_mov], covs=covs, mask=result.inlier_mask
    )
    return src, tgt
