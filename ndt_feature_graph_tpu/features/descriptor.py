"""Beta-grid descriptor: polar occupancy histogram with hit/miss counts.

Batched re-design of flirtlib's BetaGridGenerator
(flirtlib_ros/src/flirtlib.cpp:53-63; params rho in [0.02, 1.0], 4
radial x 12 angular bins — flirtlib_utils.h:44-52).  For each interest
point, scan endpoints inside the (scale-proportional) support count as
*hits* in their polar bin; free-space samples along each beam before
its endpoint count as *misses*.  The descriptor is the per-bin Beta
posterior mean (hit+1)/(hit+miss+2).

Everything is one fused (F, B, S) binning computation with scatter-adds
— no per-feature loops.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ndt_feature_graph_tpu.config import FeatureParams
from ndt_feature_graph_tpu.features.detector import FeatureSet


def describe(
    params: FeatureParams, feats: FeatureSet, ranges, hit
) -> jnp.ndarray:
    """Compute (F, rho_bins*phi_bins) descriptors for one scan.

    `feats` must be in the sensor frame of (`ranges`, `hit`).
    """
    f = params.max_features
    b = params.num_beams
    r_bins, p_bins = params.rho_bins, params.phi_bins
    nbins = r_bins * p_bins

    beam_angles = jnp.linspace(-np.pi, np.pi, b, endpoint=False)
    endpoints = jnp.stack(
        [ranges * jnp.cos(beam_angles), ranges * jnp.sin(beam_angles)], -1
    )  # (B, 2)

    # Support radius scales with feature scale (flirtlib scales the grid
    # by the interest point's scale level).
    support = params.max_rho * jnp.maximum(
        feats.scales / params.base_sigma, 1.0
    ) ** 0.5  # (F,)
    support = jnp.clip(support, params.max_rho, 4.0 * params.max_rho)

    def polar_bins(rel_pts, feat_angle, sup):
        """rel_pts (..., 2) relative to feature -> (bin_idx, in_support)."""
        ca, sa = jnp.cos(-feat_angle), jnp.sin(-feat_angle)
        x = rel_pts[..., 0] * ca - rel_pts[..., 1] * sa
        y = rel_pts[..., 0] * sa + rel_pts[..., 1] * ca
        rho = jnp.sqrt(x * x + y * y)
        phi = jnp.arctan2(y, x)
        rlo = params.min_rho
        ri = jnp.floor(
            (rho - rlo) / (sup - rlo) * r_bins
        ).astype(jnp.int32)
        pi_ = jnp.floor((phi + np.pi) / (2 * np.pi) * p_bins).astype(
            jnp.int32
        )
        pi_ = jnp.clip(pi_, 0, p_bins - 1)
        ok = (ri >= 0) & (ri < r_bins)
        return jnp.clip(ri, 0, r_bins - 1) * p_bins + pi_, ok

    # --- Hits: endpoints of hitting beams ---
    rel = endpoints[None, :, :] - feats.pts[:, None, :]        # (F, B, 2)
    hbin, hok = polar_bins(
        rel, feats.angles[:, None], support[:, None]
    )
    hok = hok & hit[None, :] & feats.mask[:, None]

    # --- Misses: free space along each beam *inside the support
    # circle* of each feature (flirtlib ray-traces each beam through
    # the beta grid; sampling the whole beam instead aliases badly —
    # at 4 rho bins over ~1 m support, samples metres apart miss
    # entire bins).  Ray t*d vs circle |t*d - p| = s:
    # t0/1 = d.p -/+ sqrt((d.p)^2 - |p|^2 + s^2), clipped to the free
    # segment [0, range).  K length-weighted samples per chord.
    d_hat = jnp.stack(
        [jnp.cos(beam_angles), jnp.sin(beam_angles)], -1
    )                                                          # (B, 2)
    dp = jnp.einsum("bc,fc->fb", d_hat, feats.pts)             # (F, B)
    p2 = jnp.sum(feats.pts**2, -1)                             # (F,)
    disc = dp * dp - p2[:, None] + support[:, None] ** 2       # (F, B)
    has_chord = disc > 0.0
    root = jnp.sqrt(jnp.maximum(disc, 0.0))
    t0 = jnp.maximum(dp - root, 0.0)
    t1 = jnp.minimum(dp + root, ranges[None, :] * 0.999)
    chord = jnp.maximum(t1 - t0, 0.0)                          # (F, B)
    s_steps = 8
    sfrac = (jnp.arange(s_steps) + 0.5) / s_steps              # (K,)
    t_s = t0[:, :, None] + chord[:, :, None] * sfrac           # (F, B, K)
    sample_pts = t_s[..., None] * d_hat[None, :, None, :]      # (F, B, K, 2)
    mrel = sample_pts - feats.pts[:, None, None, :]
    mbin, mok = polar_bins(
        mrel,
        feats.angles[:, None, None],
        support[:, None, None],
    )
    mok = mok & has_chord[:, :, None] & (chord[:, :, None] > 1e-6) \
        & feats.mask[:, None, None]
    # Weight each sample by the chord length it represents, in units
    # of the radial bin width, so miss mass ~ number of cells the beam
    # traverses (flirtlib's integer cell-traversal counts).
    bin_w = jnp.maximum((support - params.min_rho) / r_bins, 1e-6)  # (F,)
    mw = jnp.where(
        mok, chord[:, :, None] / s_steps / bin_w[:, None, None], 0.0
    )

    # Bin-accumulate as batched one-hot contractions instead of
    # scatter-adds: a (F, B[*K]) x (F, B[*K], nbins) contraction is a
    # batched GEMV over at most F*B*K*nbins = ~9M MACs with a fixed
    # summation order — the scatter-as-matmul trick for small bin
    # counts.  The one-hot operand is exact in any matmul precision.
    bins_iota = jnp.arange(nbins, dtype=jnp.int32)
    h_onehot = (hbin[..., None] == bins_iota).astype(jnp.float32)
    hits = jnp.einsum(
        "fb,fbn->fn", hok.astype(jnp.float32), h_onehot
    )
    m_onehot = (mbin[..., None] == bins_iota).astype(jnp.float32)
    misses = jnp.einsum("fbk,fbkn->fn", mw, m_onehot)
    if params.descriptor_stat == "hitmiss":
        # Separately-normalized hit/miss histograms, concatenated with
        # weight 1/2 each: symmetric chi2 on the concatenation equals
        # the average of the per-histogram chi2 distances, so the
        # reference's [0, 1] gates still transplant.
        hn = hits / jnp.maximum(jnp.sum(hits, -1, keepdims=True), 1e-9)
        mn = misses / jnp.maximum(
            jnp.sum(misses, -1, keepdims=True), 1e-9
        )
        return jnp.concatenate([0.5 * hn, 0.5 * mn], -1)
    # Beta posterior mean per bin.
    return (hits + 1.0) / (hits + misses + 2.0)


def descriptor_dim(params: FeatureParams) -> int:
    """Descriptor row width for the configured statistic."""
    nbins = params.rho_bins * params.phi_bins
    return 2 * nbins if params.descriptor_stat == "hitmiss" else nbins
