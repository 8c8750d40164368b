"""Multi-scale curvature interest-point detector.

Batched re-design of flirtlib's CurvatureDetector +
SimpleMinMaxPeakFinder stack (flirtlib_ros/src/flirtlib.cpp:41-51;
canonical parameters at ndt_feature/include/ndt_feature/
flirtlib_utils.h:15-35: 5 scales, base sigma 0.2, step 1.4, peak finder
0.34/0.001).

The reference computes graph-geodesic Gaussian smoothing over a
distance-MST of the scan polyline — inherently sequential.  Here each
scale smooths the polyline with a Gaussian over the *actual cumulative
arc length* of the scan polyline (not a fixed beam-index width): for
beam i the weight on neighbour j is exp(-((arc_j - arc_i)/sigma)^2/2),
zeroed across occlusion jumps and missing returns.  The curvature
response is the turning angle between the forward and backward points
one sigma of arc away (found by searchsorted on the cumulative arc) —
so a corner at 2 m and the same corner at 15 m produce the same
response at the same sigma.  All fixed-shape (S, B, W) tensor ops,
batchable over scans via vmap.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ndt_feature_graph_tpu.config import FeatureParams


class FeatureSet(NamedTuple):
    """Padded interest points in the SENSOR frame."""

    pts: jnp.ndarray        # (F, 2)
    angles: jnp.ndarray     # (F,) orientation
    scales: jnp.ndarray     # (F,) detection scale (sigma)
    response: jnp.ndarray   # (F,) detector response
    mask: jnp.ndarray       # (F,) bool

    def transform(self, pose):
        from ndt_feature_graph_tpu.core import se2

        pts = se2.transform_points(pose, self.pts)
        angles = self.angles + pose[..., 2]
        return self._replace(pts=pts, angles=angles)


def detect(params: FeatureParams, ranges, hit) -> FeatureSet:
    """Detect up to `max_features` interest points in one scan.

    ranges: (B,), hit: (B,) bool.  Returns a padded FeatureSet.
    """
    b = params.num_beams
    angles = jnp.linspace(-np.pi, np.pi, b, endpoint=False)
    pts = jnp.stack(
        [ranges * jnp.cos(angles), ranges * jnp.sin(angles)], -1
    )

    # Polyline arc length.  seg[i] = |p_i - p_{i-1}|, seg[0] = 0.
    seg = jnp.linalg.norm(pts - jnp.roll(pts, 1, axis=0), axis=-1)
    seg = seg.at[0].set(0.0)
    cumarc = jnp.cumsum(seg)

    # Occlusion/jump gate: big range discontinuities are not geometry
    # (flirtlib handles this by polyline segmentation; here a jump
    # severs smoothing weights and curvature spans).
    jump = (jnp.abs(ranges - jnp.roll(ranges, 1)) > 0.5).at[0].set(False)
    jump = jump | ~hit | ~jnp.roll(hit, 1)
    seg_id = jnp.cumsum(jump.astype(jnp.int32))      # polyline segment id

    # Banded neighbour window for smoothing.
    half = int(params.smooth_half_beams)
    offs = jnp.arange(-half, half + 1)
    nidx = jnp.clip(jnp.arange(b)[:, None] + offs[None, :], 0, b - 1)
    darc = jnp.abs(cumarc[nidx] - cumarc[:, None])         # (B, W)
    same_piece = (seg_id[nidx] == seg_id[:, None]) & hit[nidx]

    responses = []
    tangents = []
    scale_sigmas = []
    for i in range(params.num_scales):
        sigma = params.base_sigma * params.sigma_step**i
        w = jnp.exp(-0.5 * (darc / sigma) ** 2) * same_piece
        wsum = jnp.maximum(jnp.sum(w, -1, keepdims=True), 1e-9)
        sm = jnp.einsum("bw,bwc->bc", w / wsum, pts[nidx])  # (B, 2)

        # Forward/backward points one sigma of arc away.
        fwd = jnp.clip(
            jnp.searchsorted(cumarc, cumarc + sigma), 0, b - 1
        )
        bwd = jnp.clip(
            jnp.searchsorted(cumarc, cumarc - sigma), 0, b - 1
        )
        f = sm[fwd] - sm
        bk = sm - sm[bwd]
        dot = f[:, 0] * bk[:, 0] + f[:, 1] * bk[:, 1]
        cross = bk[:, 0] * f[:, 1] - bk[:, 1] * f[:, 0]
        curv = jnp.abs(jnp.arctan2(cross, dot + 1e-12))

        ok = (
            hit
            & hit[fwd]
            & hit[bwd]
            & (seg_id[fwd] == seg_id)
            & (seg_id[bwd] == seg_id)
            & (fwd > jnp.arange(b))
            & (bwd < jnp.arange(b))
        )
        responses.append(jnp.where(ok, curv, 0.0))
        # Scale-smoothed tangent (for a stable orientation — the raw
        # polyline tangent jitters the descriptor's phi bins).
        tangents.append(sm[fwd] - sm[bwd])
        scale_sigmas.append(sigma)

    resp = jnp.stack(responses)                     # (S, B)
    tang = jnp.stack(tangents)                      # (S, B, 2)

    # Peak finding per scale (SimpleMinMaxPeakFinder semantics: strict
    # local maximum with minimum prominence and absolute threshold).
    left = jnp.roll(resp, 1, axis=-1)
    right = jnp.roll(resp, -1, axis=-1)
    is_peak = (
        (resp > left + params.peak_min_diff)
        & (resp > right + params.peak_min_diff)
        & (resp > params.peak_min_value)
    )
    peak_resp = jnp.where(is_peak, resp, 0.0)

    # Non-maximum suppression across scales: keep the best scale per
    # beam, then global top-K beams.
    best_scale = jnp.argmax(peak_resp, axis=0)       # (B,)
    best_resp = jnp.max(peak_resp, axis=0)           # (B,)

    f = params.max_features
    top_resp, top_idx = jax.lax.top_k(best_resp, f)
    valid = top_resp > 0.0

    sigmas = jnp.asarray(scale_sigmas, jnp.float32)
    sel_scale = sigmas[best_scale[top_idx]]
    sel_pts = pts[top_idx]

    # Orientation: normal of the scale-smoothed tangent (pointing
    # toward the sensor, like flirtlib's normal-based orientation).
    sel_tang = tang[best_scale[top_idx], top_idx]    # (F, 2)
    na = jnp.arctan2(sel_tang[:, 0], -sel_tang[:, 1])
    # Flip normals to face the sensor.
    to_sensor = -sel_pts
    nvec = jnp.stack([jnp.cos(na), jnp.sin(na)], -1)
    flip = jnp.sum(nvec * to_sensor, -1) < 0
    na = jnp.where(flip, na + np.pi, na)

    return FeatureSet(
        pts=sel_pts,
        angles=jnp.arctan2(jnp.sin(na), jnp.cos(na)),
        scales=sel_scale,
        response=top_resp,
        mask=valid,
    )
