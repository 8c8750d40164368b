"""Link computation: loop-closure proposal, occupancy-overlap scoring,
D2D refinement, validation gates.

Replaces NDTFeatureGraph::{computeLink, computeAllPossibleLinks,
updateLinksUsingNDTRegistration, getValidLinks}
(ndt_feature_graph.cpp:162-177, 260-345, 395-405, 527-556) and
overlapNDTOccupancyScore (ndt_feature_node.h:213-252).  The reference's
O(N^2) sequential pair loop becomes one vmapped batch over a padded
pair list — the embarrassingly-parallel workload that later shards over
the device mesh (parallel/links_sharded.py).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ndt_feature_graph_tpu.config import FeatureParams, GraphParams, MatcherParams, NDTMapParams
from ndt_feature_graph_tpu.core import se2
from ndt_feature_graph_tpu.features import ransac
from ndt_feature_graph_tpu.graph.node import NodeData
from ndt_feature_graph_tpu.ops import d2d, d2d_analytic, ndt_map


class LinkSet(NamedTuple):
    """Padded link arrays (NDTFeatureLink fields,
    ndt_feature_link.h:9-56)."""

    ref: jnp.ndarray    # (L,) int32
    mov: jnp.ndarray    # (L,) int32
    T: jnp.ndarray      # (L, 3) mov-node frame -> ref-node frame
    cov: jnp.ndarray    # (L, 3, 3)
    score: jnp.ndarray  # (L,) occupancy-overlap score (lower = better)
    mask: jnp.ndarray   # (L,) bool


def occupancy_overlap_score(
    ref: NodeData, mov: NodeData, T, resolution: float
):
    """Mean squared difference of rescaled occupancy over cells where
    both maps carry information; 1.0 when no overlap
    (overlapNDTOccupancyScore, ndt_feature_node.h:213-252)."""
    h, w = mov.occ.shape
    ys = (jnp.arange(h) + 0.5) * resolution
    xs = (jnp.arange(w) + 0.5) * resolution
    cx = mov.occ_origin[0] + xs
    cy = mov.occ_origin[1] + ys
    centers = jnp.stack(
        [
            jnp.broadcast_to(cx[None, :], (h, w)),
            jnp.broadcast_to(cy[:, None], (h, w)),
        ],
        -1,
    ).reshape(-1, 2)
    mov_occ = jax.nn.sigmoid(mov.occ.reshape(-1))
    mov_has = jnp.abs(mov.occ.reshape(-1)) > 1e-6

    tp = se2.transform_points(T, centers)
    rel = (tp - ref.occ_origin) / resolution
    ix = jnp.floor(rel[:, 0]).astype(jnp.int32)
    iy = jnp.floor(rel[:, 1]).astype(jnp.int32)
    inb = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
    flat = jnp.clip(iy, 0, h - 1) * w + jnp.clip(ix, 0, w - 1)
    ref_occ_raw = ref.occ.reshape(-1)[flat]
    ref_has = (jnp.abs(ref_occ_raw) > 1e-6) & inb
    ref_occ = jax.nn.sigmoid(ref_occ_raw)

    both = mov_has & ref_has
    nb = jnp.sum(both)
    diff2 = (mov_occ - ref_occ) ** 2
    s = jnp.sum(jnp.where(both, diff2, 0.0)) / jnp.maximum(nb, 1)
    return jnp.where(nb > 0, s, 1.0), nb


@functools.partial(
    jax.jit, static_argnames=("fp", "resolution")
)
def compute_link(
    fp: FeatureParams,
    resolution: float,
    ref: NodeData,
    mov: NodeData,
    key,
):
    """Feature-map RANSAC -> T, then occupancy-overlap score
    (computeLink, ndt_feature_graph.cpp:162-177).  Returns
    (T (3,), score, feat_valid, n_overlap)."""
    res = ransac.match_sets(
        fp, ref.feats, ref.desc, mov.feats, mov.desc, key
    )
    score, nb = occupancy_overlap_score(ref, mov, res.T, resolution)
    score = jnp.where(res.valid, score, 1.0)
    return res.T, score, res.valid, nb


def _overlap_score_flat(
    occ_flat, occ_origins, ref_i, mov_i, T, h: int, w: int,
    resolution: float,
):
    """occupancy_overlap_score against the STACKED bank: mov occupancy
    comes from a contiguous dynamic-slice of the flat (N*H*W,) table,
    the ref lookup is one offset gather — no per-pair (H, W) grid
    copies under vmap (same rationale as d2d.gather_windows_flat)."""
    hw = h * w
    mov_occ_raw = jax.lax.dynamic_slice(occ_flat, (mov_i * hw,), (hw,))
    mov_origin = occ_origins[mov_i]
    ref_origin = occ_origins[ref_i]
    ys = (jnp.arange(h) + 0.5) * resolution
    xs = (jnp.arange(w) + 0.5) * resolution
    cx = mov_origin[0] + xs
    cy = mov_origin[1] + ys
    centers = jnp.stack(
        [
            jnp.broadcast_to(cx[None, :], (h, w)),
            jnp.broadcast_to(cy[:, None], (h, w)),
        ],
        -1,
    ).reshape(-1, 2)
    mov_occ = jax.nn.sigmoid(mov_occ_raw)
    mov_has = jnp.abs(mov_occ_raw) > 1e-6

    tp = se2.transform_points(T, centers)
    rel = (tp - ref_origin) / resolution
    ix = jnp.floor(rel[:, 0]).astype(jnp.int32)
    iy = jnp.floor(rel[:, 1]).astype(jnp.int32)
    inb = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
    flat = jnp.clip(iy, 0, h - 1) * w + jnp.clip(ix, 0, w - 1)
    ref_occ_raw = occ_flat[ref_i * hw + flat]
    ref_has = (jnp.abs(ref_occ_raw) > 1e-6) & inb
    ref_occ = jax.nn.sigmoid(ref_occ_raw)

    both = mov_has & ref_has
    nb = jnp.sum(both)
    diff2 = (mov_occ - ref_occ) ** 2
    s = jnp.sum(jnp.where(both, diff2, 0.0)) / jnp.maximum(nb, 1)
    return jnp.where(nb > 0, s, 1.0), nb


@functools.partial(
    jax.jit, static_argnames=("fp", "resolution")
)
def compute_links_batch(
    fp: FeatureParams,
    resolution: float,
    nodes: NodeData,          # stacked (N, ...)
    pair_ref,                 # (P,) int32
    pair_mov,                 # (P,) int32
    pair_mask,                # (P,) bool
    key,
) -> LinkSet:
    """All-pairs link proposal in one vmapped batch
    (computeAllPossibleLinks, ndt_feature_graph.cpp:395-405).  Feature
    maps (small) are gathered per pair; occupancy overlap reads the
    flat bank in place."""
    keys = jax.random.split(key, pair_ref.shape[0])
    h, w = nodes.occ.shape[1], nodes.occ.shape[2]
    occ_flat = nodes.occ.reshape(-1)

    def one(i, j, k):
        rf = jax.tree.map(lambda x: x[i], nodes.feats)
        rd = nodes.desc[i]
        mf = jax.tree.map(lambda x: x[j], nodes.feats)
        md = nodes.desc[j]
        res = ransac.match_sets(fp, rf, rd, mf, md, k)
        score, _nb = _overlap_score_flat(
            occ_flat, nodes.occ_origin, i, j, res.T, h, w, resolution
        )
        score = jnp.where(res.valid, score, 1.0)
        return res.T, score, res.valid

    T, score, valid = jax.vmap(one)(pair_ref, pair_mov, keys)
    eye = jnp.tile(jnp.eye(3)[None] * 0.05, (pair_ref.shape[0], 1, 1))
    return LinkSet(
        ref=pair_ref,
        mov=pair_mov,
        T=T,
        cov=eye,
        score=score,
        mask=pair_mask & valid,
    )


@functools.partial(
    jax.jit, static_argnames=("map_params", "m", "src_budget")
)
def refine_links_d2d(
    map_params: NDTMapParams,
    m: MatcherParams,
    nodes: NodeData,
    links: LinkSet,
    src_budget: int = 0,
) -> LinkSet:
    """NDT D2D refinement of every link + covariance from the Hessian
    (updateLinksUsingNDTRegistration, ndt_feature_graph.cpp:260-345).

    The batched Newton runs against the FLAT packed bank
    (d2d_analytic.fgh_dense_flat_batch): each evaluation's window
    gather indexes the shared (N*H*W, 8) table with a per-pair row
    offset, instead of first materializing per-pair copies of whole
    target grids under vmap (~330 MB/evaluation at the canonical
    256-pair batch).  A win-row bank here (5x fewer rows,
    d2d.build_wide_table + explicit ref offsets) is the alternative;
    which layout wins on the GPU is not measured yet.

    src_budget > 0 truncates each pair's source cell list to that many
    leading rows.  CellLists are compacted (valid cells first), so any
    budget >= the true max valid-cell count is EXACT — callers measure the
    bank occupancy once and round up (slam._propose_links); the
    measured canonical op point fills ~131/165 of the 1024 padded
    slots, i.e. ~87% of the gather+pair math was masked padding.

    The Newton runs as ONE batch-level minimization
    (d2d.newton_match_batch + fgh_dense_flat_batch): all P pairs'
    window gathers are issued with flattened 1-D indices in a single
    gather per trial, and the lockstep trial loop early-exits when
    EVERY pair has converged — where vmap(newton_match)'s per-lane
    cond degrades to masked execution of the full 60-trial budget for
    every pair (round 4; same formulation as the fleet path,
    fusion/fuser.update_batch)."""
    h, w = map_params.grid_h, map_params.grid_w
    nb = src_budget if src_budget > 0 else nodes.cells.means.shape[1]

    src_b = ndt_map.CellList(
        means=nodes.cells.means[links.mov, :nb],
        covs=nodes.cells.covs[links.mov, :nb],
        mask=nodes.cells.mask[links.mov, :nb],
    )
    origins = nodes.target.origin[links.ref]
    packed_flat = nodes.target.packed.reshape(-1, 8)
    row_offsets = links.ref * (h * w)

    def fgh_batch(d_b):
        return d2d_analytic.fgh_dense_flat_batch(
            d_b, links.T, src_b, packed_flat, origins, row_offsets,
            h, w, map_params.resolution, m,
        )

    p_count = links.ref.shape[0]
    d_b, score_b, itr_b, conv = d2d.newton_match_batch(
        jnp.zeros((p_count, 3), jnp.float32), m, fgh_batch
    )
    T = jax.vmap(se2.compose)(d_b, links.T)
    _, _, H_b = fgh_batch(d_b)
    # One covariance convention repo-wide (d2d.cov_from_hessian:
    # cov_scale * floored-inverse-Hessian, symmetrized) — this used
    # to inline its own floor/scale, leaving the solver's relative
    # link-vs-odometry weighting to depend on which code path
    # produced the link.
    cov = jax.vmap(lambda H: d2d.cov_from_hessian(H, m))(H_b)
    return links._replace(T=T, cov=cov, mask=links.mask & conv)


def rescore_links(
    resolution: float, nodes: NodeData, links: LinkSet
) -> LinkSet:
    """Recompute occupancy-overlap scores for (possibly refined) link
    transforms (flat-bank lookups, see _overlap_score_flat)."""
    h, w = nodes.occ.shape[1], nodes.occ.shape[2]
    occ_flat = nodes.occ.reshape(-1)

    def one(ref_i, mov_i, T):
        s, _ = _overlap_score_flat(
            occ_flat, nodes.occ_origin, ref_i, mov_i, T, h, w,
            resolution,
        )
        return s

    score = jax.vmap(one)(links.ref, links.mov, links.T)
    return links._replace(score=score)


def source_cell_budget(nodes: NodeData, quantum: int = 64) -> int:
    """EXACT static source-cell budget for refine_links_d2d: the bank's
    max valid-cell count rounded up to `quantum` (bounds the number of
    distinct compiled shapes), clamped to the padded capacity.  One
    small host readback per offline phase."""
    import numpy as np

    cap = int(nodes.cells.means.shape[1])
    maxc = int(np.asarray(jnp.max(jnp.sum(nodes.cells.mask, axis=1))))
    b = max(quantum, ((maxc + quantum - 1) // quantum) * quantum)
    return min(b, cap)


@functools.partial(jax.jit, static_argnames=("gp",))
def valid_links(
    gp: GraphParams, node_T, links: LinkSet
) -> jnp.ndarray:
    """Validation gates (getValidLinks, ndt_feature_graph.cpp:527-556 +
    CLI defaults graph_opt.cpp:49-52): overlap score, consistency with
    the current global estimate, minimum index separation.  Returns a
    bool mask over links."""
    Tg = se2.sub(node_T[links.ref], node_T[links.mov])  # expected rel
    d = jnp.linalg.norm(links.T[:, :2] - Tg[:, :2], axis=-1)
    a = jnp.abs(se2.normalize_angle(links.T[:, 2] - Tg[:, 2]))
    idx_dist = jnp.abs(links.ref - links.mov)
    # Degenerate registrations (no overlapping cells) can leave a
    # non-finite pose/covariance — never a usable factor (seen on the
    # 570-node canonical run, round 5).
    finite = (
        jnp.all(jnp.isfinite(links.T), axis=-1)
        & jnp.all(jnp.isfinite(links.cov), axis=(-2, -1))
        & jnp.isfinite(links.score)
    )
    return (
        links.mask
        & finite
        & (links.score <= gp.valid_max_score)
        & (d <= gp.valid_max_dist)
        & (a <= gp.valid_max_angular_dist)
        & (idx_dist >= gp.valid_min_idx_dist)
    )
