"""NDT grid builder: fixed-shape replacement of NDTMap/LazyGrid/
computeNDTCells (perception_oru externals, see SURVEY.md §2.3).

Design: a *dense, fixed-shape* (H, W) cell grid per submap instead of the
reference's lazily-allocated hash grid of heap cells.  Struct-of-arrays:
running count / sum / sum-of-outer-products support the reference's
CELL_UPDATE_MODE_SAMPLE_VARIANCE streaming update exactly (the sufficient
statistics are additive), plus occupancy log-odds updated along beams.
Everything is scatter-adds and elementwise math — XLA fuses it; shapes
never depend on data.

A compact "cell list" view (means/covs/mask padded to `max_cells`) feeds
the registration kernels.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ndt_feature_graph_tpu.config import NDTMapParams
from ndt_feature_graph_tpu.core import se2


class NDTGrid(NamedTuple):
    """Dense NDT submap. origin = world coords of the (0, 0) cell corner."""

    origin: jnp.ndarray     # (2,)
    count: jnp.ndarray      # (H, W)
    psum: jnp.ndarray       # (H, W, 2)   sum of points
    outer: jnp.ndarray      # (H, W, 2, 2) sum of outer products
    occ: jnp.ndarray        # (H, W)      log-odds occupancy

    @property
    def shape(self):
        return self.count.shape


class CellList(NamedTuple):
    """Compact padded view of gaussians (for registration sources)."""

    means: jnp.ndarray      # (N, 2)
    covs: jnp.ndarray       # (N, 2, 2)
    mask: jnp.ndarray       # (N,) bool

    def transform(self, pose):
        """Rigidly move gaussians (pseudoTransformNDT semantics:
        mean' = T mean, cov' = R cov R^T)."""
        means = se2.transform_points(pose, self.means)
        covs = se2.rotate_covs(pose[..., 2], self.covs)
        return CellList(means, covs, self.mask)


def empty_grid(params: NDTMapParams, center, dtype=jnp.float32) -> NDTGrid:
    """Create an empty grid centred on `center` (2,) world coords."""
    h, w = params.grid_h, params.grid_w
    origin = jnp.asarray(center, dtype) - jnp.asarray(
        [params.size_x / 2.0, params.size_y / 2.0], dtype
    )
    return NDTGrid(
        origin=origin,
        count=jnp.zeros((h, w), dtype),
        psum=jnp.zeros((h, w, 2), dtype),
        outer=jnp.zeros((h, w, 2, 2), dtype),
        occ=jnp.zeros((h, w), dtype),
    )


def cell_index(params: NDTMapParams, origin, pts):
    """Point (..., 2) -> (iy, ix) integer cell coords (floor(p/res))."""
    rel = (pts - origin) / params.resolution
    ix = jnp.floor(rel[..., 0]).astype(jnp.int32)
    iy = jnp.floor(rel[..., 1]).astype(jnp.int32)
    return iy, ix


def in_bounds(params: NDTMapParams, iy, ix):
    return (
        (iy >= 0) & (iy < params.grid_h) & (ix >= 0) & (ix < params.grid_w)
    )


def add_points_touched(
    grid: NDTGrid, params: NDTMapParams, pts, mask
):
    """Scatter a masked point batch (P, 2) into the sufficient
    statistics and ALSO return the touched flat cell indices.

    Replaces NDTMap::addPointCloud + computeNDTCells(SAMPLE_VARIANCE)
    (fuser_hmt.cpp:482-487): because we keep (count, sum, outer), the
    recursive sample-variance update is just addition.

    Returns (grid, flat (P,) int32) where flat[i] is the updated cell's
    flat index, or the out-of-grid sentinel h*w for dropped points —
    consumers that maintain derived per-cell tables (the fuser's
    incremental packed registration target) refresh exactly these rows
    instead of re-finalizing the whole grid.
    """
    iy, ix = cell_index(params, grid.origin, pts)
    # NaN guard (sensor glitches poison sufficient statistics otherwise;
    # int casts of NaN are platform-defined and can pass bounds checks).
    finite = jnp.all(jnp.isfinite(pts), axis=-1)
    ok = mask & finite & in_bounds(params, iy, ix)
    h, w = params.grid_h, params.grid_w
    flat = jnp.where(ok, iy * w + ix, h * w)  # out-of-range -> dropped
    ptsm = jnp.where(ok[..., None], pts, 0.0)

    # Scatter IN PLACE (mode="drop" eats the sentinel) instead of
    # scattering into a fresh (H*W+1, ...) array and adding: the old
    # form materialized zeros + a full-grid elementwise add per field
    # per scan — ~1 MB of avoidable traffic per stream per scan.
    count = grid.count.reshape(-1).at[flat].add(
        ok.astype(grid.count.dtype), mode="drop"
    ).reshape(h, w)
    psum = grid.psum.reshape(-1, 2).at[flat].add(
        ptsm, mode="drop"
    ).reshape(h, w, 2)
    op = ptsm[..., :, None] * ptsm[..., None, :]
    outer = grid.outer.reshape(-1, 2, 2).at[flat].add(
        op, mode="drop"
    ).reshape(h, w, 2, 2)
    return grid._replace(count=count, psum=psum, outer=outer), flat


def add_points(
    grid: NDTGrid, params: NDTMapParams, pts, mask
) -> NDTGrid:
    """add_points_touched without the touched-cell report."""
    grid, _ = add_points_touched(grid, params, pts, mask)
    return grid


def update_occupancy(
    grid: NDTGrid, params: NDTMapParams, sensor_origin, pts, mask
) -> NDTGrid:
    """Log-odds occupancy along beams: endpoint cells get `occ_hit`,
    cells crossed by the ray get `occ_miss` (NDTMap occupancy update
    semantics used by overlapNDTOccupancyScore, ndt_feature_node.h:213).

    Free space is sampled at `ray_samples` points per beam — a fixed-shape
    approximation of exact ray traversal (adequate at submap resolution).
    """
    h, w = params.grid_h, params.grid_w

    # Hits.
    iy, ix = cell_index(params, grid.origin, pts)
    mask = mask & jnp.all(jnp.isfinite(pts), axis=-1)
    ok = mask & in_bounds(params, iy, ix)
    flat = jnp.where(ok, iy * w + ix, h * w)

    # Misses: sample along each ray, strictly before the endpoint.
    s = (jnp.arange(params.ray_samples) + 0.5) / params.ray_samples
    ray = sensor_origin[None, None, :] + s[None, :, None] * (
        pts[:, None, :] - sensor_origin[None, None, :]
    )  # (P, S, 2)
    riy, rix = cell_index(params, grid.origin, ray)
    rok = mask[:, None] & in_bounds(params, riy, rix)
    # Don't decrement the endpoint cell itself.
    rok = rok & ~((riy == iy[:, None]) & (rix == ix[:, None]))
    rflat = jnp.where(rok, riy * w + rix, h * w).reshape(-1)

    # In-place scatters (mode="drop") — see add_points_touched.
    occ_acc = grid.occ.reshape(-1).at[flat].add(
        jnp.where(ok, params.occ_hit, 0.0), mode="drop"
    ).at[rflat].add(
        jnp.where(rok.reshape(-1), params.occ_miss, 0.0), mode="drop"
    )
    occ = jnp.clip(
        occ_acc.reshape(h, w), -params.occ_clamp, params.occ_clamp
    )
    return grid._replace(occ=occ)


def _sym_eig_2x2(c):
    """Closed-form eigendecomposition of symmetric 2x2 matrices
    (..., 2, 2) -> (evals (..., 2) ascending, evecs (..., 2, 2))."""
    a = c[..., 0, 0]
    b = c[..., 0, 1]
    d = c[..., 1, 1]
    tr = a + d
    diff = a - d
    disc = jnp.sqrt(diff * diff + 4.0 * b * b + 1e-20)
    l0 = 0.5 * (tr - disc)
    l1 = 0.5 * (tr + disc)
    # Eigenvector for l1: (b, l1 - a) unless degenerate.
    vx = jnp.where(jnp.abs(b) > 1e-12, b, jnp.where(diff >= 0, 1.0, 0.0))
    vy = jnp.where(jnp.abs(b) > 1e-12, l1 - a, jnp.where(diff >= 0, 0.0, 1.0))
    n = jnp.sqrt(vx * vx + vy * vy + 1e-20)
    v1 = jnp.stack([vx / n, vy / n], -1)
    v0 = jnp.stack([-v1[..., 1], v1[..., 0]], -1)
    evals = jnp.stack([l0, l1], -1)
    evecs = jnp.stack([v0, v1], -1)  # columns
    return evals, evecs


def condition_cov(cov, min_eig_ratio=1e-3, min_eig_abs=1e-6):
    """NDTCell covariance conditioning: clamp the small eigenvalue to
    `min_eig_ratio` of the large one (perception_oru rescales ill-
    conditioned cell covariances the same way before inverting)."""
    evals, evecs = _sym_eig_2x2(cov)
    lmax = jnp.maximum(evals[..., 1], min_eig_abs)
    lmin = jnp.clip(evals[..., 0], min_eig_ratio * lmax, None)
    # V diag(lam) V^T written out (an einsum would run in TF32 on the
    # GPU at default precision).
    v00, v01 = evecs[..., 0, 0], evecs[..., 0, 1]
    v10, v11 = evecs[..., 1, 0], evecs[..., 1, 1]
    c00 = v00 * v00 * lmin + v01 * v01 * lmax
    c01 = v00 * v10 * lmin + v01 * v11 * lmax
    c11 = v10 * v10 * lmin + v11 * v11 * lmax
    return jnp.stack(
        [jnp.stack([c00, c01], -1), jnp.stack([c01, c11], -1)], -2
    )


def finalize_stats(count, psum, outer, params: NDTMapParams):
    """(mean, cov, valid) from sufficient statistics, batched over any
    leading dims — the per-cell core of `finalize`, also used to
    refresh individual gathered cells (fuser incremental packed
    target).

    Sample variance: cov = (outer - n * mean mean^T) / (n - 1), valid
    only where count >= min_points_per_cell (NDTCell::computeGaussian
    semantics).
    """
    n = count
    valid = n >= params.min_points_per_cell
    nsafe = jnp.maximum(n, 1.0)
    mean = psum / nsafe[..., None]
    mm = mean[..., :, None] * mean[..., None, :]
    cov = (outer - nsafe[..., None, None] * mm) / jnp.maximum(
        nsafe - 1.0, 1.0
    )[..., None, None]
    cov = condition_cov(cov)
    # Degenerate guard: positive determinant required.
    det = cov[..., 0, 0] * cov[..., 1, 1] - cov[..., 0, 1] * cov[..., 1, 0]
    valid = valid & (det > 1e-12)
    eye = jnp.eye(2, dtype=cov.dtype) * 1e-3
    cov = jnp.where(valid[..., None, None], cov, eye)
    return mean, cov, valid


def finalize(grid: NDTGrid, params: NDTMapParams):
    """Compute (mean, cov, valid) fields from sufficient statistics.

    Returns (means (H,W,2), covs (H,W,2,2), valid (H,W)); see
    finalize_stats for the semantics.
    """
    return finalize_stats(grid.count, grid.psum, grid.outer, params)


def to_cell_list(grid: NDTGrid, params: NDTMapParams) -> CellList:
    """Compact the valid gaussians into a fixed-capacity padded list
    (getAllInitializedCells equivalent)."""
    mean, cov, valid = finalize(grid, params)
    h, w = params.grid_h, params.grid_w
    flat_valid = valid.reshape(-1)
    idx = jnp.nonzero(
        flat_valid, size=params.max_cells, fill_value=h * w - 1
    )[0]
    got = jnp.arange(params.max_cells) < jnp.sum(flat_valid)
    means = mean.reshape(-1, 2)[idx]
    covs = cov.reshape(-1, 2, 2)[idx]
    return CellList(means=means, covs=covs, mask=got)


def to_cell_list_touched(
    grid: NDTGrid, params: NDTMapParams, flat_touched
) -> CellList:
    """to_cell_list when every valid cell is known to lie within the
    `flat_touched` ids (a grid built from ONE scan, e.g. the per-scan
    local NDT): finalize and compact only the <= P unique touched
    candidates instead of all H*W cells.

    Bit-exact vs to_cell_list (same cells, same ascending-flat-index
    order, same stats — jnp.unique sorts, and valid => count >=
    min_points => touched) whenever the unique-candidate count fits
    max_cells; callers must guarantee
    max_points_per_scan <= max_cells (fusion/fuser._build_local_cells
    checks and falls back).  The full-grid form finalizes ~16k cells
    and runs an H*W-wide compaction per stream per scan.
    """
    h, w = params.grid_h, params.grid_w
    cap = params.max_cells
    cand = jnp.unique(flat_touched, size=cap, fill_value=h * w)
    safe = jnp.minimum(cand, h * w - 1)
    n = grid.count.reshape(-1)[safe]
    ps = grid.psum.reshape(-1, 2)[safe]
    op = grid.outer.reshape(-1, 2, 2)[safe]
    mean, cov, valid = finalize_stats(n, ps, op, params)
    valid = valid & (cand < h * w)
    idx = jnp.nonzero(valid, size=cap, fill_value=cap - 1)[0]
    got = jnp.arange(cap) < jnp.sum(valid)
    return CellList(means=mean[idx], covs=cov[idx], mask=got)


def recenter(grid: NDTGrid, params: NDTMapParams, new_center):
    """Shift the grid window by whole cells so it is centred (to cell
    quantization) on `new_center` (2,) world coords — the rolling-map
    core of NDTMapHMT (perception_oru NDTMapHMT: a tile window that
    follows the robot, ndt_fuser/ndt_fuser_hmt.h `setMotion` grid
    moves).  Cells that stay inside the window keep their sufficient
    statistics and occupancy exactly; cells that fall off the trailing
    edge are dropped; newly exposed cells start empty.

    Fully jit-compatible: the shift is a traced integer, applied with
    jnp.roll + iota masks (fixed shapes, no host round trip).  A zero
    shift is an exact no-op.
    """
    g, _ = recenter_with_aux(grid, params, new_center)
    return g


def recenter_with_aux(
    grid: NDTGrid, params: NDTMapParams, new_center,
    aux=None, aux_fill=None,
):
    """`recenter`, plus an optional companion (H*W, C) per-cell table
    (the fuser's incremental packed registration target) shifted in
    lockstep: rows follow their cells; rows exposed at the leading edge
    are set to `aux_fill` (C,) — the pack of an empty cell.  Returns
    (grid, aux_or_None)."""
    res = params.resolution
    cur_center = grid.origin + jnp.asarray(
        [params.size_x / 2.0, params.size_y / 2.0], grid.origin.dtype
    )
    shift = jnp.round(
        (jnp.asarray(new_center, grid.origin.dtype) - cur_center) / res
    ).astype(jnp.int32)  # (2,) = (sx, sy) in cells
    sx, sy = shift[0], shift[1]
    new_origin = grid.origin + shift.astype(grid.origin.dtype) * res

    h, w = params.grid_h, params.grid_w
    # A world point with old indices (iy, ix) lands at (iy - sy, ix - sx)
    # in the shifted window: roll content by (-sy, -sx) and blank the
    # wrapped-in band (old index out of [0, H/W)).
    iy = jnp.arange(h, dtype=jnp.int32)[:, None]
    ix = jnp.arange(w, dtype=jnp.int32)[None, :]
    keep = (
        (iy + sy >= 0) & (iy + sy < h) & (ix + sx >= 0) & (ix + sx < w)
    )

    def mv(a, fill=None):
        rolled = jnp.roll(a, shift=(-sy, -sx), axis=(0, 1))
        k = keep.reshape(keep.shape + (1,) * (a.ndim - 2))
        f = jnp.zeros((), a.dtype) if fill is None else fill
        return jnp.where(k, rolled, f)

    g = NDTGrid(
        origin=new_origin,
        count=mv(grid.count),
        psum=mv(grid.psum),
        outer=mv(grid.outer),
        occ=mv(grid.occ),
    )
    aux_out = None
    if aux is not None:
        c = aux.shape[-1]
        aux_out = mv(
            aux.reshape(h, w, c), aux_fill
        ).reshape(h * w, c)
    return g, aux_out


def occupancy_rescaled(grid: NDTGrid):
    """Occupancy in [0, 1] (NDTCell::getOccupancyRescaled): 0.5 ==
    no information."""
    return jax.nn.sigmoid(grid.occ)


def build_from_scan(
    params: NDTMapParams, center, sensor_origin, pts, mask
) -> NDTGrid:
    """One-shot: empty grid + points + occupancy (the per-scan local map
    `ndglobal`, fuser_hmt.cpp:195-232)."""
    g = empty_grid(params, center)
    g = add_points(g, params, pts, mask)
    g = update_occupancy(g, params, sensor_origin, pts, mask)
    return g
