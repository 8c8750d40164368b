"""Scan-to-submap fuser: the NDTFeatureFuserHMT equivalent.

Re-designs the per-scan pipeline of ndt_feature_fuser_hmt.cpp:108-512:
motion-model covariance → local NDT build → joint registration (NDT +
feature correspondences + odometry prior) → consistency gate with
odometry fallback → map update.  The whole update is ONE jitted pure
function over a `FuserState` pytree — no heap cells, no host round
trips.

Differences by design (SURVEY.md §7.6):
  * The 40-copies odometry pseudo-cell hack (fuser_hmt.cpp:312-334) is
    replaced by the explicit Mahalanobis prior term the reference also
    supports (`useSoftConstraints`, fusion.h:875-890), with the motion
    information lifted into the left-increment frame via the SE(2)
    adjoint.
  * Registration estimates the absolute vehicle→submap transform with
    the odometry-predicted pose as the initial guess, rather than
    left-composing a "local" increment onto world-frame cells
    (fuser_hmt.cpp:352-358) — equivalent at the optimum, cleaner frames.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ndt_feature_graph_tpu.config import FuserParams, NDTMapParams
from ndt_feature_graph_tpu.core import motion_model, se2
from ndt_feature_graph_tpu.ops import d2d, d2d_analytic, ndt_map
from ndt_feature_graph_tpu.ops.ndt_map import CellList, NDTGrid


def local_map_params(p: FuserParams) -> NDTMapParams:
    """Static geometry of the per-scan local NDT (the reference's
    `localMapSize = sensor_range + 3*resolution`, fuser_hmt.h:232)."""
    size = 2.0 * (p.ndt.sensor_range + 3.0 * p.ndt.resolution)
    return p.ndt.replace(size_x=size, size_y=size)


class FuserState(NamedTuple):
    """Per-submap fuser state pytree.

    `packed` is the (H*W, 8) channel-packed registration target
    (d2d.DenseTarget.packed layout) maintained INCREMENTALLY: after a
    scan's points are scattered into `grid`, only the touched cells'
    rows are re-finalized (d2d.refresh_packed) instead of re-finalizing
    all H*W cells every scan.
    Invariant: packed == d2d.packed_from_grid(grid) at all times."""

    Tnow: jnp.ndarray        # (3,) vehicle pose in submap/world frame
    Todom: jnp.ndarray       # (3,) dead-reckoning pose (diagnostics)
    Tlast_fuse: jnp.ndarray  # (3,)
    sensor_pose: jnp.ndarray  # (3,) laser in vehicle frame
    grid: NDTGrid            # the submap
    packed: jnp.ndarray      # (H*W, 8) incremental registration target
    n_updates: jnp.ndarray   # int32


class UpdateInfo(NamedTuple):
    score: jnp.ndarray
    iterations: jnp.ndarray
    converged: jnp.ndarray
    fallback: jnp.ndarray    # bool — consistency gate rejected the match
    T_est: jnp.ndarray       # (3,) raw registration estimate


def _vehicle_points(sensor_pose, pts):
    return se2.transform_points(sensor_pose, pts)


@functools.partial(jax.jit, static_argnames=("params",))
def initialize(
    params: FuserParams, init_pose, sensor_pose, pts, mask
) -> FuserState:
    """First scan: create the submap grid centred on the initial pose and
    insert the cloud (fuser_hmt.cpp:65-94)."""
    world_T = se2.compose(init_pose, sensor_pose)
    world_pts = se2.transform_points(world_T, pts)
    grid = ndt_map.empty_grid(params.ndt, init_pose[:2])
    grid = ndt_map.add_points(grid, params.ndt, world_pts, mask)
    grid = ndt_map.update_occupancy(
        grid, params.ndt, world_T[:2], world_pts, mask
    )
    return FuserState(
        Tnow=jnp.asarray(init_pose, jnp.float32),
        Todom=jnp.asarray(init_pose, jnp.float32),
        Tlast_fuse=jnp.asarray(init_pose, jnp.float32),
        sensor_pose=jnp.asarray(sensor_pose, jnp.float32),
        grid=grid,
        packed=d2d.packed_from_grid(grid, params.ndt),
        n_updates=jnp.int32(1),
    )


def _build_local_cells(params: FuserParams, sensor_pose, pts, mask):
    """Scan -> NDT cell list in the vehicle frame.

    Uses the touched-candidate compaction (finalize + compact only
    the <= P cells this scan touched — bit-exact vs the full-grid
    to_cell_list, see ndt_map.to_cell_list_touched) whenever the
    point capacity fits the cell capacity, instead of finalizing the
    whole local grid."""
    lp = local_map_params(params)
    vpts = _vehicle_points(sensor_pose, pts)
    grid = ndt_map.empty_grid(lp, jnp.zeros(2))
    if lp.max_points_per_scan <= lp.max_cells:
        grid, touched = ndt_map.add_points_touched(grid, lp, vpts, mask)
        return ndt_map.to_cell_list_touched(grid, lp, touched), vpts
    grid = ndt_map.add_points(grid, lp, vpts, mask)
    return ndt_map.to_cell_list(grid, lp), vpts


def _increment_information(params: FuserParams, Tmotion, T_pred):
    """Motion-model information, lifted from the local (robot) frame into
    the global left-increment frame used by the optimizer:
    for T = exp(d) ∘ T_pred = T_pred ∘ exp(eps):  d = Adj(T_pred) eps,
    so  I_d = Adj^{-T} I_eps Adj^{-1}."""
    I_eps = motion_model.odometry_information(params.motion, Tmotion)
    A = se2.adjoint(T_pred)
    Ainv = jnp.linalg.inv(A)
    return Ainv.T @ I_eps @ Ainv


@functools.partial(
    jax.jit, static_argnames=("params", "update_map")
)
def update(
    state: FuserState,
    params: FuserParams,
    Tmotion,
    pts,
    mask,
    feat_src: Optional[CellList] = None,
    feat_tgt: Optional[CellList] = None,
    update_map: bool = True,
):
    """One scan update.  Returns (new_state, UpdateInfo).

    `feat_src`/`feat_tgt` are optional paired pseudo-cell lists from
    feature correspondences (RANSAC output via
    features.to_paired_cells): src in the *vehicle* frame of the current
    scan, tgt in the submap frame — the clean equivalent of
    convertCorrespondencesToCellvectorsFixedCovWithCorr
    (conversions.h:12-84).
    """
    m = params.matcher
    T_pred = se2.compose(state.Tnow, Tmotion)
    Todom = se2.compose(state.Todom, Tmotion)

    src, _ = _build_local_cells(params, state.sensor_pose, pts, mask)
    nb = params.match_cell_budget
    if nb and nb < src.means.shape[0]:
        # Exact when the scan's valid cells fit the budget (compacted
        # list, valid-first); see config.FuserParams.match_cell_budget.
        src = CellList(
            means=src.means[:nb], covs=src.covs[:nb], mask=src.mask[:nb]
        )
    # Registration target: the state's incrementally-maintained packed
    # table (== make_dense_target(grid).packed at all times) read via
    # the flat-gather kernels — no per-scan full-grid re-finalize.
    h, w = params.ndt.grid_h, params.ndt.grid_w
    res = params.ndt.resolution
    tgt_packed = state.packed
    tgt_origin = state.grid.origin

    # Optional win-block gather table (config.gather_window_cells +
    # gather_block, same machinery as the fleet path at B=1): ONE
    # gathered row per source cell per trial instead of (2n+1)^2.
    wc = params.gather_window_cells
    use_block = (
        m.use_ndt and params.gather_block and 0 < wc < min(h, w)
    )
    if use_block:
        blk, blk_cell0 = d2d.build_window_block_tables(
            tgt_packed[None], tgt_origin[None], T_pred[None, :2],
            h, w, m.n_neighbours, wc, res,
            bf16=params.gather_table_bf16,
        )
        blk_flat = blk.reshape(-1, blk.shape[-1])
        src_b1 = jax.tree.map(lambda x: x[None], src)

    Q = _increment_information(params, Tmotion, T_pred)

    use_feat = (
        m.use_feat and feat_src is not None and feat_tgt is not None
    )

    def score_fn(d):
        s = jnp.float32(0.0)
        if m.use_ndt:
            s = s + d2d.d2d_score_dense_flat(
                d, T_pred, src, tgt_packed, tgt_origin, 0, h, w, res, m
            )
        if use_feat:
            s = s + d2d.d2d_score_paired(d, T_pred, feat_src, feat_tgt, m)
        if m.use_odom:
            s = s + d2d.mahalanobis_score(d, Q)
        return s

    def fgh_fn(d):
        """Single-pass analytic derivatives (ops/d2d_analytic.py) —
        the `derivativesNDT` fast path; verified against autodiff in
        tests/test_d2d_analytic.py."""
        f = jnp.float32(0.0)
        g = jnp.zeros(3)
        H = jnp.zeros((3, 3))
        if use_block:
            f1b, g1b, H1b = d2d_analytic.fgh_dense_block_batch(
                d[None], T_pred[None], src_b1, blk_flat, blk_cell0,
                tgt_origin[None], wc, res, m,
                rel_means=params.gather_table_bf16,
            )
            f, g, H = f + f1b[0], g + g1b[0], H + H1b[0]
        elif m.use_ndt:
            f1, g1, H1 = d2d_analytic.fgh_dense_flat(
                d, T_pred, src, tgt_packed, tgt_origin, 0, h, w, res, m
            )
            f, g, H = f + f1, g + g1, H + H1
        if use_feat:
            f2, g2, H2 = d2d_analytic.fgh_paired(
                d, T_pred, feat_src, feat_tgt, m
            )
            f, g, H = f + f2, g + g2, H + H2
        if m.use_odom:
            f3, g3, H3 = d2d_analytic.fgh_mahalanobis(d, Q)
            f, g, H = f + f3, g + g3, H + H3
        return f, g, H

    d, score, itr, conv = d2d.newton_match(
        score_fn, jnp.zeros(3), m, fgh_fn=fgh_fn
    )
    return _finalize_update(
        state, params, Tmotion, T_pred, Todom, d, score, itr, conv,
        pts, mask, update_map,
    )


def _finalize_update(
    state: FuserState, params: FuserParams, Tmotion, T_pred, Todom,
    d, score, itr, conv, pts, mask, update_map: bool,
    update_occ: bool = True,
):
    """Post-registration tail of `update` (consistency gate, rolling
    recentre, map update + incremental packed refresh, bookkeeping) —
    shared by the single-stream path and the batched fleet path
    (update_batch vmaps it)."""
    T_est = se2.compose(
        jnp.stack([d[0], d[1], d[2]]), T_pred
    )

    # Consistency gate (fuser_hmt.cpp:436-441): compare the estimated
    # relative motion against odometry; reject wild matches.
    rel_est = se2.sub(state.Tnow, T_est)
    diff = se2.sub(rel_est, Tmotion)
    bad = (
        jnp.linalg.norm(diff[:2]) > params.max_translation_norm
    ) | (jnp.abs(diff[2]) > params.max_rotation_norm)
    if params.force_odom_as_est:
        use_fallback = jnp.bool_(True)
    elif params.check_consistency and not params.all_matches_valid:
        use_fallback = bad
    else:
        use_fallback = jnp.bool_(False)
    Tnow = jnp.where(use_fallback, T_pred, T_est)

    # Rolling-map recentre (NDTMapHMT window follow): if the vehicle
    # left the margin, slide the window onto it by whole cells.  The
    # shift is zeroed (exact no-op) while inside the margin, so this
    # stays a single traced program.  The packed registration target
    # rolls in lockstep (rows follow their cells; exposed rows get the
    # empty-cell pack).
    grid = state.grid
    packed = state.packed
    if params.rolling_map:
        center = grid.origin + jnp.asarray(
            [params.ndt.size_x / 2.0, params.ndt.size_y / 2.0],
            grid.origin.dtype,
        )
        off = Tnow[:2] - center
        target = jnp.where(
            jnp.linalg.norm(off) > params.roll_margin, Tnow[:2], center
        )
        grid, packed = ndt_map.recenter_with_aux(
            grid, params.ndt, target, packed, d2d.empty_pack_row()
        )

    # Map update (fuser_hmt.cpp:482-487) + incremental refresh of the
    # touched cells' packed rows.
    if update_map:
        world_T = se2.compose(Tnow, state.sensor_pose)
        world_pts = se2.transform_points(world_T, pts)
        grid, touched = ndt_map.add_points_touched(
            grid, params.ndt, world_pts, mask
        )
        packed = d2d.refresh_packed(packed, grid, params.ndt, touched)
        if update_occ:
            grid = ndt_map.update_occupancy(
                grid, params.ndt, world_T[:2], world_pts, mask
            )

    moved = se2.sub(state.Tlast_fuse, Tnow)
    fused = (jnp.linalg.norm(moved[:2]) > 0.05) | (
        jnp.abs(moved[2]) > 0.01
    )
    Tlast_fuse = jnp.where(fused, Tnow, state.Tlast_fuse)

    new_state = FuserState(
        Tnow=Tnow,
        Todom=Todom,
        Tlast_fuse=Tlast_fuse,
        sensor_pose=state.sensor_pose,
        grid=grid,
        packed=packed,
        n_updates=state.n_updates + 1,
    )
    info = UpdateInfo(
        score=score,
        iterations=itr,
        converged=conv,
        fallback=use_fallback,
        T_est=T_est,
    )
    return new_state, info


@functools.partial(
    jax.jit, static_argnames=("params", "update_map")
)
def update_batch(
    states: FuserState,   # batched (B, ...) pytree
    params: FuserParams,
    Tmotion,              # (B, 3)
    pts,                  # (B, P, 2)
    mask,                 # (B, P)
    feat_src: Optional[CellList] = None,   # batched (B, C, ...)
    feat_tgt: Optional[CellList] = None,   # batched (B, C, ...)
    update_map: bool = True,
    occ_on=None,   # scalar bool: this step is on the occupancy cadence
):
    """One scan update for B independent streams (fleet serving) —
    semantically vmap(update), but the registration gathers index ONE
    flat packed table with per-stream row offsets instead of vmapping
    over per-stream tables.

    Why: a vmapped gather whose OPERAND carries the batch dim can
    lower to a per-lane broadcast of the whole operand.  Indexing a
    shared flat table with `row_offset = i*H*W` keeps it one plain
    gather, the same form as offline pair registration (graph/links.py
    refine_links_d2d flat-bank form).

    `feat_src`/`feat_tgt` are optional BATCHED paired pseudo-cell
    lists from per-stream feature correspondences
    (feature_fuser._prepare_features under vmap) — small per-lane
    arrays, so their fgh term vmaps cleanly into the batch-level
    Newton (no shared-bank gathers involved).

    Returns (new_states, infos) batched like the inputs.
    """
    m = params.matcher
    h, w = params.ndt.grid_h, params.ndt.grid_w
    res = params.ndt.resolution
    b = states.Tnow.shape[0]

    T_pred = jax.vmap(se2.compose)(states.Tnow, Tmotion)
    Todom = jax.vmap(se2.compose)(states.Todom, Tmotion)

    def build_src(sp, p, mk):
        src, _ = _build_local_cells(params, sp, p, mk)
        nb = params.match_cell_budget
        if nb and nb < src.means.shape[0]:
            src = CellList(
                means=src.means[:nb], covs=src.covs[:nb],
                mask=src.mask[:nb],
            )
        return src

    src_b = jax.vmap(build_src)(states.sensor_pose, pts, mask)
    Q_b = jax.vmap(
        lambda tm, tp: _increment_information(params, tm, tp)
    )(Tmotion, T_pred)

    # ONE flat WIN-ROW bank shared by every lane's window gather; the
    # batch-level Newton issues that gather with flattened 1-D indices
    # (no vmap batching dims — see fgh_dense_flat_batch), and the
    # win-row layout needs (2n+1) gather rows per source cell instead
    # of (2n+1)^2 (see d2d.build_wide_table).  Derived fresh each step
    # from the incrementally-maintained packed table — pure slicing,
    # recentre-safe.  With gather_window_cells set, the bank is
    # additionally bounded to each stream's sensor window around the
    # predicted pose (and optionally stored bf16 with cell-relative
    # means), see config.FuserParams.gather_window_cells /
    # gather_table_bf16.
    origins = states.grid.origin                      # (B, 2)
    wc = params.gather_window_cells
    use_window = 0 < wc < min(h, w)
    use_block = use_window and params.gather_block
    if use_block:
        block, cell0 = d2d.build_window_block_tables(
            states.packed, origins, T_pred[:, :2], h, w,
            m.n_neighbours, wc, res, bf16=params.gather_table_bf16,
        )
        hp = wc + 2 * m.n_neighbours
        block_flat = block.reshape(b * hp * hp, block.shape[-1])
    elif use_window:
        wide, cell0 = d2d.build_window_tables(
            states.packed, origins, T_pred[:, :2], h, w,
            m.n_neighbours, wc, res, bf16=params.gather_table_bf16,
        )
        stride = d2d.wide_row_stride(wc, wc, m.n_neighbours)
        wide_flat = wide.reshape(b * stride, wide.shape[-1])
    else:
        wide = d2d.build_wide_table(
            states.packed, h, w, m.n_neighbours
        )
        stride = d2d.wide_row_stride(h, w, m.n_neighbours)
        wide_flat = wide.reshape(b * stride, wide.shape[-1])
    Qs_b = Q_b + Q_b.transpose(0, 2, 1)
    use_feat = (
        m.use_feat and feat_src is not None and feat_tgt is not None
    )
    if use_feat:
        paired_fgh = jax.vmap(
            lambda d, T0, s_, t_: d2d_analytic.fgh_paired(
                d, T0, s_, t_, m
            )
        )

    def fgh_batch(d_b):
        f = jnp.zeros(b, jnp.float32)
        g = jnp.zeros((b, 3), jnp.float32)
        H = jnp.zeros((b, 3, 3), jnp.float32)
        if m.use_ndt:
            if use_block:
                f1, g1, H1 = d2d_analytic.fgh_dense_block_batch(
                    d_b, T_pred, src_b, block_flat, cell0, origins,
                    wc, res, m,
                    rel_means=params.gather_table_bf16,
                )
            elif use_window:
                f1, g1, H1 = d2d_analytic.fgh_dense_window_batch(
                    d_b, T_pred, src_b, wide_flat, cell0, origins,
                    wc, wc, res, m,
                    rel_means=params.gather_table_bf16,
                )
            else:
                f1, g1, H1 = d2d_analytic.fgh_dense_wide_batch(
                    d_b, T_pred, src_b, wide_flat, origins,
                    h, w, res, m,
                )
            f, g, H = f + f1, g + g1, H + H1
        if use_feat:
            f2, g2, H2 = paired_fgh(d_b, T_pred, feat_src, feat_tgt)
            f, g, H = f + f2, g + g2, H + H2
        if m.use_odom:
            # Batched fgh_mahalanobis: d^T Q d, (Q+Q^T) d, Q+Q^T.
            f = f + jnp.einsum("bi,bij,bj->b", d_b, Q_b, d_b)
            g = g + jnp.einsum("bij,bj->bi", Qs_b, d_b)
            H = H + Qs_b
        return f, g, H

    d_b, score_b, itr_b, conv_b = d2d.newton_match_batch(
        jnp.zeros((b, 3), jnp.float32), m, fgh_batch
    )

    # Occupancy cadence (config.occ_every): the log-odds ray scatter
    # is ~50x the point-stats scatter in transactions; when gated, it
    # runs OUTSIDE the per-lane vmap under one scalar lax.cond so
    # off-cadence steps of a sequential scan skip it entirely.
    gate_occ = params.occ_every != 1 and update_map
    new_states, infos = jax.vmap(
        lambda st, tm, tp, to, d, s, it, cv, p, mk: _finalize_update(
            st, params, tm, tp, to, d, s, it, cv, p, mk, update_map,
            update_occ=not gate_occ,
        )
    )(states, Tmotion, T_pred, Todom, d_b, score_b, itr_b, conv_b,
      pts, mask)

    if gate_occ and params.occ_every > 0:
        def do_occ(sts):
            def one(st, p, mk):
                world_T = se2.compose(st.Tnow, st.sensor_pose)
                wp = se2.transform_points(world_T, p)
                return st._replace(grid=ndt_map.update_occupancy(
                    st.grid, params.ndt, world_T[:2], wp, mk
                ))

            return jax.vmap(one)(sts, pts, mask)

        if occ_on is None:
            new_states = do_occ(new_states)
        else:
            new_states = jax.lax.cond(
                occ_on, do_occ, lambda s: s, new_states
            )
    return new_states, infos
