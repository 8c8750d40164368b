"""Device-resident sequence drivers: process whole scan sequences (and
batches of sequences) inside one XLA executable via lax.scan.

The reference processes scans one ROS callback at a time
(publish_graph_message.cpp:1259); on an accelerator the per-call
dispatch would dominate, so the production path keeps the fuser state resident on
device and scans the sequence in-compiler — one dispatch per sequence
chunk, host sees only the trajectory.  The batched variant vmaps whole
fleets of independent scan streams (multi-robot serving).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ndt_feature_graph_tpu.config import FuserParams
from ndt_feature_graph_tpu.fusion import fuser


@functools.partial(jax.jit, static_argnames=("params",))
def run_sequence(params: FuserParams, state, odom, pts, mask):
    """Chain fuser.update over a (T, ...) sequence on device.

    odom: (T, 3); pts: (T, P, 2); mask: (T, P).
    Returns (final_state, trajectory (T, 3), scores (T,)).
    """

    def body(st, x):
        tm, p, m = x
        ns, info = fuser.update.__wrapped__(st, params, tm, p, m)
        return ns, (ns.Tnow, info.score)

    final, (traj, scores) = jax.lax.scan(body, state, (odom, pts, mask))
    return final, traj, scores


@functools.partial(jax.jit, static_argnames=("params",))
def run_sequence_features(params: FuserParams, state, odom, ranges, hit):
    """Device-resident full-pipeline driver: the feature-aware fuser
    (detector + descriptor + RANSAC + joint fusion) chained over a
    (T, ...) sequence in one executable.

    state: FeatureFuserState; odom (T, 3); ranges (T, B); hit (T, B).
    Returns (final_state, trajectory (T, 3), scores (T,)).
    """
    from ndt_feature_graph_tpu.fusion import feature_fuser

    def body(st, x):
        tm, r, h = x
        ns, info, res = feature_fuser.update.__wrapped__(
            st, params, tm, r, h
        )
        return ns, (ns.base.Tnow, info.score)

    final, (traj, scores) = jax.lax.scan(
        body, state, (odom, ranges, hit)
    )
    return final, traj, scores


@functools.partial(
    jax.jit, static_argnames=("params", "fm_incr")
)
def run_graph_chunk(
    params: FuserParams,
    state,
    fmap,
    dist_moved,
    update_count,
    odom,
    ranges,
    hit,
    active,
    split_dist,
    fm_incr: int = 4,
):
    """Device-resident GRAPH driver chunk: run up to K gated scans of
    the full feature pipeline (detect + describe + RANSAC + joint
    fusion + map update + feature-map accumulation) inside ONE
    executable, stopping at the first distance-triggered node split.

    This removes the per-scan host dispatch from the graph
    orchestrator's hot path (the reference's whole per-scan online
    pipeline, publish_graph_message.cpp:1259-1628, runs in-process; our
    equivalent must not pay ~0.3 ms dispatch per scan).  The host
    handles only the split *event*: freeze node, re-init, resume from
    the returned index.

    state: FeatureFuserState; fmap: node.FeatureMapBuffer;
    dist_moved: f32 distance accumulated in the active node;
    update_count: i32 updates done in the active node;
    odom (K, 3); ranges (K, B); hit (K, B); active (K,) bool
    (padding flag for the last partial chunk); split_dist: f32.

    Returns (state, fmap, dist_moved, update_count, traj (K, 3),
    scores (K,), processed (K,) bool, split (bool), split_idx (i32)).
    The scan AT split_idx has been fused into the old node (the
    reference fuses the split-triggering scan before opening the new
    node, ndt_feature_graph.cpp:72-93); scans after it are untouched.
    """
    from ndt_feature_graph_tpu.core import se2
    from ndt_feature_graph_tpu.fusion import feature_fuser
    from ndt_feature_graph_tpu.graph import node as node_mod

    k_len = odom.shape[0]

    def body(carry, x):
        st, fm, dist, cnt, done, split_idx = carry
        tm, r, h, act, idx = x
        run_it = (~done) & act

        def do(args):
            st, fm, dist, cnt = args
            ns, info, _res = feature_fuser.update.__wrapped__(
                st, params, tm, r, h
            )
            dist2 = dist + jnp.linalg.norm(tm[:2])
            split_now = dist2 > split_dist
            cnt2 = cnt + 1
            node_pose = se2.compose(ns.base.Tnow, ns.base.sensor_pose)
            fm_ins = node_mod.insert_features.__wrapped__(
                fm, ns.prev_feats, ns.prev_desc, node_pose
            )
            take = ((cnt2 % fm_incr) == 0) & (~split_now)
            fm2 = jax.tree.map(
                lambda a, b: jnp.where(take, a, b), fm_ins, fm
            )
            return ns, fm2, dist2, cnt2, split_now, info.score

        def skip(args):
            st, fm, dist, cnt = args
            return st, fm, dist, cnt, jnp.bool_(False), jnp.float32(0.0)

        st2, fm2, dist2, cnt2, split_now, score = jax.lax.cond(
            run_it, do, skip, (st, fm, dist, cnt)
        )
        new_split = split_now & (~done)
        split_idx2 = jnp.where(new_split, idx, split_idx)
        done2 = done | split_now | (~act)
        out = (st2.base.Tnow, score, run_it)
        return (st2, fm2, dist2, cnt2, done2, split_idx2), out

    idxs = jnp.arange(k_len, dtype=jnp.int32)
    init = (
        state, fmap, jnp.float32(dist_moved),
        jnp.int32(update_count), jnp.bool_(False), jnp.int32(-1),
    )
    (st, fm, dist, cnt, done, split_idx), (traj, scores, processed) = (
        jax.lax.scan(body, init, (odom, ranges, hit, active, idxs))
    )
    # Host-visible numbers packed into ONE small vector: each separate
    # scalar readback is a device sync plus a transfer, so the
    # orchestrator pays exactly one (plus the trajectory).
    meta = jnp.stack([
        dist,
        cnt.astype(jnp.float32),
        jnp.sum(processed).astype(jnp.float32),
        split_idx.astype(jnp.float32),
    ])
    return st, fm, traj, scores, meta


@functools.partial(
    jax.jit,
    static_argnames=("params", "max_nodes", "fm_incr", "link_source"),
)
def run_graph_sequence(
    params: FuserParams,
    state,
    fmap,
    current_T,
    key,
    dist_moved,
    update_count,
    odom,
    ranges,
    hit,
    split_dist,
    max_nodes: int = 64,
    fm_incr: int = 4,
    link_source: str = "fuse",
):
    """FULLY device-resident online graph SLAM: the complete per-scan
    pipeline (feature detect + describe + RANSAC + joint fusion + map
    update) AND the node-split events run inside ONE executable over the
    whole (T, ...) sequence.  Frozen nodes are scattered into a
    pre-allocated node bank (static capacity `max_nodes`); the host sees
    nothing until the sequence ends.

    This is the device-resident shape of the reference's whole online node
    (publish_graph_message.cpp:1259-1628 + NDTFeatureGraph::update,
    ndt_feature_graph.cpp:60-144): where the reference pays a ROS
    callback per scan and heap allocation per node, we pay one dispatch
    per *sequence*.  The chunked driver (run_graph_chunk) remains for
    modes that need host work at splits (online loop closure).

    Split semantics match the host orchestrator exactly (same op order,
    same PRNG stream): the scan that trips `split_dist` is fused into
    the old node, the node is frozen with the incremental edge
    (motion-model covariance; rel from fused local pose or raw local
    odometry per `link_source`), and a fresh fuser seeded with that
    same scan opens the next node.  Split work runs under lax.cond —
    in a sequential lax.scan only the taken branch executes, so the
    expensive split math (full-grid finalize + cell compaction in
    freeze_node, the ray-scatter re-init, the bank scatter) is paid
    only on actual split scans, not every scan.

    state: FeatureFuserState (scan 0 already consumed by initialize);
    fmap: FeatureMapBuffer; current_T (3,) active node origin; key:
    PRNG key (advanced only at splits, like the host's _split_key);
    odom (T, 3); ranges (T, B); hit (T, B); split_dist f32.

    Returns (state, fmap, bank, node_T_bank (max_nodes, 3),
    edge_rel (max_nodes, 3), edge_cov (max_nodes, 3, 3), traj (T, 3)
    global poses, current_T (3,), key, meta (3,) =
    [dist_moved, update_count, n_frozen]).
    """
    from ndt_feature_graph_tpu.core import motion_model, se2
    from ndt_feature_graph_tpu.fusion import feature_fuser
    from ndt_feature_graph_tpu.graph import node as node_mod
    from ndt_feature_graph_tpu.io import dataset

    sp = state.base.sensor_pose
    fm_capacity = fmap.desc.shape[0]
    desc_dim = fmap.desc.shape[1]

    template = node_mod.empty_node(params, fm_capacity)
    bank = jax.tree.map(
        lambda x: jnp.zeros((max_nodes,) + x.shape, x.dtype), template
    )
    node_T_bank = jnp.zeros((max_nodes, 3), jnp.float32)
    edge_rel = jnp.zeros((max_nodes, 3), jnp.float32)
    edge_cov = jnp.zeros((max_nodes, 3, 3), jnp.float32)

    def body(carry, x):
        st, fm, dist, cnt, cur_T, k, nn, bank, nTb, erel, ecov = carry
        tm, r, h = x

        ns, info, _res = feature_fuser.update.__wrapped__(
            st, params, tm, r, h
        )
        pose_out = se2.compose(cur_T, ns.base.Tnow)
        dist2 = dist + jnp.linalg.norm(tm[:2])
        cnt2 = cnt + 1
        split = (dist2 > split_dist) & (nn + 1 < max_nodes)

        def no_split(op):
            (ns, fm, cur_T, k, nn, bank, nTb, erel, ecov, r, h) = op

            # Feature-map accumulate (every fm_incr-th update, not on
            # the split scan — run_graph_chunk semantics); itself
            # gated so the ring scatter runs 1-in-fm_incr scans.
            def ins(fm):
                return node_mod.insert_features.__wrapped__(
                    fm, ns.prev_feats, ns.prev_desc,
                    se2.compose(ns.base.Tnow, sp),
                )

            fm2 = jax.lax.cond(
                (cnt2 % fm_incr) == 0, ins, lambda f: f, fm
            )
            return (ns, fm2, dist2, cnt2, cur_T, k, nn,
                    bank, nTb, erel, ecov)

        def do_split(op):
            (ns, fm, cur_T, k, nn, bank, nTb, erel, ecov, r, h) = op
            frozen = node_mod.freeze_node.__wrapped__(
                params, cur_T, ns.base, fm
            )
            bank2 = jax.tree.map(
                lambda b, v: b.at[nn].set(v, mode="drop"), bank, frozen
            )
            nTb2 = nTb.at[nn].set(cur_T, mode="drop")
            rel = (ns.base.Todom if link_source == "odom"
                   else ns.base.Tnow)
            cov = motion_model.measurement_cov(params.motion, rel) + (
                jnp.diag(jnp.full(3, 1e-4))
            )
            erel2 = erel.at[nn].set(rel, mode="drop")
            ecov2 = ecov.at[nn].set(cov, mode="drop")
            new_T = se2.compose(cur_T, ns.base.Tnow)

            # Fresh fuser for the new node, seeded with this scan in
            # the node-local (identity) frame — _finish_split
            # semantics.  The detector/descriptor outputs for this
            # scan are already in ns.prev_feats/prev_desc
            # (deterministic), so only the base grid is rebuilt.
            k2, sub = jax.random.split(k)
            pts, mask = dataset.scan_to_points(r, h)
            base_new = fuser.initialize.__wrapped__(
                params, jnp.zeros(3), sp, pts, mask
            )
            st_new = feature_fuser.FeatureFuserState(
                base=base_new,
                prev_feats=ns.prev_feats,
                prev_desc=ns.prev_desc,
                prev_pose=jnp.zeros(3),
                key=sub,
            )
            fm_new = node_mod.insert_features.__wrapped__(
                node_mod.empty_feature_map(fm_capacity, desc_dim),
                ns.prev_feats, ns.prev_desc, sp,
            )
            return (st_new, fm_new, jnp.float32(0.0), jnp.int32(0),
                    new_T, k2, nn + 1, bank2, nTb2, erel2, ecov2)

        carry2 = jax.lax.cond(
            split, do_split, no_split,
            (ns, fm, cur_T, k, nn, bank, nTb, erel, ecov, r, h),
        )
        return carry2, pose_out

    init = (
        state, fmap, jnp.float32(dist_moved), jnp.int32(update_count),
        jnp.asarray(current_T, jnp.float32), key, jnp.int32(0),
        bank, node_T_bank, edge_rel, edge_cov,
    )
    (st, fm, dist, cnt, cur_T, k, nn, bank, nTb, erel, ecov), traj = (
        jax.lax.scan(body, init, (odom, ranges, hit))
    )
    meta = jnp.stack(
        [dist, cnt.astype(jnp.float32), nn.astype(jnp.float32)]
    )
    return st, fm, bank, nTb, erel, ecov, traj, cur_T, k, meta


@functools.partial(jax.jit, static_argnames=("m",))
def _unstack_m(bank, m: int):
    """Split the first `m` bank rows into per-node pytrees, one
    dispatch, outputs DEVICE-resident."""
    return tuple(
        jax.tree.map(lambda a, i=i: a[i], bank) for i in range(m)
    )


def unstack_bank(bank, n: int):
    """Split the first `n` rows of a stacked node bank into per-node
    pytrees that stay ON DEVICE.

    No host transfer: a node's grids are megabytes, and consumers that
    need host values ask for them explicitly.  The split count is
    rounded up to a power of two so at most log2(max_nodes) distinct
    executables ever compile (a static-n variant recompiled per
    distinct frozen-node count); per-leaf eager slicing would instead
    pay one dispatch per op."""
    if n <= 0:
        return ()
    cap = jax.tree.leaves(bank)[0].shape[0]
    m = 1
    while m < n:
        m *= 2
    m = min(m, cap)
    return _unstack_m(bank, m)[:n]


@functools.partial(jax.jit, static_argnames=("params",))
def run_sequence_features_batch(params: FuserParams, states, odom,
                                ranges, hit):
    """FULL-pipeline fleet variant: B independent streams of the
    feature-aware pipeline (detect + describe + RANSAC + joint
    NDT/feature/odometry fusion + map update), each a T-step sequence,
    inside ONE executable.

    states: batched FeatureFuserState (B, ...); odom: (B, T, 3);
    ranges: (B, T, num_beams); hit: (B, T, num_beams).
    Returns (final_states, trajectories (B, T, 3), scores (B, T)).

    The scan steps through feature_fuser.update_batch — the feature
    half under vmap (small per-stream arrays), the registration
    through the shared flat-bank batch-level Newton (fuser.
    update_batch).  This is the multi-robot serving shape of the
    reference's per-robot online node (publish_graph_message.cpp:
    1259-1628, one ROS process per robot).
    """
    from ndt_feature_graph_tpu.fusion import feature_fuser

    t = odom.shape[1]
    occ = _occ_flags(params, t)

    def body(sts, x):
        tm, r, h, oc = x
        ns, info, _res = feature_fuser.update_batch.__wrapped__(
            sts, params, tm, r, h, occ_on=oc
        )
        return ns, (ns.base.Tnow, info.score)

    finals, (traj, scores) = jax.lax.scan(
        body, states,
        (odom.swapaxes(0, 1), ranges.swapaxes(0, 1),
         hit.swapaxes(0, 1), occ),
    )
    return finals, traj.swapaxes(0, 1), scores.swapaxes(0, 1)


@functools.partial(jax.jit, static_argnames=("params",))
def run_sequence_batch(params: FuserParams, states, odom, pts, mask):
    """Fleet variant: B independent streams, each a T-step sequence.

    states: batched FuserState (B, ...); odom: (B, T, 3);
    pts: (B, T, P, 2); mask: (B, T, P).
    Returns (final_states, trajectories (B, T, 3), scores (B, T)).

    The scan steps through fuser.update_batch — per scan, every
    stream's registration gathers index ONE flat (B*H*W, 8) packed
    bank with per-stream row offsets, rather than vmap(run_sequence),
    which would batch the gather OPERAND (see fuser.update_batch).
    """

    t = odom.shape[1]
    occ = _occ_flags(params, t)

    def body(sts, x):
        tm, p, mk, oc = x
        ns, info = fuser.update_batch.__wrapped__(
            sts, params, tm, p, mk, occ_on=oc
        )
        return ns, (ns.Tnow, info.score)

    finals, (traj, scores) = jax.lax.scan(
        body, states,
        (odom.swapaxes(0, 1), pts.swapaxes(0, 1), mask.swapaxes(0, 1),
         occ),
    )
    return finals, traj.swapaxes(0, 1), scores.swapaxes(0, 1)


def _occ_flags(params: FuserParams, t: int):
    """Per-step occupancy-cadence flags for the batch drivers
    (config.FuserParams.occ_every)."""
    k = params.occ_every
    if k <= 1:
        return jnp.ones(t, bool)
    return (jnp.arange(t) % k) == 0
