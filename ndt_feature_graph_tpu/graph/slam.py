"""Graph-SLAM orchestrator: online submap chaining + offline
loop-closure optimization.

Host-side equivalent of NDTFeatureGraph (+Logger)
(ndt_feature_graph.cpp:24-144: distance-gated node splitting, per-node
fuser updates in the node-local frame) and of the offline optimizer CLI
(ndt_feature_graph_opt.cpp:29-210: all-pairs link proposal → D2D refine
→ validate → iterate iSAM until the valid-link set reaches a fixpoint).

The per-scan hot path stays fully jitted (feature_fuser.update); only
the rare node-split event and the offline phase run host-side control
flow.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ndt_feature_graph_tpu.config import GraphParams, FuserParams, SLAMParams
from ndt_feature_graph_tpu.core import motion_model, se2
from ndt_feature_graph_tpu.features.descriptor import descriptor_dim
from ndt_feature_graph_tpu.fusion import feature_fuser, fuser
from ndt_feature_graph_tpu.graph import links as links_mod
from ndt_feature_graph_tpu.graph import node as node_mod
from ndt_feature_graph_tpu.graph import optimize as opt_mod
from ndt_feature_graph_tpu.graph import sparse_direct as sparse_direct_mod

FEATURE_MAP_CAPACITY = 128


@functools.partial(jax.jit, static_argnames=("p", "link_source"))
def _split_math(p: FuserParams, link_source: str, current_T, base, fmap):
    """Device math of a node split in ONE executable: freeze the active
    fuser into NodeData and compute the incremental edge (new node
    origin, relative pose, motion-model covariance), packed into one
    (15,) vector so the host pays a single readback."""
    frozen = node_mod.freeze_node.__wrapped__(p, current_T, base, fmap)
    new_T = se2.compose(current_T, base.Tnow)
    rel = base.Todom if link_source == "odom" else base.Tnow
    cov = motion_model.measurement_cov(p.motion, rel) + jnp.diag(
        jnp.full(3, 1e-4)
    )
    packed = jnp.concatenate([new_T, rel, cov.reshape(-1)])
    return frozen, packed


@jax.jit
def _pack_link_outputs(link_set):
    """Pack a LinkSet's host-consumed fields (T, cov, score, mask) into
    one (C, 14) array so the orchestrator pays a single readback per
    proposal instead of four."""
    return jnp.concatenate(
        [
            link_set.T,
            link_set.cov.reshape(link_set.cov.shape[0], 9),
            link_set.score[:, None],
            link_set.mask[:, None].astype(jnp.float32),
        ],
        axis=1,
    )


@jax.jit
def _accumulate_math(fmap, prev_feats, prev_desc, Tnow, sensor_pose):
    """Feature-map insert incl. the node-frame pose compose, one
    executable (was one eager compose + one dispatch)."""
    node_pose = se2.compose(Tnow, sensor_pose)
    return node_mod.insert_features.__wrapped__(
        fmap, prev_feats, prev_desc, node_pose
    )


class NDTFeatureGraphSLAM:
    """Online graph builder.  Not a pytree — a thin host orchestrator
    over jitted kernels."""

    def __init__(self, params: SLAMParams, seed: int = 0):
        self.params = params
        self.nodes: List[node_mod.NodeData] = []   # frozen nodes
        self.node_T: List[np.ndarray] = []         # global pose per node
        self.odom_edges: List[tuple] = []          # (i, j, rel, cov)
        self.loop_links: List[tuple] = []          # (i, j, rel, cov, score)
        self.state: Optional[feature_fuser.FeatureFuserState] = None
        self.fmap = None
        self.current_T = np.zeros(3, np.float32)   # active node origin
        self.distance_moved = 0.0
        self.n_updates_in_node = 0
        self._key = jax.random.PRNGKey(seed)
        self.trajectory: List[np.ndarray] = []     # global pose log
        self.times: List[float] = []

    # ---------------- online ----------------

    def _split_key(self):
        self._key, sub = jax.random.split(self._key)
        return sub

    def initialize(self, init_pose, sensor_pose, ranges, hit, t=0.0):
        p = self.params.fuser
        self.current_T = np.asarray(init_pose, np.float32)
        # Fuser runs in the node-local frame (identity init), like
        # new_node.map->initialize(identity, ...) at graph.cpp:100-105.
        self.state = feature_fuser.initialize(
            p, jnp.zeros(3), jnp.asarray(sensor_pose, jnp.float32),
            ranges, hit, self._split_key(),
        )
        self.fmap = node_mod.empty_feature_map(
            FEATURE_MAP_CAPACITY, descriptor_dim(p.features)
        )
        self._accumulate_features()
        self.trajectory.append(self.current_T.copy())
        self.times.append(t)

    def _accumulate_features(self):
        """Insert the active scan's features into the node feature map
        (in node frame)."""
        st = self.state
        self.fmap = _accumulate_math(
            self.fmap, st.prev_feats, st.prev_desc, st.base.Tnow,
            st.base.sensor_pose,
        )

    def global_pose(self):
        return se2.compose_np(
            np.asarray(self.current_T, np.float32),
            np.asarray(self.state.base.Tnow, np.float32),
        )

    def update(self, Tmotion, ranges, hit, t=0.0):
        """One scan (NDTFeatureGraph::update, graph.cpp:60-144)."""
        p = self.params.fuser
        gp = self.params.graph
        self.distance_moved += float(
            np.linalg.norm(np.asarray(Tmotion, np.float32)[:2])
        )
        Tmotion = jnp.asarray(Tmotion, jnp.float32)

        if self.distance_moved > gp.new_node_transl_dist and (
            len(self.nodes) + 1 < gp.max_nodes
        ):
            self._split_node(Tmotion, ranges, hit)
        else:
            self.state, info, res = feature_fuser.update(
                self.state, p, Tmotion, ranges, hit
            )
            self.n_updates_in_node += 1
            if (
                self.n_updates_in_node % p.feature_map_update_incr == 0
            ):
                self._accumulate_features()

        pose = self.global_pose()
        self.trajectory.append(pose)
        self.times.append(t)
        return pose

    def run_sequence_chunked(self, odom, ranges, hit, times=None,
                             chunk: int = 16):
        """Process a whole gated scan sequence with the device-resident
        graph driver (fusion/scan_driver.run_graph_chunk): K scans per
        dispatch, split events handled host-side — semantically
        identical to calling update() per scan (same op order, same
        PRNG stream), without the per-scan host dispatch.

        odom (T, 3), ranges (T, B), hit (T, B) — scan 0 must already be
        consumed by initialize().  Returns the global trajectory that
        update() would have produced for scans 1..T-1.
        """
        from ndt_feature_graph_tpu.fusion import scan_driver

        p = self.params.fuser
        gp = self.params.graph
        t_total = ranges.shape[0]
        times = times if times is not None else [0.0] * t_total
        odom = jnp.asarray(odom, jnp.float32)
        t = 1
        while t < t_total:
            k = min(chunk, t_total - t)
            sl = slice(t, t + k)
            pad = chunk - k
            odom_c = jnp.concatenate(
                [odom[sl], jnp.zeros((pad, 3), jnp.float32)]
            )
            ranges_c = jnp.concatenate(
                [ranges[sl], jnp.zeros((pad,) + ranges.shape[1:],
                                       ranges.dtype)]
            )
            hit_c = jnp.concatenate(
                [hit[sl], jnp.zeros((pad,) + hit.shape[1:], bool)]
            )
            active = jnp.arange(chunk) < k
            # At node capacity the reference just keeps fusing into the
            # last node — disable splits by pushing the threshold out.
            can_split = len(self.nodes) + 1 < gp.max_nodes
            split_dist = jnp.float32(
                gp.new_node_transl_dist if can_split else jnp.inf
            )
            st, fm, traj, _scores, meta = scan_driver.run_graph_chunk(
                p, self.state, self.fmap,
                jnp.float32(self.distance_moved),
                jnp.int32(self.n_updates_in_node),
                odom_c, ranges_c, hit_c, active, split_dist,
                fm_incr=p.feature_map_update_incr,
            )
            # Two readbacks per chunk (traj + packed meta); all the
            # per-scan global-pose bookkeeping is pure numpy — no
            # per-scan device ops.
            traj_np = np.asarray(traj)
            meta_np = np.asarray(meta)
            n_proc = int(meta_np[2])
            split_idx = int(meta_np[3])
            split = split_idx >= 0
            self.state = st
            self.fmap = fm
            self.distance_moved = float(meta_np[0])
            self.n_updates_in_node = int(meta_np[1])
            cur = np.asarray(self.current_T, np.float32)
            for i in range(n_proc):
                self.trajectory.append(se2.compose_np(cur, traj_np[i]))
                self.times.append(times[t + i])
            if split:
                # The chunk fused the split scan into the old node;
                # freeze + re-seed with that same scan (graph.cpp:
                # 72-117 semantics, matching _split_node).
                self._finish_split(ranges[t + split_idx],
                                   hit[t + split_idx])
                t += split_idx + 1
            else:
                t += n_proc
        return np.stack(self.trajectory)

    def run_sequence_device(self, odom, ranges, hit, times=None):
        """Process a whole gated scan sequence with the FULLY
        device-resident graph driver (fusion/scan_driver.
        run_graph_sequence): one dispatch for the entire sequence,
        node splits handled on device into a pre-allocated bank —
        semantically identical to update() per scan (same op order,
        same PRNG stream).  Requires online_loop_closure off (use
        run_sequence_chunked for that mode) and an empty graph.

        odom (T, 3), ranges (T, B), hit (T, B) — scan 0 must already
        be consumed by initialize().  Returns the global trajectory
        for scans 1..T-1 (plus the initial pose already logged).
        """
        from ndt_feature_graph_tpu.fusion import scan_driver

        if self.params.graph.online_loop_closure:
            raise ValueError(
                "run_sequence_device does not handle online loop "
                "closure; use run_sequence_chunked"
            )
        if self.nodes:
            raise ValueError("run_sequence_device requires a fresh graph")
        p = self.params.fuser
        gp = self.params.graph
        t_total = ranges.shape[0]
        times = times if times is not None else [0.0] * t_total

        (st, fm, bank, nTb, erel, ecov, traj, cur_T, key, meta) = (
            scan_driver.run_graph_sequence(
                p, self.state, self.fmap,
                jnp.asarray(self.current_T, jnp.float32), self._key,
                jnp.float32(self.distance_moved),
                jnp.int32(self.n_updates_in_node),
                jnp.asarray(odom[1:], jnp.float32), ranges[1:], hit[1:],
                jnp.float32(gp.new_node_transl_dist),
                max_nodes=gp.max_nodes,
                fm_incr=p.feature_map_update_incr,
                link_source=gp.incremental_link_source,
            )
        )
        meta_np = np.asarray(meta)
        n_frozen = int(meta_np[2])
        self.state = st
        self.fmap = fm
        self._key = key
        self.distance_moved = float(meta_np[0])
        self.n_updates_in_node = int(meta_np[1])
        self.current_T = np.asarray(cur_T)

        base = len(self.nodes)
        if n_frozen:
            nodes = scan_driver.unstack_bank(bank, n_frozen)
            nT_np = np.asarray(nTb[:n_frozen])
            erel_np = np.asarray(erel[:n_frozen])
            ecov_np = np.asarray(ecov[:n_frozen])
            for i in range(n_frozen):
                self.nodes.append(nodes[i])
                self.node_T.append(nT_np[i].copy())
                self.odom_edges.append(
                    (base + i, base + i + 1, erel_np[i], ecov_np[i])
                )
        traj_np = np.asarray(traj)
        for i in range(t_total - 1):
            self.trajectory.append(traj_np[i])
            self.times.append(times[1 + i])
        return np.stack(self.trajectory)

    def _finish_split(self, ranges, hit):
        """Host bookkeeping of a node split AFTER the split scan has
        been fused into the active node (shared by _split_node and the
        chunked driver)."""
        p = self.params.fuser
        self.distance_moved = 0.0
        node_idx = len(self.nodes)
        # One jitted executable for the whole split's device math
        # (freeze + edge pose/cov), one packed transfer for the small
        # host-side numbers: every eager op and every readback is a
        # dispatch or a sync.
        frozen, packed = _split_math(
            p,
            self.params.graph.incremental_link_source,
            jnp.asarray(self.current_T),
            self.state.base,
            self.fmap,
        )
        self.nodes.append(frozen)
        self.node_T.append(self.current_T.copy())
        packed = np.asarray(packed)
        new_T = packed[:3]
        rel = packed[3:6]
        cov = packed[6:].reshape(3, 3)
        self.odom_edges.append((node_idx, node_idx + 1, rel, cov))

        self.current_T = new_T
        self.state = feature_fuser.initialize(
            p, jnp.zeros(3), self.state.base.sensor_pose, ranges, hit,
            self._split_key(),
        )
        self.fmap = node_mod.empty_feature_map(
            FEATURE_MAP_CAPACITY, descriptor_dim(p.features)
        )
        self._accumulate_features()
        self.n_updates_in_node = 0
        if self.params.graph.online_loop_closure:
            self._try_online_loop_closure()

    def _split_node(self, Tmotion, ranges, hit):
        """Freeze the active node, chain a new one (graph.cpp:72-117):
        last update into the old node, then the shared split
        bookkeeping (incremental edge from the fused local pose or raw
        local odometry — getAllIncrementalFuseLinks /
        getAllIncrementalOdomLinks, ndt_feature_graph.cpp:180-258 —
        with motion-model covariance; fresh fuser seeded with this
        scan)."""
        p = self.params.fuser
        self.state, info, res = feature_fuser.update(
            self.state, p, Tmotion, ranges, hit
        )
        self._finish_split(ranges, hit)

    # ---------------- online loop closure ----------------
    #
    # Extension beyond the reference (which closes loops offline only,
    # ndt_feature_graph_opt.cpp:29-210): on each node split, propose
    # links from the just-frozen node to nearby earlier nodes using the
    # same feature-RANSAC -> D2D-refine -> overlap-validate pipeline,
    # then re-solve the (small) pose graph incrementally.  All device
    # work runs at static shapes (online_lc_max_candidates pairs,
    # max_nodes poses, fixed edge capacity) so it compiles once.

    def _try_online_loop_closure(self):
        gp = self.params.graph
        p = self.params.fuser
        k = len(self.nodes) - 1            # just-frozen node
        if k < gp.valid_min_idx_dist:
            return
        Tk = self.node_T[k]
        cands = [
            (float(np.linalg.norm(self.node_T[i][:2] - Tk[:2])), i)
            for i in range(k - gp.valid_min_idx_dist + 1)
        ]
        cands = sorted(
            c for c in cands if c[0] <= gp.online_lc_candidate_dist
        )[: gp.online_lc_max_candidates]
        if not cands:
            return
        cand_idx = [i for (_, i) in cands]

        C = gp.online_lc_max_candidates
        # Static-size local stack: C candidate slots (padded with node
        # k itself, masked out) + the new node in slot C.
        sel = cand_idx + [k] * (C - len(cand_idx)) + [k]
        stacked = node_mod.stack_nodes([self.nodes[i] for i in sel])
        ref = jnp.arange(C, dtype=jnp.int32)
        mov = jnp.full(C, C, jnp.int32)
        mask = jnp.asarray(
            [m < len(cand_idx) for m in range(C)], bool
        )
        link_set = links_mod.compute_links_batch(
            p.features, p.ndt.resolution, stacked, ref, mov, mask,
            self._split_key(),
        )
        link_set = links_mod.refine_links_d2d(
            p.ndt, p.matcher, stacked, link_set,
            src_budget=links_mod.source_cell_budget(stacked),
        )
        link_set = links_mod.rescore_links(
            p.ndt.resolution, stacked, link_set
        )

        # Host-side validation against the current global estimates
        # (getValidLinks gates, ndt_feature_graph.cpp:527-556).  ONE
        # packed readback instead of separate pulls of T/cov/score/
        # mask.
        packed = np.asarray(_pack_link_outputs(link_set))
        T = packed[:, :3]
        cov = packed[:, 3:12].reshape(-1, 3, 3)
        score = packed[:, 12]
        ok = packed[:, 13] > 0.5
        accepted = False
        for m, i in enumerate(cand_idx):
            if not ok[m] or score[m] > gp.valid_max_score:
                continue
            expected = np.asarray(
                se2.sub(jnp.asarray(self.node_T[i]), jnp.asarray(Tk))
            )
            d = np.linalg.norm(T[m, :2] - expected[:2])
            a = abs(
                float(se2.normalize_angle(T[m, 2] - expected[2]))
            )
            if d > gp.valid_max_dist or a > gp.valid_max_angular_dist:
                continue
            self.loop_links.append((i, k, T[m], cov[m], score[m]))
            accepted = True
        if accepted:
            self._solve_incremental()

    def _solve_incremental(self):
        """Re-solve the pose graph over frozen-node origins + the
        active-node origin, at static (max_nodes, edge-capacity)
        shapes."""
        gp = self.params.graph
        n = len(self.nodes)
        cap_n = gp.max_nodes + 1
        cap_e = gp.max_nodes + gp.max_links
        poses = np.zeros((cap_n, 3), np.float32)
        poses[:n] = np.stack(self.node_T)
        poses[n] = self.current_T          # active-node origin
        e_i = np.zeros(cap_e, np.int32)
        e_j = np.zeros(cap_e, np.int32)
        e_meas = np.zeros((cap_e, 3), np.float32)
        e_info = np.zeros((cap_e, 3, 3), np.float32)
        e_mask = np.zeros(cap_e, bool)
        e_odom = np.zeros(cap_e, bool)
        edges = [
            (i, j, rel, opt_mod.spd_info_np(cov), True)
            for (i, j, rel, cov) in self.odom_edges
        ] + [
            (i, j, rel,
             opt_mod.spd_info_np(cov, eps=gp.link_info_eps), False)
            for (i, j, rel, cov, _s) in self.loop_links
        ]
        ne = min(len(edges), cap_e)
        for idx in range(ne):
            i, j, rel, info, odo = edges[idx]
            e_i[idx], e_j[idx] = i, j
            e_meas[idx] = rel
            e_info[idx] = info
            e_mask[idx] = True
            e_odom[idx] = odo
        edge_list = opt_mod.EdgeList(
            i=jnp.asarray(e_i),
            j=jnp.asarray(e_j),
            meas=jnp.asarray(e_meas),
            info=jnp.asarray(e_info),
            mask=jnp.asarray(e_mask),
            is_odom=jnp.asarray(e_odom),
        )
        out, _chi2 = opt_mod.optimize(
            jnp.asarray(poses),
            edge_list,
            prior_information=gp.prior_information,
            iterations=gp.online_lc_gn_iterations,
            damping=gp.gn_damping,
            robust_kernel=gp.online_lc_robust_kernel,
            robust_delta=gp.robust_delta,
        )
        out = np.asarray(out)
        self.node_T = [out[i].copy() for i in range(n)]
        self.current_T = out[n].copy()

    def finalize_current_node(self):
        """Freeze the active node without starting a new one (end of
        sequence)."""
        p = self.params.fuser
        frozen = node_mod.freeze_node(
            p, jnp.asarray(self.current_T), self.state.base, self.fmap
        )
        self.nodes.append(frozen)
        self.node_T.append(np.asarray(self.current_T))

    # ---------------- offline ----------------

    def candidate_pairs(self):
        """Node pairs (i < j) with index distance >= the validation
        minimum — padded arrays.  When gp.offline_candidate_dist > 0,
        pairs are additionally gated by the Euclidean distance between
        the current global node estimates (scalability gate — the
        validation step would reject distant pairs anyway via
        valid_max_dist, so gating candidates only skips work that could
        never survive getValidLinks, ndt_feature_graph.cpp:527-556)."""
        gp = self.params.graph
        n = len(self.nodes)
        if gp.offline_candidate_dist > 0 and n > 1:
            pos = np.stack(self.node_T)[:, :2]
            d2 = ((pos[:, None, :] - pos[None, :, :]) ** 2).sum(-1)
            near = d2 <= gp.offline_candidate_dist ** 2
            pairs = [
                (i, j)
                for i in range(n)
                for j in range(i + gp.valid_min_idx_dist, n)
                if near[i, j]
            ]
        else:
            pairs = [
                (i, j)
                for i in range(n)
                for j in range(i + 1, n)
                if j - i >= gp.valid_min_idx_dist
            ]
        cap = max(len(pairs), 1)
        ref = np.zeros(cap, np.int32)
        mov = np.zeros(cap, np.int32)
        mask = np.zeros(cap, bool)
        for k, (i, j) in enumerate(pairs):
            ref[k], mov[k], mask[k] = i, j, True
        return jnp.asarray(ref), jnp.asarray(mov), jnp.asarray(mask)

    def _propose_links(self, stacked, ref, mov, mask):
        """Propose -> D2D-refine -> rescore candidate links.  With
        gp.link_batch_size > 0 the padded pair list is processed in
        fixed-size chunks (each chunk one dispatch of the same compiled
        executables — bounded device memory at any candidate count);
        otherwise one batch over all pairs.  With gp.link_group_nodes
        > 0, chunks are additionally closed when they would reference
        more than that many distinct nodes, and each chunk runs
        against a compact gathered sub-bank — bounding the refine
        gathers' working set at any graph size (see
        config.GraphParams.link_group_nodes)."""
        p = self.params.fuser
        gp = self.params.graph
        budget = links_mod.source_cell_budget(stacked)

        def run(stk, ref_c, mov_c, mask_c):
            ls = links_mod.compute_links_batch(
                p.features, p.ndt.resolution, stk, ref_c, mov_c,
                mask_c, self._split_key(),
            )
            ls = links_mod.refine_links_d2d(
                p.ndt, p.matcher, stk, ls, src_budget=budget
            )
            return links_mod.rescore_links(
                p.ndt.resolution, stk, ls
            )

        n = int(ref.shape[0])
        B = gp.link_batch_size
        if B <= 0 or n <= B:
            return run(stacked, ref, mov, mask)

        if gp.link_group_nodes > 0:
            # A chunk's first pair is admitted unconditionally and can
            # reference 2 distinct nodes, so the grouped path's static
            # sub-bank shape requires group_nodes >= 2 (ADVICE round
            # 4: a sub-bank larger than the static shape breaks the
            # one-compile-per-chunk contract).
            group_nodes = max(2, gp.link_group_nodes)
            return self._propose_links_grouped(
                stacked, ref, mov, mask, run, B, group_nodes
            )

        pad = (-n) % B
        ref_p = jnp.concatenate([ref, jnp.zeros(pad, jnp.int32)])
        mov_p = jnp.concatenate([mov, jnp.zeros(pad, jnp.int32)])
        mask_p = jnp.concatenate([mask, jnp.zeros(pad, bool)])
        chunks = [
            run(stacked, ref_p[c: c + B], mov_p[c: c + B],
                mask_p[c: c + B])
            for c in range(0, n + pad, B)
        ]
        return jax.tree.map(
            lambda *xs: jnp.concatenate(xs)[:n], *chunks
        )

    def _propose_links_grouped(self, stacked, ref, mov, mask, run,
                               batch: int, group_nodes: int):
        """Locality-grouped chunking for _propose_links: consecutive
        pairs accumulate until the chunk holds `batch` pairs or would
        reference more than `group_nodes` distinct nodes; the chunk
        then runs against a compact sub-bank of exactly those nodes
        (static (group_nodes, ...) shapes -> one compile for every
        chunk).  Pair order is preserved, outputs carry GLOBAL node
        indices."""
        ref_np = np.asarray(ref)
        mov_np = np.asarray(mov)
        mask_np = np.asarray(mask)
        n = ref_np.shape[0]

        # Consecutive grouping (candidate lists are locality-sorted).
        bounds = []           # (start, end) pair ranges
        start = 0
        nodes_in: set = set()
        for k in range(n):
            new = (
                {int(ref_np[k]), int(mov_np[k])} - nodes_in
                if mask_np[k] else set()
            )
            if k > start and (
                k - start >= batch
                or len(nodes_in) + len(new) > group_nodes
            ):
                bounds.append((start, k))
                start = k
                nodes_in = set()
                new = (
                    {int(ref_np[k]), int(mov_np[k])}
                    if mask_np[k] else set()
                )
            nodes_in |= new
        bounds.append((start, n))

        outs = []
        for (s, e) in bounds:
            uniq = sorted(
                {int(ref_np[k]) for k in range(s, e) if mask_np[k]}
                | {int(mov_np[k]) for k in range(s, e) if mask_np[k]}
            ) or [0]
            local = {g: i for i, g in enumerate(uniq)}
            # Pad the node list to the static group size and the pair
            # slice to the static batch size.  The chunk builder closes
            # chunks before they exceed group_nodes (>= 2 enforced by
            # the caller); a violation here would silently change the
            # static sub-bank shape and recompile per chunk.
            assert len(uniq) <= group_nodes, (len(uniq), group_nodes)
            sel = uniq + [uniq[0]] * (group_nodes - len(uniq))
            sub = jax.tree.map(
                lambda x: x[jnp.asarray(sel, jnp.int32)], stacked
            )
            cnt = e - s
            ref_c = np.zeros(batch, np.int32)
            mov_c = np.zeros(batch, np.int32)
            mask_c = np.zeros(batch, bool)
            for k in range(s, e):
                if mask_np[k]:
                    ref_c[k - s] = local[int(ref_np[k])]
                    mov_c[k - s] = local[int(mov_np[k])]
                    mask_c[k - s] = True
            ls = run(
                sub, jnp.asarray(ref_c), jnp.asarray(mov_c),
                jnp.asarray(mask_c),
            )
            # Back to global indices, original pair order and mask.
            outs.append(
                ls._replace(
                    ref=ref[s:e],
                    mov=mov[s:e],
                    T=ls.T[:cnt],
                    cov=ls.cov[:cnt],
                    score=ls.score[:cnt],
                    mask=ls.mask[:cnt] & mask[s:e],
                )
            )
        return jax.tree.map(lambda *xs: jnp.concatenate(xs), *outs)

    def _edges_from(self, link_set, link_keep, node_T):
        """Combine odometry edges + kept loop-closure links + links
        accepted by the ONLINE loop-closure pass into an EdgeList (the
        iSAM bridge adds odometry links first, then valid links,
        ndt_offline_mapper.h:74-93).  Online closures passed their own
        (tighter) acceptance gates already; dropping them here would
        silently discard information whenever the offline all-pairs
        candidate gates differ — so they are
        added too, deduplicated against same-pair offline links."""
        e_i, e_j, e_meas, e_info, e_odom = [], [], [], [], []
        n = len(self.nodes)
        for (i, j, rel, cov) in self.odom_edges:
            if j >= n:
                continue  # dangling edge: current node never frozen
            e_i.append(i)
            e_j.append(j)
            e_meas.append(rel)
            e_info.append(opt_mod.spd_info_np(cov))
            e_odom.append(True)
        kept_pairs = set()
        if link_set is not None:
            keep = np.asarray(link_keep)
            link_T = np.asarray(link_set.T)
            link_cov = np.asarray(link_set.cov)
            link_ref = np.asarray(link_set.ref)
            link_mov = np.asarray(link_set.mov)
            for k in range(keep.shape[0]):
                if not keep[k]:
                    continue
                # Link T maps mov-node frame -> ref-node frame: that IS
                # the pose of mov in ref's frame.
                ri, mi = int(link_ref[k]), int(link_mov[k])
                kept_pairs.add((ri, mi))
                e_i.append(ri)
                e_j.append(mi)
                e_meas.append(link_T[k])
                e_info.append(
                    opt_mod.spd_info_np(
                        link_cov[k], eps=self.params.graph.link_info_eps
                    )
                )
                e_odom.append(False)
        for (i, j, rel, cov, _s) in self.loop_links:
            if j >= n or (i, j) in kept_pairs or (j, i) in kept_pairs:
                continue
            e_i.append(i)
            e_j.append(j)
            e_meas.append(np.asarray(rel))
            e_info.append(
                opt_mod.spd_info_np(
                    np.asarray(cov), eps=self.params.graph.link_info_eps
                )
            )
            e_odom.append(False)
        e = len(e_i)
        return opt_mod.EdgeList(
            i=jnp.asarray(np.asarray(e_i, np.int32)),
            j=jnp.asarray(np.asarray(e_j, np.int32)),
            meas=jnp.asarray(np.asarray(e_meas, np.float32)),
            info=jnp.asarray(np.asarray(e_info, np.float32)),
            mask=jnp.ones(e, bool),
            is_odom=jnp.asarray(np.asarray(e_odom, bool)),
        )

    def _solve(self, gp, node_T, edges, robust_delta=None):
        """Solver dispatch: dense Cholesky for small graphs, exact
        segment-Schur (O(E) memory, graph/sparse_direct.py) beyond
        gp.solver_dense_max_nodes or when gp.solver == "direct"."""
        n = int(node_T.shape[0])
        delta = gp.robust_delta if robust_delta is None else robust_delta
        use_direct = gp.solver == "direct" or (
            gp.solver == "auto" and n > gp.solver_dense_max_nodes
        )
        if use_direct:
            part = sparse_direct_mod.make_segments(
                n, edges, max_seg_len=gp.solver_max_seg_len
            )
            return sparse_direct_mod.optimize_direct(
                node_T,
                edges,
                part,
                prior_information=gp.prior_information,
                iterations=gp.gn_iterations,
                damping=gp.gn_damping,
                robust_kernel=gp.robust_kernel,
                robust_delta=delta,
            )
        return opt_mod.optimize(
            node_T,
            edges,
            prior_information=gp.prior_information,
            iterations=gp.gn_iterations,
            damping=gp.gn_damping,
            robust_kernel=gp.robust_kernel,
            robust_delta=delta,
        )

    def optimize_offline(self, verbose=False):
        """Full offline pipeline (ndt_feature_graph_opt.cpp:91-210):
        all-pairs feature links → D2D refine → rescore → fixpoint loop
        {validate → solve}.  Returns optimized node poses (N, 3)."""
        p = self.params.fuser
        gp = self.params.graph
        if len(self.nodes) < 2:
            return jnp.asarray(np.stack(self.node_T))

        stacked = node_mod.stack_nodes(self.nodes)
        ref, mov, mask = self.candidate_pairs()
        link_set = self._propose_links(stacked, ref, mov, mask)

        node_T = jnp.asarray(np.stack(self.node_T))
        prev_keep = None
        for round_idx in range(gp.fixpoint_max_rounds):
            # Graduated schedule (config.GraphParams): round 0
            # validates with drift-tolerant gates and a tight DCS Phi
            # (protect the solve from wrong-basin links); later rounds
            # re-validate against the solved estimates with tight
            # gates and a relaxed Phi so correct links regain full
            # quadratic weight.
            gp_gate = gp
            delta = None
            if round_idx >= 1:
                if gp.valid_max_dist_refine > 0:
                    gp_gate = gp.replace(
                        valid_max_dist=gp.valid_max_dist_refine,
                        valid_max_angular_dist=(
                            gp.valid_max_angular_refine
                        ),
                    )
                if gp.robust_delta_refine > 0:
                    delta = gp.robust_delta_refine
            keep = links_mod.valid_links(gp_gate, node_T, link_set)
            keep_np = np.asarray(keep)
            if verbose:
                print(
                    f"fixpoint round {round_idx}: "
                    f"{int(keep_np.sum())} valid links"
                )
            if prev_keep is not None and (keep_np == prev_keep).all():
                break
            prev_keep = keep_np
            edges = self._edges_from(link_set, keep_np, node_T)
            node_T, chi2 = self._solve(gp, node_T, edges,
                                       robust_delta=delta)
        self.node_T = [np.asarray(t) for t in np.asarray(node_T)]
        return node_T

    def optimized_trajectory(self):
        """Node-origin trajectory after optimization."""
        return np.stack(self.node_T)

    # ---------------- checkpointing ----------------

    def save(self, path):
        """Checkpoint the frozen graph (nodes + edges + trajectory) to
        one npz (the .jff/.feat/.T + NDTGraphMsg equivalent,
        SURVEY.md §5 checkpoint/resume)."""
        from ndt_feature_graph_tpu.io import serialize

        if not self.nodes:
            raise ValueError("nothing to save: no frozen nodes")
        odom = self.odom_edges or [(0, 0, np.zeros(3), np.eye(3))]
        tree = {
            "nodes": node_mod.stack_nodes(self.nodes),
            "node_T": jnp.asarray(np.stack(self.node_T)),
            "odom_i": jnp.asarray([e[0] for e in odom], jnp.int32),
            "odom_j": jnp.asarray([e[1] for e in odom], jnp.int32),
            "odom_rel": jnp.asarray(
                np.stack([e[2] for e in odom]), jnp.float32
            ),
            "odom_cov": jnp.asarray(
                np.stack([e[3] for e in odom]), jnp.float32
            ),
            "n_odom": jnp.int32(len(self.odom_edges)),
            "trajectory": jnp.asarray(np.stack(self.trajectory)),
            "times": jnp.asarray(np.asarray(self.times, np.float32)),
        }
        # The packed table IS the node target's storage now
        # (PackedTarget, round 5) — saved directly.  Checkpoints from
        # before the slim target (they stored means/covs/valid and
        # excluded packed) still load: serialize.derive_packed
        # rebuilds the packed leaf from the stored siblings.
        serialize.save_pytree(path, tree)

    @classmethod
    def load(cls, path, params: SLAMParams):
        """Rebuild a graph (offline-phase capable) from a checkpoint."""
        from ndt_feature_graph_tpu.io import serialize
        import numpy as _np

        data = _np.load(path)
        n_nodes = data["node_T"].shape[0]
        n_odom = int(data["n_odom"])
        template_node = node_mod.empty_node(
            params.fuser, FEATURE_MAP_CAPACITY
        )
        stacked_template = jax.tree.map(
            lambda x: jnp.stack([x] * n_nodes), template_node
        )
        n_edges = data["odom_i"].shape[0]
        template = {
            "nodes": stacked_template,
            "node_T": jnp.zeros((n_nodes, 3)),
            "odom_i": jnp.zeros(n_edges, jnp.int32),
            "odom_j": jnp.zeros(n_edges, jnp.int32),
            "odom_rel": jnp.zeros((n_edges, 3)),
            "odom_cov": jnp.zeros((n_edges, 3, 3)),
            "n_odom": jnp.int32(0),
            "trajectory": jnp.zeros(
                (data["trajectory"].shape[0], 3)
            ),
            "times": jnp.zeros(data["times"].shape[0]),
        }
        tree = serialize.load_pytree(
            path, template, derive=serialize.derive_packed
        )

        slam = cls(params)
        stacked = tree["nodes"]
        slam.nodes = [
            jax.tree.map(lambda x, k=k: x[k], stacked)
            for k in range(n_nodes)
        ]
        slam.node_T = [
            np.asarray(t) for t in np.asarray(tree["node_T"])
        ]
        slam.odom_edges = [
            (
                int(tree["odom_i"][k]),
                int(tree["odom_j"][k]),
                np.asarray(tree["odom_rel"][k]),
                np.asarray(tree["odom_cov"][k]),
            )
            for k in range(n_odom)
        ]
        slam.trajectory = [
            np.asarray(t) for t in np.asarray(tree["trajectory"])
        ]
        slam.times = list(np.asarray(tree["times"]))
        return slam
