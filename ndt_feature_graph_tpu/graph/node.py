"""Frozen submap node data (NDTFeatureNode equivalent,
ndt_feature_node.h:38-257).

A node is one completed submap: its global pose `T`, the fuser's local
odometry/fusion poses, the finalized NDT fields (dense, for use as a
registration *target*), the compacted gaussian cell list (for use as a
registration *source*), occupancy, and the accumulated node feature map
(NDTFeatureMap, ndt_feature_map.h:51-122).  All device arrays, uniform
shapes across nodes so node sets stack into (N, ...) batches for
vmapped link proposal.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ndt_feature_graph_tpu.config import FuserParams
from ndt_feature_graph_tpu.features.detector import FeatureSet
from ndt_feature_graph_tpu.fusion import fuser as fuser_mod
from ndt_feature_graph_tpu.ops import d2d, ndt_map


class NodeData(NamedTuple):
    T: jnp.ndarray             # (3,) node frame -> global
    Tlocal_odom: jnp.ndarray   # (3,)
    Tlocal_fuse: jnp.ndarray   # (3,)
    target: d2d.PackedTarget   # packed NDT registration table (node
                               # frame); unpack via d2d.dense_from_packed
    cells: ndt_map.CellList    # compacted gaussians (node frame)
    occ_origin: jnp.ndarray    # (2,)
    occ: jnp.ndarray           # (H, W) log-odds
    feats: FeatureSet          # node feature map (node frame), cap FM
    desc: jnp.ndarray          # (FM, D)


class FeatureMapBuffer(NamedTuple):
    """Fixed-capacity accumulated feature map for the active node
    (NDTFeatureMap::update appends every 4th scan,
    ndt_feature_map.h:64)."""

    feats: FeatureSet          # (FM, ...) node-frame interest points
    desc: jnp.ndarray          # (FM, D)
    write_idx: jnp.ndarray     # int32 ring pointer


def empty_feature_map(capacity: int, desc_dim: int) -> FeatureMapBuffer:
    return FeatureMapBuffer(
        feats=FeatureSet(
            pts=jnp.zeros((capacity, 2)),
            angles=jnp.zeros(capacity),
            scales=jnp.ones(capacity),
            response=jnp.zeros(capacity),
            mask=jnp.zeros(capacity, bool),
        ),
        desc=jnp.full((capacity, desc_dim), 0.5),
        write_idx=jnp.int32(0),
    )


@jax.jit
def insert_features(
    buf: FeatureMapBuffer, feats: FeatureSet, desc, node_pose
):
    """Append one scan's features (sensor frame) into the node feature
    map, transformed by `node_pose` (vehicle-in-node ∘ sensor pose).
    Ring-buffer overwrite beyond capacity."""
    moved = feats.transform(node_pose)
    f = feats.mask.shape[0]
    cap = buf.feats.mask.shape[0]
    # Target slots: ring positions for each incoming feature; invalid
    # incoming features write to their own old position (no-op merge by
    # writing existing content is not possible, so route them to a
    # scratch slot scheme: write only where incoming mask is set, by
    # keeping old values otherwise).
    slots = (buf.write_idx + jnp.arange(f)) % cap

    def scatter(old, new):
        upd = old.at[slots].set(jnp.where(
            feats.mask.reshape((f,) + (1,) * (new.ndim - 1)),
            new,
            old[slots],
        ))
        return upd

    new_feats = FeatureSet(
        pts=scatter(buf.feats.pts, moved.pts),
        angles=scatter(buf.feats.angles, moved.angles),
        scales=scatter(buf.feats.scales, moved.scales),
        response=scatter(buf.feats.response, moved.response),
        mask=scatter(buf.feats.mask, moved.mask),
    )
    new_desc = scatter(buf.desc, desc)
    n_in = jnp.sum(feats.mask).astype(jnp.int32)
    return FeatureMapBuffer(
        feats=new_feats,
        desc=new_desc,
        write_idx=(buf.write_idx + n_in) % cap,
    )


@functools.partial(jax.jit, static_argnames=("params",))
def freeze_node(
    params: FuserParams,
    node_T,
    fstate: fuser_mod.FuserState,
    fmap: FeatureMapBuffer,
) -> NodeData:
    """Archive the active fuser into an immutable NodeData.

    Jitted: a node split is a host-visible event, and running the
    finalize/compaction math eagerly would cost dozens of dispatches
    per split instead of one executable."""
    # The fuser maintains the packed registration table incrementally
    # (invariant: fstate.packed == make_dense_target(grid).packed) —
    # archive it directly; no full-grid re-finalize at the split.
    target = d2d.PackedTarget(
        origin=fstate.grid.origin, packed=fstate.packed
    )
    cells = ndt_map.to_cell_list(fstate.grid, params.ndt)
    return NodeData(
        T=jnp.asarray(node_T, jnp.float32),
        Tlocal_odom=fstate.Todom,
        Tlocal_fuse=fstate.Tnow,
        target=target,
        cells=cells,
        occ_origin=fstate.grid.origin,
        occ=fstate.grid.occ,
        feats=fmap.feats,
        desc=fmap.desc,
    )


def _stack_nodes_jit(*nodes):
    return jax.tree.map(lambda *xs: jnp.stack(xs), *nodes)


_stack_nodes_jit = jax.jit(_stack_nodes_jit)


def stack_nodes(nodes: list) -> NodeData:
    """Stack a host-side node list into (N, ...) batched NodeData.

    ONE jitted dispatch (compiled per node count) instead of one eager
    device op per leaf (~17); the online-loop-closure candidate stack
    has a static C+1 size, so it compiles once."""
    return _stack_nodes_jit(*nodes)


def empty_node(params: FuserParams, fm_capacity: int) -> NodeData:
    """Shape template for (de)serialization."""
    from ndt_feature_graph_tpu.features.descriptor import descriptor_dim

    h, w = params.ndt.grid_h, params.ndt.grid_w
    mc = params.ndt.max_cells
    fp = params.features
    d = descriptor_dim(fp)
    z3 = jnp.zeros(3)
    return NodeData(
        T=z3,
        Tlocal_odom=z3,
        Tlocal_fuse=z3,
        target=d2d.PackedTarget(
            origin=jnp.zeros(2),
            packed=jnp.zeros((h * w, 8)),
        ),
        cells=ndt_map.CellList(
            means=jnp.zeros((mc, 2)),
            covs=jnp.zeros((mc, 2, 2)),
            mask=jnp.zeros(mc, bool),
        ),
        occ_origin=jnp.zeros(2),
        occ=jnp.zeros((h, w)),
        feats=FeatureSet(
            pts=jnp.zeros((fm_capacity, 2)),
            angles=jnp.zeros(fm_capacity),
            scales=jnp.ones(fm_capacity),
            response=jnp.zeros(fm_capacity),
            mask=jnp.zeros(fm_capacity, bool),
        ),
        desc=jnp.full((fm_capacity, d), 0.5),
    )
