"""Distributed sparse-direct (segment-Schur) pose-graph solve.

The O(E)-memory large-graph solver (graph/sparse_direct.py) over a
device mesh — the scale-out story for graphs past what one chip holds:

  1. EDGE shard: each device linearizes its factors; the O(N)
     node-scattered diagonal/gradient and chain-coupling arrays psum
     across the mesh (never a dense H).
  2. SEGMENT shard: each device runs block-Thomas elimination for its
     segments (independent — embarrassingly parallel); per-segment
     Schur contributions scatter into the (S, S, 3, 3) reduced system
     and psum.
  3. The reduced separator solve runs replicated on every device.
  4. Back-substitution per owned segment; deltas psum-combine.

Levenberg-Marquardt accept/reject and the compensated (double-single)
position carry run replicated, identically to the single-device path.
Exact vs graph.sparse_direct.optimize_direct
(tests/test_parallel_sparse_direct.py on the virtual 8-device mesh).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from jax import shard_map

from ndt_feature_graph_tpu.core import se2
from ndt_feature_graph_tpu.graph import optimize as opt
from ndt_feature_graph_tpu.graph import sparse
from ndt_feature_graph_tpu.graph import sparse_direct as sd
from ndt_feature_graph_tpu.parallel import mesh as mesh_mod


def pad_segments(part: sd.SegPartition, n_shards) -> sd.SegPartition:
    """Pad the segment batch with empty segments so it divides the
    mesh (empty segments contribute exactly zero)."""
    B = part.idx.shape[0]
    rem = (-B) % n_shards
    if rem == 0:
        return part
    L = part.idx.shape[1]
    return part._replace(
        idx=jnp.concatenate(
            [part.idx, jnp.zeros((rem, L), jnp.int32)]
        ),
        imask=jnp.concatenate(
            [part.imask, jnp.zeros((rem, L), bool)]
        ),
        seg_len=jnp.concatenate(
            [part.seg_len, jnp.zeros(rem, jnp.int32)]
        ),
        seg_left=jnp.concatenate(
            [part.seg_left, jnp.full(rem, -1, jnp.int32)]
        ),
        seg_right=jnp.concatenate(
            [part.seg_right, jnp.full(rem, -1, jnp.int32)]
        ),
    )


def optimize_direct_sharded(
    mesh,
    poses,
    edges: opt.EdgeList,
    part: sd.SegPartition,
    prior_information: float = 100.0,
    iterations: int = 20,
    damping: float = 1e-6,
    axis: str = "dp",
):
    """Same contract as graph.sparse_direct.optimize_direct,
    distributed over `mesh[axis]`."""
    n = poses.shape[0]
    n_shards = mesh_mod.axis_size(mesh, axis)
    S = part.sep_ids.shape[0]
    prior_pose = poses[0]

    def pad(x, fill=0):
        return mesh_mod.pad_to_multiple(x, n_shards, axis=0, fill=fill)

    edges = opt.EdgeList(
        i=pad(edges.i), j=pad(edges.j), meas=pad(edges.meas),
        info=pad(edges.info), mask=pad(edges.mask, fill=False),
    )
    part = pad_segments(part, n_shards)

    espec = opt.EdgeList(
        i=P(axis), j=P(axis), meas=P(axis), info=P(axis), mask=P(axis)
    )

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(), espec,
                  P(axis), P(axis), P(axis), P(axis), P(axis)),
        out_specs=(P(), P(), P(), P()),
        check_vma=False,
    )
    def lm_step(p, p_lo, lam, chi_prev, eshard,
                idx, imask, seg_len, seg_left, seg_right):
        # 1. Edge-sharded linearization; O(N) psums.
        Hii, Hjj, Hij, D_e, b_e = sparse.linearize_edges_raw(
            p, eshard, n, p_lo=p_lo
        )
        D_e = jax.lax.psum(D_e, axis)
        b_e = jax.lax.psum(b_e, axis)
        blocks = sparse.finalize_blocks(
            p, D_e, b_e, Hii, Hjj, Hij, prior_information, lam,
            prior_pose,
        )
        C_chain = jax.lax.psum(
            sd.chain_coupling(Hij, eshard, n), axis
        )

        # 2. Reduced-system assembly: edge-shard off-diagonals +
        #    segment-shard Schur contributions, one psum.
        H_SS_local = sd.sep_coupling(Hij, eshard, part.sep_of, S)
        b_S_local = jnp.zeros((S, 3), p.dtype)
        *contribs, z, Y_L, Y_R = sd.segment_eliminate(
            blocks.D, blocks.b, C_chain, idx, imask, seg_len,
            seg_right, n,
        )
        H_SS_local, b_S_local = sd.scatter_segment_contribs(
            H_SS_local, b_S_local, contribs, seg_left, seg_right
        )
        H_SS = jax.lax.psum(H_SS_local, axis)
        b_S = jax.lax.psum(b_S_local, axis)
        H_SS = H_SS.at[jnp.arange(S), jnp.arange(S)].add(
            blocks.D[part.sep_ids]
        )
        b_S = b_S + blocks.b[part.sep_ids]

        # 3. Replicated separator solve.
        xS = sd.reduced_solve(H_SS, b_S)

        # 4. Sharded back-substitution; psum-combined delta.
        x_I = sd.segment_backsub(z, Y_L, Y_R, xS, seg_left, seg_right)
        local = jnp.zeros((n, 3), p.dtype)
        local = local.at[idx.reshape(-1)].add(
            jnp.where(imask.reshape(-1, 1), x_I.reshape(-1, 3), 0.0)
        )
        x = jax.lax.psum(local, axis)
        x = x.at[part.sep_ids].set(xS)
        delta = -x

        # LM trial + accept/reject (replicated decisions; chi2 is an
        # edge-sharded psum).
        xy, xy_lo = sparse.two_sum_update(
            p[:, :2], p_lo, delta[:, :2]
        )
        th = se2.normalize_angle(p[:, 2] + delta[:, 2])
        trial = jnp.concatenate([xy, th[:, None]], -1)
        r = sparse.edge_residual_hl(trial, xy_lo, eshard)
        per = jnp.einsum("ei,eij,ej->e", r, eshard.info, r)
        chi_t = jax.lax.psum(
            jnp.sum(jnp.where(eshard.mask, per, 0.0)), axis
        )
        rp = trial[0] - prior_pose
        rp = rp.at[2].set(se2.normalize_angle(rp[2]))
        chi_t = chi_t + prior_information * jnp.dot(rp, rp)

        accept = chi_t <= chi_prev
        p1 = jnp.where(accept, trial, p)
        lo1 = jnp.where(accept, xy_lo, p_lo)
        lam1 = jnp.where(
            accept,
            jnp.maximum(lam * 0.3, damping),
            jnp.minimum(lam * 8.0, 1e4),
        )
        chi1 = jnp.where(accept, chi_t, chi_prev)
        return p1, lo1, lam1, chi1

    @jax.jit
    def run(p, e, idx, imask, seg_len, seg_left, seg_right):
        lo0 = jnp.zeros((n, 2), p.dtype)
        # Initial chi2 (replicated full-edge evaluation is fine here:
        # one-off, outside the scan).
        r = sparse.edge_residual_hl(p, lo0, e)
        per = jnp.einsum("ei,eij,ej->e", r, e.info, r)
        chi0 = jnp.sum(jnp.where(e.mask, per, 0.0))

        def body(carry, _):
            p, p_lo, lam, chi = carry
            out = lm_step(p, p_lo, lam, chi, e,
                          idx, imask, seg_len, seg_left, seg_right)
            return out, None

        carry0 = (p, lo0, jnp.asarray(1e-2, p.dtype), chi0)
        (p_out, _, _, chi_out), _ = jax.lax.scan(
            body, carry0, None, length=iterations
        )
        return p_out, chi_out

    shard1 = lambda x: jax.device_put(
        x, NamedSharding(mesh, P(axis, *([None] * (x.ndim - 1))))
    )
    poses = mesh_mod.replicated(mesh, poses)
    edges_sharded = jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
        edges, espec,
    )
    return run(
        poses, edges_sharded, shard1(part.idx), shard1(part.imask),
        shard1(part.seg_len), shard1(part.seg_left),
        shard1(part.seg_right),
    )
