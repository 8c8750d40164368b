"""Distributed Schur-complement pose-graph solve.

The full multi-chip solve pipeline (BASELINE.md north star) in one
shard_map per GN iteration:
  1. each device assembles normal equations from its EDGE shard
     (additive) — psum reconstructs the global (H, b) on every device;
  2. each device eliminates the interiors of its BLOCK shard
     (independent dense solves) — psum reduces the separator system;
  3. the small separator solve runs replicated;
  4. back-substitution for owned blocks, psum combines the delta.
Three collectives per iteration, all bandwidth-light (separator-sized
or n-nodes-sized).  Exact vs the single-device solvers
(tests/test_parallel.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from jax import shard_map

from ndt_feature_graph_tpu.core import se2
from ndt_feature_graph_tpu.graph import optimize as opt
from ndt_feature_graph_tpu.graph import schur as schur_mod
from ndt_feature_graph_tpu.parallel import mesh as mesh_mod


def optimize_schur_sharded(
    mesh,
    poses,
    edges: opt.EdgeList,
    part: schur_mod.Partition,
    prior_information: float = 100.0,
    iterations: int = 20,
    damping: float = 1e-6,
    axis: str = "dp",
):
    """Same contract as graph.schur.optimize_schur, distributed over
    `mesh[axis]`.  Requires part.n_blocks % mesh size == 0 (pad the
    partition's block count if needed)."""
    n = poses.shape[0]
    n_shards = mesh_mod.axis_size(mesh, axis)
    prior_pose = poses[0]
    sep = part.sep_idx
    ms = jnp.repeat(part.sep_mask, 3)

    def pad(x, fill=0):
        return mesh_mod.pad_to_multiple(x, n_shards, axis=0, fill=fill)

    edges = opt.EdgeList(
        i=pad(edges.i), j=pad(edges.j), meas=pad(edges.meas),
        info=pad(edges.info), mask=pad(edges.mask, fill=False),
    )
    assert part.int_idx.shape[0] % n_shards == 0, (
        "block count must divide the mesh"
    )

    espec = opt.EdgeList(
        i=P(axis), j=P(axis), meas=P(axis), info=P(axis), mask=P(axis)
    )

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), espec, P(axis), P(axis)),
        out_specs=P(),
        check_vma=False,
    )
    def sharded_step(p, eshard, int_idx, int_mask):
        # 1. Edge-sharded assembly + psum.
        H, b = opt.assemble_normal_equations(p, eshard, n)
        H = jax.lax.psum(H, axis)
        b = jax.lax.psum(b, axis)
        rp = p[0] - prior_pose
        rp = rp.at[2].set(se2.normalize_angle(rp[2]))
        H = H.at[0, 0].add(
            prior_information * jnp.eye(3, dtype=p.dtype)
        )
        b = b.at[0].add(prior_information * rp)

        # 2. Block-sharded interior elimination.
        local_part = part._replace(int_idx=int_idx, int_mask=int_mask)
        schur_c, rhs_c, ctx = schur_mod.block_eliminate(
            H, b, local_part, damping
        )
        S_contrib = jax.lax.psum(jnp.sum(schur_c, axis=0), axis)
        r_contrib = jax.lax.psum(jnp.sum(rhs_c, axis=0), axis)

        # 3. Replicated separator solve.
        H_SS = schur_mod._gather_block(H, sep, sep)
        eye_s = jnp.eye(H_SS.shape[0], dtype=p.dtype)
        H_SS = jnp.where(
            ms[:, None] & ms[None, :], H_SS, eye_s
        ) + damping * eye_s
        b_S = jnp.where(ms, b[sep].reshape(-1), 0.0)
        S = H_SS - S_contrib
        r = b_S - r_contrib
        diag = jnp.diagonal(S)
        S = S + jnp.diag(jnp.where(diag < 1e-8, 1.0, 0.0))
        dS = -jnp.linalg.solve(S, r)

        # 4. Sharded back-substitution + psum-combined delta.
        H_II, H_IS, b_I = ctx

        def back(Hii, His, bi):
            return -jnp.linalg.solve(Hii, bi + His @ dS)

        dI = jax.vmap(back)(H_II, H_IS, b_I)
        local_delta = jnp.zeros((n, 3), p.dtype)
        bcount, icap = int_idx.shape
        local_delta = local_delta.at[int_idx.reshape(-1)].add(
            jnp.where(
                int_mask.reshape(-1, 1),
                dI.reshape(bcount * icap, 3),
                0.0,
            )
        )
        delta = jax.lax.psum(local_delta, axis)
        delta = delta.at[sep].add(
            jnp.where(ms, dS, 0.0).reshape(-1, 3)
        )
        p_new = p + delta
        return p_new.at[:, 2].set(se2.normalize_angle(p_new[:, 2]))

    @jax.jit
    def run(p, e, ii, im):
        def body(p, _):
            return sharded_step(p, e, ii, im), None

        out, _ = jax.lax.scan(body, p, None, length=iterations)
        return out

    shard1 = lambda x: jax.device_put(
        x, NamedSharding(mesh, P(axis, *([None] * (x.ndim - 1))))
    )
    poses = mesh_mod.replicated(mesh, poses)
    edges = jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
        edges, espec,
    )
    return run(
        poses, edges, shard1(part.int_idx), shard1(part.int_mask)
    )
