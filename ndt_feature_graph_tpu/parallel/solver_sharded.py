"""Distributed pose-graph solve: edge-sharded normal-equation assembly
with psum reduction.

The factor-graph normal equations are a sum of per-edge rank-6
contributions (graph/optimize.assemble_normal_equations), so the
linearization — the O(E) part — shards perfectly over the mesh: each
device assembles its edge shard's (H, b), a `psum` over the mesh axis
reconstructs the global system on every device, and the
small dense solve is computed replicated.  This is the first rung of
SURVEY.md §7.9's distributed-solve ladder; blocked Schur elimination
for >10^3-node graphs builds on the same sharded assembly.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from jax import shard_map

from ndt_feature_graph_tpu.core import se2
from ndt_feature_graph_tpu.graph import optimize as opt

from ndt_feature_graph_tpu.graph.optimize import f32_matmul as _f32
from ndt_feature_graph_tpu.parallel import mesh as mesh_mod


@_f32
def optimize_sharded(
    mesh,
    poses,
    edges: opt.EdgeList,
    prior_information: float = 100.0,
    iterations: int = 20,
    damping: float = 1e-6,
    axis: str = "dp",
):
    """Same contract as graph.optimize.optimize, but with the edge set
    sharded over `mesh[axis]`.  Exact: the result matches the
    single-device solver to float tolerance (tests/test_parallel.py).
    """
    n = poses.shape[0]
    dim = 3 * n
    n_shards = mesh_mod.axis_size(mesh, axis)
    prior_pose = poses[0]

    # Pad edges to a multiple of the shard count (masked, so exact).
    def pad(x, fill=0):
        return mesh_mod.pad_to_multiple(x, n_shards, axis=0, fill=fill)

    edges = opt.EdgeList(
        i=pad(edges.i),
        j=pad(edges.j),
        meas=pad(edges.meas),
        info=pad(edges.info),
        mask=pad(edges.mask, fill=False),
    )

    espec = opt.EdgeList(
        i=P(axis), j=P(axis), meas=P(axis), info=P(axis), mask=P(axis)
    )

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), espec),
        out_specs=P(),
        check_vma=False,
    )
    def sharded_step(p, eshard):
        H, b = opt.assemble_normal_equations(p, eshard, n)
        H = jax.lax.psum(H, axis)
        b = jax.lax.psum(b, axis)

        rp = p[0] - prior_pose
        rp = rp.at[2].set(se2.normalize_angle(rp[2]))
        H = H.at[0, 0].add(
            prior_information * jnp.eye(3, dtype=p.dtype)
        )
        b = b.at[0].add(prior_information * rp)

        Hd = H.transpose(0, 2, 1, 3).reshape(dim, dim)
        bd = b.reshape(dim)
        Hd = Hd + damping * jnp.eye(dim, dtype=p.dtype)
        diag = jnp.diagonal(Hd)
        Hd = Hd + jnp.diag(jnp.where(diag < 1e-8, 1.0, 0.0))
        delta = -jnp.linalg.solve(Hd, bd).reshape(n, 3)
        p_new = p + delta
        return p_new.at[:, 2].set(se2.normalize_angle(p_new[:, 2]))

    @jax.jit
    def run(p, e):
        def body(p, _):
            return sharded_step(p, e), None

        p_out, _ = jax.lax.scan(body, p, None, length=iterations)
        return p_out

    poses = mesh_mod.replicated(mesh, poses)
    edges = jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
        edges,
        espec,
    )
    return run(poses, edges)
