"""Device-mesh helpers and the multi-host bootstrap.

The reference has no distributed backend at all (SURVEY.md §2.3 bottom);
scale-out here is new design: jax.sharding Mesh + shard_map with XLA
collectives (NCCL on GPUs) over NVLink inside a host and the network
between hosts.  Conventions:
  axis "dp"  — data parallel over submaps / scan streams / link pairs
  axis "gp"  — graph parallel over factor-graph edges
  axes ("dcn", "ici") — 2-D multi-host mesh: processes (hosts) on the
  outer "dcn" axis (the network between hosts), each process's local
  devices on the inner "ici" axis (NVLink inside the host), so that
  sharded work reduces inside the host first and only the host-level
  partial crosses the network.
A 1-D mesh uses "dp" for both roles.  Every sharded program in this
package takes `axis` as a name OR a tuple of names, so the same code
runs on a flat single-host mesh and on the 2-D (dcn, ici) layout
(axis=("dcn", "ici") shards the data over the full device product).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None):
    """Multi-host bootstrap (jax.distributed.initialize wrapper).

    Call once per process before any other JAX API.  With no arguments
    it defers to cluster auto-detection (e.g. SLURM); elsewhere pass
    coordinator_address="host:port",
    num_processes, process_id explicitly.  No-op for single-process
    runs (num_processes in (None, 1) and no cluster env)."""
    if num_processes is not None and num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def make_mesh(n_devices=None, axis="dp"):
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def make_mesh_2d(axes=("dcn", "ici")):
    """2-D multi-host mesh: (process, local-device) grid.

    Rows are processes (hosts — collectives across rows ride the
    network), columns are each process's local devices (NVLink inside
    the host).  Works
    single-process too (1 x n_local).  Device order within a row is the
    process's own enumeration order, so data laid out with
    P(("dcn", "ici")) keeps each process's shard on its own devices —
    no cross-host data placement."""
    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    nproc = max(d.process_index for d in devs) + 1
    counts = {}
    for d in devs:
        counts[d.process_index] = counts.get(d.process_index, 0) + 1
    if len(set(counts.values())) != 1 or len(counts) != nproc:
        # A merely-divisible total with UNEQUAL per-process counts
        # would silently mix processes within a row, breaking the
        # "each process's shard on its own devices" guarantee.
        raise ValueError(
            f"uneven devices per process: {counts} — every process "
            "must contribute the same local device count"
        )
    grid = np.asarray(devs).reshape(nproc, len(devs) // nproc)
    return Mesh(grid, axes)


def axis_tuple(axis):
    """Normalize an axis spec (name or tuple of names) to a tuple."""
    return (axis,) if isinstance(axis, str) else tuple(axis)


def axis_size(mesh, axis):
    """Total shard count over one axis name or a tuple of axis names."""
    return int(np.prod([mesh.shape[a] for a in axis_tuple(axis)]))


def pad_to_multiple(x, multiple, axis=0, fill=0):
    """Pad a leading axis so it divides evenly across shards."""
    import jax.numpy as jnp

    n = x.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return x
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, rem)
    return jnp.pad(x, pad, constant_values=fill)


def replicated(mesh, x):
    return jax.device_put(x, NamedSharding(mesh, P()))


def sharded(mesh, x, axis="dp"):
    return jax.device_put(x, NamedSharding(mesh, P(axis)))


def global_put(mesh, x, spec):
    """device_put onto a (possibly multi-PROCESS) mesh: every process
    passes the identical full array and contributes its addressable
    shards (jax.make_array_from_callback) — a plain device_put cannot
    target non-addressable devices.  Single-process behavior is
    identical to device_put(NamedSharding(mesh, spec))."""
    import numpy as np

    x = np.asarray(x)
    sh = NamedSharding(mesh, spec)
    return jax.make_array_from_callback(x.shape, sh, lambda idx: x[idx])


def global_get(mesh, x):
    """Full value of a global array on every process: reshard to
    replicated over the mesh (an all-gather), read the local copy."""
    import numpy as np

    rep = jax.jit(
        lambda a: a,
        out_shardings=NamedSharding(mesh, P()),
    )(x)
    return np.asarray(rep.addressable_shards[0].data)
