"""Euclidean distance transform via jump flooding.

Replaces occupancy_grid_utils::distanceField (used by the scan-pose
evaluator, flirtlib_ros/src/localization_monitor.cpp:43).  Jump
flooding is the accelerator-friendly EDT: log2(n) rounds of fixed-shape
neighbour gathers, no data-dependent control flow (SURVEY.md §2.3).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=("max_dist_cells",))
def distance_field(occupied, max_dist_cells: int = 1 << 30):
    """occupied: (H, W) bool -> (H, W) float32 distance in CELLS to the
    nearest occupied cell (0 inside obstacles)."""
    h, w = occupied.shape
    yy = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xx = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    big = jnp.int32(1 << 28)
    seed_y = jnp.where(occupied, yy, big)
    seed_x = jnp.where(occupied, xx, big)

    def dist2(sy, sx):
        dy = (yy - sy).astype(jnp.float32)
        dx = (xx - sx).astype(jnp.float32)
        return jnp.where(sy >= big, jnp.inf, dy * dy + dx * dx)

    n = max(h, w)
    steps = []
    s = 1
    while s < n:
        s <<= 1
    s >>= 1
    while s >= 1:
        steps.append(s)
        s >>= 1

    sy, sx = seed_y, seed_x
    for step in steps:
        best = dist2(sy, sx)
        for dy in (-step, 0, step):
            for dx in (-step, 0, step):
                if dy == 0 and dx == 0:
                    continue
                cy = jnp.roll(sy, (dy, dx), (0, 1))
                cx = jnp.roll(sx, (dy, dx), (0, 1))
                # Rolled wrap-around is invalidated by the distance
                # check only when the candidate is closer, which a
                # wrapped seed rarely is; mask wrapped rows/cols
                # explicitly for correctness.
                ymask = (
                    (yy - dy >= 0) & (yy - dy < h)
                ) if dy != 0 else jnp.ones_like(yy, bool)
                xmask = (
                    (xx - dx >= 0) & (xx - dx < w)
                ) if dx != 0 else jnp.ones_like(xx, bool)
                valid = ymask & xmask
                d = jnp.where(valid, dist2(cy, cx), jnp.inf)
                better = d < best
                sy = jnp.where(better, cy, sy)
                sx = jnp.where(better, cx, sx)
                best = jnp.minimum(best, d)
    return jnp.sqrt(dist2(sy, sx))
