"""HMT-backed fuser: the live submap is the rolling window of an
ops.hmt.HMTMap — the NDTFuserHMT equivalent with `beHMT` set.

Reference: when beHMT is on, the fuser's map IS an NDTMapHMT whose
evicted tiles persist under `hmt_map_dir`
(ndt_feature/include/ndt_feature/ndt_feature_fuser_hmt.h:5-16, map
construction at src/ndt_feature_src/ndt_feature_fuser_hmt.cpp:8-27).
The plain `rolling_map` mode (fusion/fuser.py) recentres on device but
DROPS trailing-edge cells; here a recentre SPILLS them to the host
tile store and RELOADS any stored ground the window re-enters —
revisited territory is registered against, not re-observed
(tests/test_hmt_driver.py).

Division of labour (device residency):
  * The per-scan hot path stays the jitted device program
    (fuser.update / scan_driver.run_sequence over chunks) with
    rolling_map OFF — the window is world-fixed between recentre
    events.
  * Recentres are HOST events at chunk boundaries: one full-grid
    readback (~1.3 MB), the exact spill/reload of ops/hmt.py, one
    upload, and one jitted full packed-table rebuild.  The event cost
    on the GPU is not measured yet.

The chunk length bounds how far the vehicle can move between recentre
checks: callers must keep
  chunk * max_step_m  <=  size/2 - sensor_range - recenter_margin
so every scan's sensor disc stays inside the window (the canonical op
point has 50 - 30 = 20 m of slack).
"""

from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np

from ndt_feature_graph_tpu.config import FuserParams
from ndt_feature_graph_tpu.fusion import fuser, scan_driver
from ndt_feature_graph_tpu.ops import d2d
from ndt_feature_graph_tpu.ops.hmt import HMTMap


class HMTFuser:
    """Host-orchestrated scan-to-submap fuser over an HMT map.

    params: FuserParams (rolling_map must be False — recentres are
    orchestrated here, not in-jit); recenter_margin: recentre the
    window once the vehicle is this far from its centre.
    """

    def __init__(
        self,
        params: FuserParams,
        init_pose,
        sensor_pose,
        pts,
        mask,
        recenter_margin: float = 10.0,
        tile_cells: int = 64,
    ):
        if params.rolling_map:
            raise ValueError(
                "HMTFuser orchestrates recentres itself; set "
                "rolling_map=False (the in-jit roll drops cells)"
            )
        self.params = params
        self.margin = float(recenter_margin)
        self.state = fuser.initialize(
            params, jnp.asarray(init_pose, jnp.float32),
            jnp.asarray(sensor_pose, jnp.float32), pts, mask,
        )
        # The HMTMap carries the tile store + lattice anchor; the
        # fuser state's grid is the single live window (synced into
        # the HMTMap around each recentre).  Both construct their
        # grid via empty_grid(params, center) -> identical origins.
        self.hmt = HMTMap(
            params.ndt, np.asarray(init_pose)[:2], tile_cells
        )
        self.n_recenters = 0
        self.recenter_times: list = []

    # ---------------- recentre event ----------------

    def _center(self) -> np.ndarray:
        origin = np.asarray(
            jax.device_get(self.state.grid.origin), np.float64
        )
        p = self.params.ndt
        return origin + np.asarray([p.size_x / 2.0, p.size_y / 2.0])

    def maybe_recenter(self):
        """Spill/reload recentre if the vehicle left the margin.
        Returns True if a recentre happened."""
        import time

        pose = np.asarray(jax.device_get(self.state.Tnow), np.float64)
        off = pose[:2] - self._center()
        if float(np.hypot(off[0], off[1])) <= self.margin:
            return False
        t0 = time.perf_counter()
        self.hmt.grid = self.state.grid
        self.hmt.recenter(pose[:2])
        packed = d2d.packed_from_grid(self.hmt.grid, self.params.ndt)
        self.state = self.state._replace(
            grid=self.hmt.grid, packed=packed
        )
        self.n_recenters += 1
        self.recenter_times.append(time.perf_counter() - t0)
        return True

    # ---------------- driving ----------------

    def update(self, Tmotion, pts, mask):
        """One scan: host recentre check (event-rate), then the jitted
        fuser update."""
        self.maybe_recenter()
        self.state, info = fuser.update(
            self.state, self.params, Tmotion, pts, mask
        )
        return info

    def run_sequence(self, odom, pts, mask, chunk: int = 16):
        """Device-resident chunked driving: `chunk` scans per dispatch
        (scan_driver.run_sequence), recentre checks between chunks.
        odom (T, 3); pts (T, P, 2); mask (T, P).
        Returns trajectory (T, 3) numpy."""
        t = int(odom.shape[0])
        out = []
        for s in range(0, t, chunk):
            e = min(s + chunk, t)
            self.maybe_recenter()
            self.state, traj, _scores = scan_driver.run_sequence(
                self.params, self.state, odom[s:e], pts[s:e], mask[s:e]
            )
            out.append(np.asarray(traj))
        return np.concatenate(out, 0) if out else np.zeros((0, 3))

    # ---------------- map views / persistence ----------------

    def window_cells_near(self, world_xy, radius: float) -> int:
        """Count of valid finalized cells in the LIVE window within
        `radius` of a world point (diagnostic: recalled ground)."""
        from ndt_feature_graph_tpu.ops import ndt_map

        mean, _cov, valid = ndt_map.finalize(
            self.state.grid, self.params.ndt
        )
        m = np.asarray(valid)
        mm = np.asarray(mean)[m]
        d = np.linalg.norm(
            mm - np.asarray(world_xy, np.float32)[None, :], axis=-1
        )
        return int((d <= radius).sum())

    def stored_cell_count(self) -> int:
        return self.hmt.stored_cell_count()

    def save(self, dirpath: str):
        """Persist store + live window + pose (the hmt_map_dir
        contract plus the fuser pose)."""
        self.hmt.grid = self.state.grid
        self.hmt.save(dirpath)
        with open(os.path.join(dirpath, "fuser.json"), "w") as f:
            json.dump(
                {
                    "Tnow": [float(v) for v in
                             np.asarray(self.state.Tnow)],
                    "Todom": [float(v) for v in
                              np.asarray(self.state.Todom)],
                    "sensor_pose": [float(v) for v in
                                    np.asarray(self.state.sensor_pose)],
                    "n_updates": int(self.state.n_updates),
                    "margin": self.margin,
                },
                f,
            )

    @classmethod
    def load(cls, dirpath: str, params: FuserParams) -> "HMTFuser":
        """Resume from a saved hmt_map_dir: store, window, and pose."""
        self = cls.__new__(cls)
        self.params = params
        self.hmt = HMTMap.load(dirpath, params.ndt)
        with open(os.path.join(dirpath, "fuser.json")) as f:
            meta = json.load(f)
        self.margin = float(meta["margin"])
        self.state = fuser.FuserState(
            Tnow=jnp.asarray(meta["Tnow"], jnp.float32),
            Todom=jnp.asarray(meta["Todom"], jnp.float32),
            Tlast_fuse=jnp.asarray(meta["Tnow"], jnp.float32),
            sensor_pose=jnp.asarray(meta["sensor_pose"], jnp.float32),
            grid=self.hmt.grid,
            packed=d2d.packed_from_grid(self.hmt.grid, params.ndt),
            n_updates=jnp.int32(meta["n_updates"]),
        )
        self.n_recenters = 0
        self.recenter_times = []
        return self
