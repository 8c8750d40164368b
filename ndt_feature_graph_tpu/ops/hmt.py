"""NDTMapHMT: rolling NDT map with tile spill to a host/disk store and
exact recall on revisit.

Fixed-shape redesign of perception_oru's NDTMapHMT (the "helicoidal
multi-tile" disk-backed map gated by `beHMT` in the reference fuser,
ndt_feature/include/ndt_feature/ndt_feature_fuser_hmt.h:5-16, with
NDTMapHMT::writeTo persisting evicted tiles under `hmt_map_dir`): the
DEVICE carries only the fixed-shape rolling window (ops/ndt_map.NDTGrid
— jit-friendly, bounded memory), while trailing-edge cells evicted by a
recentre are SPILLED to a host tile store instead of dropped, and
re-entering previously-mapped ground RELOADS the stored sufficient
statistics exactly (bit-identical recall, not re-observation).

Design invariants:
  * The cell lattice is anchored at construction: every recentre shifts
    by whole cells (ops/ndt_map.recenter semantics), so global integer
    cell coordinates are well defined and tiles are aligned arrays.
  * A cell's content lives in EXACTLY ONE place — the live window or
    the store.  Spill moves it out (the shift blanks it), reload adds
    it back and zeroes the store.  Sufficient statistics (count, psum,
    outer) and clamped log-odds are therefore combined only with zeros,
    which makes every move exact.
  * Spill/reload run host-side at recentre events only (rare — the
    window moves by `roll_margin` between events); the per-scan hot
    path stays the jitted device program.  A recentre costs one
    full-grid readback (~MB) — acceptable at event rate, never placed
    inside a timed per-scan loop.

Persistence: `save(dir)` / `HMTMap.load(dir)` round-trip the store as
one NGF file per tile (the native binary grid codec, native/gridio.cpp
via io/native.py) plus a JSON manifest — the hmt_map_dir contract of
the reference (NDTMapHMT::writeTo / setDirectory round-trip).
"""

from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np

from ndt_feature_graph_tpu.config import NDTMapParams
from ndt_feature_graph_tpu.ops import ndt_map


def _empty_tile(tc: int):
    return {
        "count": np.zeros((tc, tc), np.float32),
        "psum": np.zeros((tc, tc, 2), np.float32),
        "outer": np.zeros((tc, tc, 2, 2), np.float32),
        "occ": np.zeros((tc, tc), np.float32),
    }


def _tile_empty(tile) -> bool:
    return not (tile["count"].any() or tile["occ"].any())


class HMTMap:
    """Host-orchestrated rolling map with tile spill/recall.

    params: NDTMapParams of the rolling window; center (2,): initial
    window centre (world); tile_cells: tile side length in cells.
    """

    def __init__(self, params: NDTMapParams, center, tile_cells: int = 64):
        self.params = params
        self.tile_cells = int(tile_cells)
        self.grid = ndt_map.empty_grid(
            params, jnp.asarray(center, jnp.float32)
        )
        # Lattice anchor: world coords of global cell (0, 0)'s corner.
        # All subsequent origins differ by whole cells.
        self.anchor = np.asarray(
            jax.device_get(self.grid.origin), np.float64
        )
        self.tiles: dict = {}  # (tx, ty) -> field dict

    # ---------------- live-window delegation ----------------

    def add_points(self, pts, mask):
        self.grid = ndt_map.add_points(self.grid, self.params, pts, mask)

    def update_occupancy(self, sensor_origin, pts, mask):
        self.grid = ndt_map.update_occupancy(
            self.grid, self.params, sensor_origin, pts, mask
        )

    def add_scan(self, sensor_origin, pts, mask, margin: float = 0.0):
        """Recentre onto the sensor if it left the margin, then fuse the
        scan (the NDTFuserHMT per-scan map update with window follow)."""
        if margin > 0.0:
            center = self.center()
            off = np.asarray(sensor_origin, np.float64)[:2] - center
            if float(np.hypot(off[0], off[1])) > margin:
                self.recenter(np.asarray(sensor_origin)[:2])
        self.add_points(pts, mask)
        self.update_occupancy(sensor_origin, pts, mask)

    def cell_list(self) -> ndt_map.CellList:
        return ndt_map.to_cell_list(self.grid, self.params)

    def center(self):
        origin = np.asarray(jax.device_get(self.grid.origin), np.float64)
        return origin + np.asarray(
            [self.params.size_x / 2.0, self.params.size_y / 2.0]
        )

    # ---------------- spill / reload ----------------

    def _g0(self, origin) -> np.ndarray:
        """Global integer cell coords (gx, gy) of window cell (0, 0)."""
        return np.round(
            (np.asarray(origin, np.float64) - self.anchor)
            / self.params.resolution
        ).astype(np.int64)

    def _tile(self, tx: int, ty: int):
        key = (int(tx), int(ty))
        t = self.tiles.get(key)
        if t is None:
            t = _empty_tile(self.tile_cells)
            self.tiles[key] = t
        return t

    def recenter(self, new_center):
        """Shift the window onto `new_center` by whole cells; spill
        evicted content to the tile store, reload stored content for
        the ground the window now covers.  Zero shift is a no-op."""
        p = self.params
        res = p.resolution
        g = jax.device_get(self.grid)
        origin = np.asarray(g.origin, np.float64)
        cur_center = origin + np.asarray(
            [p.size_x / 2.0, p.size_y / 2.0]
        )
        shift = np.round(
            (np.asarray(new_center, np.float64) - cur_center) / res
        ).astype(np.int64)
        sx, sy = int(shift[0]), int(shift[1])
        if sx == 0 and sy == 0:
            return
        h, w = p.grid_h, p.grid_w
        count = np.asarray(g.count)
        psum = np.asarray(g.psum)
        outer = np.asarray(g.outer)
        occ = np.asarray(g.occ)

        # SPILL: old cell (y, x) survives iff its shifted index
        # (y - sy, x - sx) stays in the window (ndt_map.recenter
        # semantics); evicted content-bearing cells go to the store.
        iy = np.arange(h)[:, None]
        ix = np.arange(w)[None, :]
        survive = (
            (iy - sy >= 0) & (iy - sy < h)
            & (ix - sx >= 0) & (ix - sx < w)
        )
        content = (count > 0) | (occ != 0.0)
        g0 = self._g0(origin)
        ys, xs = np.nonzero(~survive & content)
        if ys.size:
            tc = self.tile_cells
            gx = g0[0] + xs
            gy = g0[1] + ys
            tx = gx // tc
            ty = gy // tc
            ox = (gx - tx * tc).astype(np.int64)
            oy = (gy - ty * tc).astype(np.int64)
            keys = tx * (1 << 32) + ty  # unique scalar key per tile
            uniq, inv = np.unique(keys, return_inverse=True)
            for k in range(uniq.shape[0]):
                sel = inv == k
                tile = self._tile(tx[sel][0], ty[sel][0])
                o_y, o_x = oy[sel], ox[sel]
                s_y, s_x = ys[sel], xs[sel]
                # Exact: the stored cell is zero (exclusive residency).
                tile["count"][o_y, o_x] += count[s_y, s_x]
                tile["psum"][o_y, o_x] += psum[s_y, s_x]
                tile["outer"][o_y, o_x] += outer[s_y, s_x]
                tile["occ"][o_y, o_x] += occ[s_y, s_x]

        # SHIFT: new[y, x] = old[y + sy, x + sx] where in range.
        def mv(a):
            out = np.zeros_like(a)
            y0, y1 = max(0, -sy), min(h, h - sy)
            x0, x1 = max(0, -sx), min(w, w - sx)
            if y1 > y0 and x1 > x0:
                out[y0:y1, x0:x1] = a[
                    y0 + sy: y1 + sy, x0 + sx: x1 + sx
                ]
            return out

        count, psum, outer, occ = mv(count), mv(psum), mv(outer), mv(occ)

        # RELOAD: any stored content under the new window footprint is
        # moved back in (cells that never left are zero in the store,
        # so blanket addition over the footprint is exact).
        ng0 = g0 + np.asarray([sx, sy])
        tc = self.tile_cells
        for key in list(self.tiles):
            ktx, kty = key
            gx0, gx1 = ktx * tc, (ktx + 1) * tc
            gy0, gy1 = kty * tc, (kty + 1) * tc
            ox0, ox1 = max(gx0, ng0[0]), min(gx1, ng0[0] + w)
            oy0, oy1 = max(gy0, ng0[1]), min(gy1, ng0[1] + h)
            if ox0 >= ox1 or oy0 >= oy1:
                continue
            tile = self.tiles[key]
            gsy = slice(int(oy0 - ng0[1]), int(oy1 - ng0[1]))
            gsx = slice(int(ox0 - ng0[0]), int(ox1 - ng0[0]))
            tsy = slice(int(oy0 - gy0), int(oy1 - gy0))
            tsx = slice(int(ox0 - gx0), int(ox1 - gx0))
            count[gsy, gsx] += tile["count"][tsy, tsx]
            psum[gsy, gsx] += tile["psum"][tsy, tsx]
            outer[gsy, gsx] += tile["outer"][tsy, tsx]
            occ[gsy, gsx] += tile["occ"][tsy, tsx]
            tile["count"][tsy, tsx] = 0.0
            tile["psum"][tsy, tsx] = 0.0
            tile["outer"][tsy, tsx] = 0.0
            tile["occ"][tsy, tsx] = 0.0
            if _tile_empty(tile):
                del self.tiles[key]

        new_origin = (origin + shift * res).astype(np.float32)
        self.grid = ndt_map.NDTGrid(
            origin=jnp.asarray(new_origin),
            count=jnp.asarray(count),
            psum=jnp.asarray(psum),
            outer=jnp.asarray(outer),
            occ=jnp.asarray(occ),
        )

    # ---------------- persistence (hmt_map_dir contract) ----------------

    def save(self, dirpath):
        """Write the store + live window to `dirpath`: one NGF file per
        tile + the active window + a JSON manifest (the reference's
        hmt_map_dir layout, one .jff per tile)."""
        from ndt_feature_graph_tpu.io import native

        os.makedirs(dirpath, exist_ok=True)
        res = self.params.resolution
        tc = self.tile_cells
        names = {}
        for (tx, ty), tile in self.tiles.items():
            name = f"tile_{tx}_{ty}.ngf"
            origin = self.anchor + np.asarray(
                [tx * tc * res, ty * tc * res]
            )
            grid = ndt_map.NDTGrid(
                origin=jnp.asarray(origin, jnp.float32),
                count=jnp.asarray(tile["count"]),
                psum=jnp.asarray(tile["psum"]),
                outer=jnp.asarray(tile["outer"]),
                occ=jnp.asarray(tile["occ"]),
            )
            native.write_grid(os.path.join(dirpath, name), grid, res)
            names[f"{tx},{ty}"] = name
        native.write_grid(
            os.path.join(dirpath, "active.ngf"), self.grid, res
        )
        with open(os.path.join(dirpath, "hmt.json"), "w") as f:
            json.dump(
                {
                    "anchor": list(map(float, self.anchor)),
                    "tile_cells": tc,
                    "resolution": res,
                    "tiles": names,
                },
                f,
            )

    @classmethod
    def load(cls, dirpath, params: NDTMapParams) -> "HMTMap":
        from ndt_feature_graph_tpu.io import native

        with open(os.path.join(dirpath, "hmt.json")) as f:
            meta = json.load(f)
        self = cls.__new__(cls)
        self.params = params
        self.tile_cells = int(meta["tile_cells"])
        self.anchor = np.asarray(meta["anchor"], np.float64)
        self.grid, _res = native.read_grid(
            os.path.join(dirpath, "active.ngf")
        )
        self.tiles = {}
        for key, name in meta["tiles"].items():
            tx, ty = (int(v) for v in key.split(","))
            grid, _ = native.read_grid(os.path.join(dirpath, name))
            self.tiles[(tx, ty)] = {
                "count": np.array(grid.count),
                "psum": np.array(grid.psum),
                "outer": np.array(grid.outer),
                "occ": np.array(grid.occ),
            }
        return self

    # ---------------- whole-map view ----------------

    def stored_cell_count(self) -> int:
        return int(
            sum((t["count"] > 0).sum() for t in self.tiles.values())
        )

    def global_gaussians(self):
        """Finalized (means, covs) over live window + every stored tile
        (whole-map export, NDTMap::getAllCells over the full HMT)."""
        parts = []
        mean, cov, valid = ndt_map.finalize(self.grid, self.params)
        m = np.asarray(valid).reshape(-1)
        parts.append(
            (
                np.asarray(mean).reshape(-1, 2)[m],
                np.asarray(cov).reshape(-1, 2, 2)[m],
            )
        )
        res = self.params.resolution
        tc = self.tile_cells
        for (tx, ty), tile in self.tiles.items():
            origin = self.anchor + np.asarray(
                [tx * tc * res, ty * tc * res]
            )
            g = ndt_map.NDTGrid(
                origin=jnp.asarray(origin, jnp.float32),
                count=jnp.asarray(tile["count"]),
                psum=jnp.asarray(tile["psum"]),
                outer=jnp.asarray(tile["outer"]),
                occ=jnp.asarray(tile["occ"]),
            )
            # finalize() only reads shapes from the arrays themselves.
            tp = self.params.replace(
                size_x=tc * res, size_y=tc * res
            )
            mean, cov, valid = ndt_map.finalize(g, tp)
            m = np.asarray(valid).reshape(-1)
            parts.append(
                (
                    np.asarray(mean).reshape(-1, 2)[m],
                    np.asarray(cov).reshape(-1, 2, 2)[m],
                )
            )
        means = np.concatenate([p[0] for p in parts], 0)
        covs = np.concatenate([p[1] for p in parts], 0)
        return means, covs
