"""The lockstep iteration of the parallel segment trainers.

Counterpart of `ht3dgs.train.lockstep`. `parallel_leaves` and
`parallel_nonleaf` walk S data-independent segments in lockstep over the
(segment, tile) mesh, one segment per tile group of ranks. What one
iteration does is the same for both and lives here once: the learning
rates, the densify / opacity-reset cadence and its apply codes, the sharded
step, the tile-capacity auto-grow, densify with the shared capacity's
growth, the opacity reset and the SH-degree cadence.

Decisions that the JAX package takes over its stacked [S, ...] arrays
(np.max over the segments) are taken here with a MAX all-reduce over the
mesh, so every rank rebuilds with the same tile arguments and capacity.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core import adam as adam_lib
from ..core import gaussians as G
from ..parallel import mesh as mesh_lib


def pad_rows(state: G.GaussianState, opt: adam_lib.AdamState, rows: int):
    """The state and its moments with `rows` dead rows appended."""
    if rows == 0:
        return state, opt

    def pad(x):
        return torch.cat([x, x.new_zeros((rows,) + x.shape[1:])])

    state = dataclasses.replace(
        state, **{f: pad(getattr(state, f)) for f in G.PARAM_FIELDS},
        live=pad(state.live), max_radii2d=pad(state.max_radii2d),
        grad_accum=pad(state.grad_accum), grad_denom=pad(state.grad_denom))
    opt = adam_lib.AdamState(m={k: pad(v) for k, v in opt.m.items()},
                             v={k: pad(v) for k, v in opt.v.items()},
                             step=opt.step)
    return state, opt


def _round128(n: float) -> int:
    return -(-int(n) // 128) * 128


class LockstepEngine:
    """One lockstep train iteration of this rank's segment.

    With a tile-sharded mesh (T > 1) and pipe.tile_compact_frac set, the
    tile arguments get compact_n = frac * capacity / T (rounded up to 128):
    each rank cull-compacts to its row block's Gaussians before the
    binning expansion. The auto-grow widens compact_n, as dup_factor and
    max_per_tile, when a step reports drops."""

    def __init__(self, tr, mesh: mesh_lib.Mesh, state, opt, radius: float,
                 spatial_scale: float, H: int, W: int,
                 label: str = "lockstep"):
        self.tr, self.mesh = tr, mesh
        self.o = tr.sched
        self.state, self.opt = state, opt
        self.radius, self.spatial_scale = radius, spatial_scale
        self.H, self.W = H, W
        self.label = label
        self.just_reset = False
        self._steps_since_tune = 0
        self.tile_args = dict(tr._tile_args) if tr._tile_args else None
        self._compact_frac = getattr(tr.pipe_cfg, "tile_compact_frac", None)
        if self._compact_frac and mesh.n_tiles > 1:
            self._seed_compact_n()
        self.step = self._build_step()

    def _seed_compact_n(self):
        cap = self.state.capacity
        compact = min(cap, _round128(
            cap * float(self._compact_frac) / self.mesh.n_tiles))
        self.tile_args = dict(self.tile_args or {}, compact_n=compact)
        self.tr.logger.info(
            f"[{self.label}] block cull-compaction: compact_n={compact} "
            f"(cap {cap}, {self.mesh.n_tiles} tiles)")

    def _build_step(self):
        return mesh_lib.build_hierarchy_step(
            self.mesh, self.H, self.W, mode=self.tr._mode,
            tile_args=self.tile_args, lambda_dssim=self.o.lambda_dssim,
            lambda_depth=self.o.lambda_depth)

    def lrs_for(self, iteration: int) -> dict:
        o, s = self.o, self.spatial_scale
        return {
            "means": adam_lib.expon_lr(
                iteration, o.position_lr_init * s, o.position_lr_final * s,
                max_steps=o.position_lr_max_steps),
            "sh_dc": o.feature_lr,
            "sh_rest": o.feature_lr / 20.0,
            "opacity_logit": o.opacity_lr,
            "log_scales": o.scaling_lr,
            "quats": o.rotation_lr,
        }

    def _autogrow(self, m):
        """Every 50 steps, widen only the exhausted capacity (the MAX of the
        drop counters over the mesh), then rebuild the step."""
        self._steps_since_tune += 1
        if self._steps_since_tune < 50:
            return
        self._steps_since_tune = 0
        drops = torch.stack([m[k] for k in (
            "n_dropped_m", "n_dropped_tile", "n_dropped_compact")]).float()
        nd_m, nd_tile, nd_c = (int(x) for x in
                               self.mesh.mesh_axis.all_reduce_(drops, "max"))
        if nd_m == 0 and nd_tile == 0 and nd_c == 0:
            return
        ta = dict(self.tile_args or {})
        if nd_tile > 0:
            ta["max_per_tile"] = min(2 * ta.get("max_per_tile", 1024), 4096)
        if nd_m > 0:
            ta["dup_factor"] = min(2 * ta.get("dup_factor", 16), 64)
        if nd_c > 0 and ta.get("compact_n"):
            ta["compact_n"] = min(self.state.capacity, 2 * ta["compact_n"])
        if ta != (self.tile_args or {}):
            self.tile_args = ta
            self.step = self._build_step()
            self.tr.logger.info(f"[{self.label}] tile capacity grown: {ta}")

    def one_iteration(self, camera, gt, iteration: int, *, sched=None,
                      interval=None, active=True, densify=True,
                      depth_gt=None):
        """One lockstep train iteration on (camera, gt), the full image's;
        the host train step's schedule."""
        o = sched or self.o
        interval = interval or o.densification_interval
        in_window = densify and iteration < o.densify_until_iter
        do_densify = (in_window and iteration > o.densify_from_iter
                      and iteration % interval == 0)
        do_reset = (in_window and iteration % o.opacity_reset_interval == 0
                    and iteration < o.reset_until_iter)
        code = (mesh_lib.APPLY_SKIP if do_densify else
                mesh_lib.APPLY_NO_OPACITY if do_reset else
                mesh_lib.APPLY_ALL)
        self.state, self.opt, m = self.step(
            self.state, self.opt, camera, gt, self.lrs_for(iteration),
            depth_gt=depth_gt, apply_code=code, track_stats=in_window,
            active=active)
        self._autogrow(m)

        if do_densify:
            use_screen = iteration > o.opacity_reset_interval
            self.state, self.opt, dropped = \
                mesh_lib.batched_densify_and_prune(
                    self.mesh, self.state, self.opt, self.tr.gen,
                    o.densify_grad_threshold, 0.005, self.radius,
                    o.percent_dense, 20.0, use_screen)
            if int(dropped) > 0:
                cap = self.state.capacity
                self.state, self.opt = pad_rows(self.state, self.opt, cap)
                self.tr.logger.info(f"[{self.label}] capacity grown to "
                                    f"{2 * cap}")
                if self._compact_frac and self.mesh.n_tiles > 1:
                    # a stale block budget would drop live Gaussians until
                    # the 50-step auto-grow noticed
                    self._seed_compact_n()
                    self.step = self._build_step()
        if do_reset:
            self.state, self.opt = mesh_lib.batched_reset_opacity(
                self.state, self.opt)
            self.just_reset = True
        if iteration % 1000 == 0:
            self.state = G.oneup_sh_degree(self.state)
        return m
