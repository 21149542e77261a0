"""Multi-device training on torch.distributed: the (segment, tile) mesh,
one process per device (SPMD), and the sharded train steps.

Counterpart of `ht3dgs.parallel.mesh`. JAX drives every device from one
controller; here every rank runs the same program on its own device, which
keeps the host work of the eager steps in parallel. Rank r is
(segment r // T, tile r % T) of an S x T mesh:
- the segment axis carries data-independent hierarchy segments, one model
  per segment group, with no collective in the step;
- the tile axis splits the image into row blocks of H / T rows; each tile
  rank renders its block against the segment's full (replicated) model, and
  the parameter gradients are summed over the segment's tile ranks, which
  keeps the replicas bit-equal.

The loss on a rank is its share of the full image's loss (train.losses'
sharded variants), so the summed gradients equal the single-device step's.
Every step flattens its gradients, probe gradient, loss share and counters
into one buffer and reduces it with a single all-reduce.

`init_distributed` brings up the process group (from torchrun's environment
or explicit arguments), `spawn` runs a function on a world of local ranks.
NCCL needs a card per rank; gloo runs several ranks on one card and on the
CPU. The backend is always the caller's choice.

Beside the main group, `init_distributed` makes the section group: CPU
gloo over every rank, with a timeout of a year. Ranks that wait while
rank 0 works alone (`wait_for_rank`) wait there, so the main group's
timeout bounds only real collectives and a section may run for hours, as
it can in the JAX package.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import queue
import socket
import time
import traceback
from typing import Dict, Optional

import torch
import torch.distributed as dist

from ..core import adam as adam_lib
from ..core.camera import Camera
from ..core.gaussians import PARAM_FIELDS, GaussianState
from ..raster import render
from ..train import densify as densify_lib
from ..train.losses import (leaf_grads,
                            scale_shift_invariant_depth_loss_sharded,
                            ssim_sharded)
from .comm import SINGLE, Axis, pack_counts, unpack_counts

# ---------------------------------------------------------------------------
# process group


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_group():
    """The default process group, or None in one process."""
    return dist.group.WORLD if dist.is_initialized() else None


def rank_device(device="cuda") -> torch.device:
    """This rank's device: the CPU, or card LOCAL_RANK modulo the cards
    there are (several gloo ranks share one card)."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % max(1, torch.cuda.device_count()))


def check_backend(device) -> None:
    """Run each collective the port uses once on a tensor of `device`:
    all_reduce SUM and MAX, and broadcast. Raises if the backend refuses
    one (gloo implements no other collective on CUDA tensors)."""
    n = dist.get_world_size()
    try:
        x = torch.ones(3, device=device)
        dist.all_reduce(x)
        m = torch.full((1,), float(dist.get_rank()), device=device)
        dist.all_reduce(m, op=dist.ReduceOp.MAX)
        b = torch.full((2,), float(dist.get_rank()), device=device)
        dist.broadcast(b, src=0)
        u = torch.full((2,), dist.get_rank(), dtype=torch.uint8,
                       device=device)
        dist.broadcast(u, src=0)
    except (RuntimeError, ValueError) as e:
        raise RuntimeError(
            f"the {dist.get_backend()} backend refused a collective on a "
            f"{torch.device(device).type} tensor; the multi-device path "
            "needs all_reduce (SUM, MAX) and broadcast there") from e
    if (x.tolist() != [float(n)] * 3 or m.item() != n - 1
            or b.tolist() != [0.0, 0.0] or u.tolist() != [0, 0]):
        raise RuntimeError(f"the {dist.get_backend()} backend returned wrong "
                           "collective results")


# long enough to count as no limit
SECTION_TIMEOUT = datetime.timedelta(days=365)
_SECTION = "section"


def init_distributed(backend: Optional[str] = None,
                     init_method: Optional[str] = None,
                     world: Optional[int] = None,
                     rank_: Optional[int] = None, device="cuda",
                     timeout: float = 1800.0) -> int:
    """Bring up torch.distributed and return the world size.

    From torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
    MASTER_PORT) or from explicit `init_method`, `world` and `rank_`. A
    no-op in a single process (no WORLD_SIZE, no arguments) and when the
    group is up already. `backend` defaults to "nccl" for a CUDA device and
    "gloo" for the CPU; NCCL that fails raises, nothing falls back. The
    timeout bounds the rendezvous and every collective of the main group;
    the section group, made here on every rank, has SECTION_TIMEOUT."""
    if dist.is_initialized():
        return dist.get_world_size()
    if world is None and "WORLD_SIZE" not in os.environ:
        return 1
    device = torch.device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    dev = rank_device(device)
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", "0"))
        if local >= torch.cuda.device_count():
            raise RuntimeError(
                f"NCCL needs one card per rank: local rank {local}, "
                f"{torch.cuda.device_count()} cards (run several ranks on "
                "one card over gloo)")
        torch.cuda.set_device(dev)
    kw = dict(backend=backend, timeout=datetime.timedelta(seconds=timeout))
    if init_method is not None:
        kw.update(init_method=init_method, world_size=world, rank=rank_)
    dist.init_process_group(**kw)
    _GROUPS[_SECTION] = dist.new_group(backend="gloo",
                                       timeout=SECTION_TIMEOUT)
    check_backend(dev)
    return dist.get_world_size()


def wait_for_rank(src: int = 0) -> None:
    """Return on every rank once rank `src` has called this too: a
    one-element CPU broadcast from `src` on the section group. Call it
    at the end of a section that `src` runs alone and before the section's
    results are broadcast on the main group, so that no collective of the
    main group is pending while `src` works. If `src` dies, gloo closes
    its connections and the waiting ranks raise. No-op in one process."""
    if world_size() > 1:
        dist.broadcast(torch.zeros(1, dtype=torch.uint8), src=src,
                       group=_GROUPS[_SECTION])


def shutdown() -> None:
    """Destroy the process group and forget its subgroups (the section
    group among them)."""
    _GROUPS.clear()
    if dist.is_initialized():
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawned(fn, r, world, backend, device, port, args, timeout,
             pg_timeout, threads, started, out):
    os.environ.update(RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                      LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    torch.set_num_threads(threads)
    try:
        # the ranks meet first, so a rendezvous under a short pg_timeout
        # does not wait for a sibling still importing
        started.wait(timeout)
        init_distributed(backend, device=device, timeout=pg_timeout)
        out.put((r, True, fn(r, *args)))
    except Exception:     # reported to the parent, which fails
        out.put((r, False, traceback.format_exc()))
    finally:
        shutdown()


def spawn(fn, world: int, backend: str = "gloo", device="cuda", args=(),
          timeout: float = 120.0, threads: int = 1,
          pg_timeout: Optional[float] = None) -> list:
    """Run fn(rank, *args) on `world` new local processes joined in one
    process group, and return their results by rank. fn and its arguments
    and results are pickled, so fn is a module-level function. The whole
    run is bounded by `timeout` seconds, the rendezvous and every
    collective of the main group by `pg_timeout` (default: `timeout`); on
    a failure or a timeout every child is killed and the error raised."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    started = ctx.Barrier(world)
    port = _free_port()
    procs = [ctx.Process(target=_spawned, args=(
        fn, r, world, backend, str(device), port, args, timeout,
        timeout if pg_timeout is None else pg_timeout, threads, started,
        out), daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    results = [None] * world
    deadline = time.monotonic() + timeout
    try:
        for _ in range(world):
            try:
                r, ok, val = out.get(timeout=max(0.1, deadline
                                                 - time.monotonic()))
            except queue.Empty:
                raise TimeoutError(f"spawn: no result from every rank "
                                   f"within {timeout} s") from None
            if not ok:
                raise RuntimeError(f"spawn: rank {r} failed:\n{val}")
            results[r] = val
        for p in procs:
            p.join(timeout=max(0.1, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    return results


# ---------------------------------------------------------------------------
# the mesh

# process groups by their ranks, and the section group: new_group is
# collective and costly, so each group is made once per process group
# (shutdown forgets them)
_GROUPS: Dict[object, object] = {}


def _group(ranks) -> object:
    key = tuple(ranks)
    if key not in _GROUPS:
        _GROUPS[key] = dist.new_group(list(ranks))
    return _GROUPS[key]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in an S x T mesh. `tile_axis` spans its segment's
    T ranks, `mesh_axis` all S * T ranks. Ranks past S * T are not members:
    they make the groups with the others and wait."""

    n_segments: int
    n_tiles: int
    segment: int
    tile: int
    tile_axis: Axis
    mesh_axis: Axis

    @property
    def member(self) -> bool:
        return self.segment >= 0

    @property
    def shape(self) -> dict:
        return {"segment": self.n_segments, "tile": self.n_tiles}

    def root(self, segment: int) -> int:
        """Global rank of tile 0 of `segment`."""
        return segment * self.n_tiles


def make_mesh(n_segments: int, n_tiles: int) -> Mesh:
    """The (segment, tile) mesh over ranks 0 .. S*T - 1. Every rank of the
    world calls it, in the same order (new_group is collective)."""
    n = n_segments * n_tiles
    world = world_size()
    if world < n:
        raise ValueError(f"need {n} ranks, have {world}")
    if not dist.is_initialized():
        return Mesh(1, 1, 0, 0, SINGLE, SINGLE)
    tile_groups = [_group(range(s * n_tiles, (s + 1) * n_tiles))
                   for s in range(n_segments)]
    mesh_group = _group(range(n))
    r = rank()
    if r >= n:
        return Mesh(n_segments, n_tiles, -1, -1, SINGLE, SINGLE)
    s, t = divmod(r, n_tiles)
    return Mesh(n_segments, n_tiles, s, t,
                Axis(tile_groups[s], t, n_tiles), Axis(mesh_group, r, n))


def make_pod_mesh(n_tiles_per_segment: Optional[int] = None) -> Mesh:
    """The mesh over the whole world with the tile axis inside a host:
    by default one segment per host (tiles = the ranks of a host,
    LOCAL_WORLD_SIZE), so the per-step reduction stays on its NVLink."""
    world = world_size()
    tiles = n_tiles_per_segment or int(os.environ.get("LOCAL_WORLD_SIZE",
                                                      world))
    return make_mesh(world // tiles, tiles)


def _row_block_camera(camera: Camera, row0: int, block_h: int) -> Camera:
    """The camera of a row block: cy shifted, the full image's EWA clamp
    kept, so projection (radii, validity) is the same on every block."""
    return dataclasses.replace(
        camera, cy=camera.cy - float(row0), height=block_h,
        clip_tan_x=camera.tan_half_fovx, clip_tan_y=camera.tan_half_fovy)


# ---------------------------------------------------------------------------
# the steps

APPLY_ALL = 0
APPLY_SKIP = 1          # densify iteration: no update (reference quirk)
APPLY_NO_OPACITY = 2    # opacity-reset iteration

_COUNTERS = ("n_dropped", "n_dropped_m", "n_dropped_tile",
             "n_dropped_compact")


def _flat(tensors):
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflat(flat, likes):
    out, i = [], 0
    for x in likes:
        out.append(flat[i:i + x.numel()].reshape(x.shape))
        i += x.numel()
    return out, flat[i:]


def build_hierarchy_step(mesh: Mesh, height: int, width: int, *,
                         mode: str = "tiled",
                         tile_args: Optional[dict] = None,
                         lambda_dssim: float = 0.2,
                         lambda_depth: float = 0.0):
    """The train step of this rank's segment on its row block, with the
    semantics of `train.step.gaussian_train_step` (same loss, densify
    statistics from the probe gradient reduced over the tiles, the apply
    codes).

    step(state, opt, camera, gt, lrs, depth_gt=None, apply_code=APPLY_ALL,
         track_stats=True, active=True) -> (state', opt', metrics)
    camera, gt [H, W, 3] and depth_gt [H, W] are the full image's; an
    inactive segment keeps its parameters, moments and statistics (its
    ranks still render, as the JAX step's do). Metrics: loss, psnr,
    n_visible and the drop counters summed over the tiles."""
    T = mesh.n_tiles
    if height % T:
        raise ValueError(f"image height {height} must divide the tile "
                         f"axis size {T}")
    block_h = height // T
    row0 = mesh.tile * block_h
    axis = mesh.tile_axis
    n_rgb = height * width * 3
    targs = dict(tile_args or {})

    def step(state: GaussianState, opt: adam_lib.AdamState, camera: Camera,
             gt: torch.Tensor, lrs, depth_gt=None, apply_code=APPLY_ALL,
             track_stats=True, active=True):
        cam = _row_block_camera(camera, row0, block_h)
        gt_b = gt[row0:row0 + block_h]
        params = {f: getattr(state, f).detach().requires_grad_(True)
                  for f in PARAM_FIELDS}
        probe = torch.zeros(state.capacity, 2, device=state.device,
                            requires_grad=True)
        out = render(state.replace_params(params), cam, means2d_probe=probe,
                     mode=mode, tile_args=targs)
        img = out["image"]
        share = (1.0 - lambda_dssim) * (img - gt_b).abs().sum() / n_rgb
        if lambda_dssim:
            share = share + lambda_dssim * (
                1.0 / T - ssim_sharded(img, gt_b, axis, n_rgb))
        if lambda_depth and depth_gt is not None:
            share = share + lambda_depth * \
                scale_shift_invariant_depth_loss_sharded(
                    torch.clamp(out["depth"], 0.02, 20.0),
                    depth_gt[row0:row0 + block_h], axis)
        leaves = list(params.values()) + [probe]
        g = leaf_grads(share, leaves)
        with torch.no_grad():
            zero = torch.zeros((), dtype=torch.int64, device=state.device)
            mse = ((img - gt_b) ** 2).sum() / n_rgb
            # the probe's y gradient is in units of the block's height
            g[-1] = g[-1] * torch.tensor([1.0, float(T)],
                                         device=state.device)
            flat = axis.all_reduce_(_flat(
                g + [share.detach(), mse,
                     pack_counts([out.get(k, zero) for k in _COUNTERS])]))
            g, rest = _unflat(flat, leaves)
            grads, probe_grad = dict(zip(PARAM_FIELDS, g[:-1])), g[-1]
            loss, mse = rest[0], rest[1]
            counts = unpack_counts(rest[2:])

            state = state.replace_params(
                {f: p.detach() for f, p in params.items()})
            if track_stats and active:
                state = densify_lib.accumulate_stats(state, probe_grad,
                                                     out["radii"])
            if apply_code != APPLY_SKIP and active:
                if apply_code == APPLY_NO_OPACITY:
                    grads["opacity_logit"] = torch.zeros_like(
                        grads["opacity_logit"])
                new_params, opt = adam_lib.apply(state.params(), grads, opt,
                                                 lrs)
                state = state.replace_params(new_params)
            metrics = {
                "loss": loss,
                "psnr": -10.0 * torch.log10(torch.clamp(mse, min=1e-12)),
                "n_visible": (out["radii"] > 0).sum(),
                **dict(zip(_COUNTERS, counts)),
            }
        return state, opt, metrics

    return step


def build_sharded_train_step(mesh: Mesh, height: int, width: int,
                             lambda_dssim: float = 0.2, mode: str = "tiled",
                             tile_args: Optional[dict] = None):
    """The minimal sharded step: render, L1 + D-SSIM, Adam, no statistics.
    step(state, opt, camera, gt, lrs) -> (state', opt', loss)."""
    hstep = build_hierarchy_step(mesh, height, width, mode=mode,
                                 tile_args=tile_args,
                                 lambda_dssim=lambda_dssim)

    def step(state, opt, camera, gt, lrs):
        state, opt, m = hstep(state, opt, camera, gt, lrs,
                              track_stats=False)
        return state, opt, m["loss"]

    return step


# ---------------------------------------------------------------------------
# densify and opacity reset of the mesh's segments


@torch.no_grad()
def batched_densify_and_prune(mesh: Mesh, state: GaussianState,
                              opt: adam_lib.AdamState, gen: torch.Generator,
                              max_grad, min_opacity, extent, percent_dense,
                              max_screen_size, use_screen_test):
    """`densify_and_prune` of this rank's segment. Every rank draws the
    split noise of all S segments from `gen`, in segment order, and uses
    its own, so the tile ranks of a segment stay bit-equal and every
    generator stays in step. Returns (state, opt, the MAX over the mesh of
    the rows dropped for capacity): a shared capacity grows on every rank
    or on none."""
    noise = None
    for s in range(mesh.n_segments):
        draw = tuple(torch.randn((state.capacity, 3), generator=gen,
                                 device=state.device) for _ in range(2))
        if s == mesh.segment:
            noise = draw
    state, opt, dropped = densify_lib.densify_and_prune(
        state, opt, noise, max_grad, min_opacity, extent, percent_dense,
        max_screen_size, use_screen_test)
    dropped = mesh.mesh_axis.all_reduce_(
        dropped.reshape(1).float(), "max")[0].to(torch.int64)
    return state, opt, dropped


batched_reset_opacity = densify_lib.reset_opacity
