"""The work a step's inputs need, by the benchmark's own count, and the
H100's published peaks to hold it against.

Everything here is counted from the live Gaussians, the camera and the
frame, through the reference's projection and tile lists
(`reference.splat`): never from the port's entry lists, capacity or
binning, so a change of layout, capacity or binning leaves the count
alone. Per view:
- blend: a tile's entries are the Gaussians whose rectangle covers it; a
  pixel evaluates its tile's entries in depth order up to and including
  the one that stops it (all of them if none does), and keeps those before
  the stop (`evals`, `kept`);
- K1 (forward blend): FLOP_K1 per evaluated entry-pixel; it reads each
  entry's 10 values once and writes 5 values a pixel (colour, final
  transmittance, depth);
- K2 (backward blend): FLOP_K2 per kept entry-pixel; it reads each entry
  and 5 values a pixel (the colour and depth cotangents, the final
  transmittance) and writes 10 values an entry;
- projection + SH: FLOP_PROJ per live row, forward and backward;
- loss: FLOP_LOSS per pixel, forward and backward;
- Adam: FLOP_ADAM per live parameter.
An FMA counts as two operations, a special function (exp, rsqrt, divide)
as one. The counts are a yardstick: they move only with the inputs.
"""

from __future__ import annotations

import subprocess
from typing import Dict, List

import torch

from .reference import splat

PEAK_FLOPS = 67e12       # f32 outside the tensor cores, H100 SXM
PEAK_BYTES = 3.35e12     # HBM3, H100 SXM
PEAKS_SOURCE = "NVIDIA H100 SXM datasheet (700 W)"

# per evaluated entry-pixel: offset 2, quadratic form 8, exp 2, opacity 1,
# clamp 1, gates 3, transmittance 2, weight 1, colour 6, depth 2
FLOP_K1 = 28
# per kept entry-pixel: K1's 17 to rebuild alpha, undo transmittance 3,
# cotangent dot 8, d_alpha 4, suffix 2, d_power 1, the five geometry
# cotangents 16, colour/opacity/depth 5, the entry's sums over pixels 10
FLOP_K2 = 66
# per live row: view transform 18, pixel 6, Jacobian 8, its product with
# the view rotation 30, quaternion to matrix 30, the covariance factor 36,
# 2D covariance 15, conic and radius 16, SH direction 10 and basis 30,
# colour 96, activations 6: 301 forward, twice that backward
FLOP_PROJ = 903
# per pixel and channel: L1 3, five separable 11-tap blurs 220, SSIM 15;
# backward twice the forward
FLOP_LOSS = 3 * 3 * (3 + 220 + 15)
# per parameter: two moments 6, bias corrections 2, sqrt, add, divide 3,
# step 2
FLOP_ADAM = 13
ENTRY_BYTES = 10 * 4
N_PARAMS_ROW = 59


def power_limit() -> str:
    """The card's power limit as nvidia-smi reads it ('' where it
    cannot)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""


@torch.no_grad()
def blend_counts(params, live, cam: splat.Camera, sh_degree: int) -> dict:
    """Entries, evaluated and kept entry-pixels of one view."""
    rows, scr, _ = splat.project(params, live, cam, sh_degree)
    pairs, start, count, ntx, nty = splat.tile_lists(
        scr["mean"], scr["ext"], scr["z"], cam.height, cam.width)
    evals = kept = 0
    dev = start.device
    P = splat.TILE * splat.TILE
    t = torch.arange(ntx * nty, device=dev)
    p = torch.arange(P, device=dev)
    px = (t % ntx)[:, None] * splat.TILE + p % splat.TILE
    py = (t // ntx)[:, None] * splat.TILE + p // splat.TILE
    pix_in = (px < cam.width) & (py < cam.height)
    for tiles, k in splat._blocks(count):
        tl = torch.as_tensor(tiles, device=dev)
        j = torch.arange(k, device=dev)
        m = j[None] < count[tl][:, None]
        g = pairs[(start[tl][:, None] + j[None]).clamp(
            max=pairs.shape[0] - 1)]
        mean, conic = scr["mean"][g], scr["conic"][g]
        dx = px[tl][:, None].float() - mean[..., 0:1]
        dy = py[tl][:, None].float() - mean[..., 1:2]
        power = (-0.5 * (conic[..., 0:1] * dx * dx + conic[..., 2:3] * dy
                         * dy) - conic[..., 1:2] * dx * dy)
        alpha = torch.clamp(scr["op"][g][..., None] * torch.exp(power),
                            max=splat.ALPHA_MAX)
        gate = (power <= 0) & (alpha >= splat.ALPHA_MIN) & m[..., None]
        after = torch.cumprod(torch.where(gate, 1 - alpha, 1.0), 1)
        keep = (after >= splat.T_STOP) & m[..., None]
        n_keep = keep.sum(1)                                  # [nb, P]
        n_eval = torch.minimum(n_keep + 1, count[tl][:, None])
        inside = pix_in[tl]
        evals += int(torch.where(inside, n_eval, 0).sum())
        kept += int(torch.where(inside, n_keep, 0).sum())
    return {"rows": int(live.sum()), "entries": int(pairs.shape[0]),
            "tiles": ntx * nty, "pixels": cam.height * cam.width,
            "evals": evals, "kept": kept}


def work(views: List[tuple]) -> Dict[str, dict]:
    """Operations and bytes of K1, K2 and the whole step over the views of
    one step: views are (params, live, camera, sh degree)."""
    c = [blend_counts(*v) for v in views]
    s = {k: sum(x[k] for x in c) for k in c[0]}
    k1 = {"flops": FLOP_K1 * s["evals"],
          "bytes": ENTRY_BYTES * s["entries"] + 16 * s["tiles"]
          + 5 * 4 * s["pixels"]}
    k2 = {"flops": FLOP_K2 * s["kept"],
          "bytes": 2 * ENTRY_BYTES * s["entries"] + 16 * s["tiles"]
          + 5 * 4 * s["pixels"]}
    rows = sum(int(v[1].sum()) for v in views)
    # Adam updates each model's rows once, however many views it renders
    adam_rows = sum({id(v[0]["means"]): int(v[1].sum())
                     for v in views}.values())
    step = {"flops": k1["flops"] + k2["flops"] + FLOP_PROJ * rows
            + FLOP_LOSS * s["pixels"]
            + FLOP_ADAM * N_PARAMS_ROW * adam_rows}
    return {"K1": k1, "K2": k2, "step": step, "counts": s}


def roofline_pct(w: dict, seconds: float) -> float:
    """The kernel's least time by the peaks, as a share of its time."""
    return 100.0 * max(w["flops"] / PEAK_FLOPS,
                       w["bytes"] / PEAK_BYTES) / seconds


def bound_by(w: dict) -> str:
    return ("operations" if w["flops"] / PEAK_FLOPS
            >= w["bytes"] / PEAK_BYTES else "bytes")
