"""The comparison that decides `correct`.

A training cell is read as a few numbers, each held to its limit:
- a loss gap: the largest |L_port - L_ref| / |L_ref| over the compared
  steps and models;
- a leaf gap (a gradient's or a change's norm): for each leaf (one
  parameter tensor of one model), |n_port - n_ref| / max(n_ref, the median
  leaf's n_ref), and the worst leaf. Changes leave out the leaves whose
  reference gradient is under a thousandth of the median leaf's gradient:
  those move under Adam by round-off alone (an SH band the active degree
  masks, a rotation of an isotropic Gaussian);
- a statistic's gap (the norm of a densify statistic, each on its own:
  they are not leaves of one kind): |n_port - n_ref| / n_ref;
- the counts of a densify/prune step (rows cloned, rows split, rows
  pruned), each |n_port - n_ref| / max(n_ref, 1): whether a row reaches
  the gradient threshold is decided on a sum that rounds differently on
  the two sides, so a row at the threshold may go either way; and the
  norms of the rows after it, kept and new, each field on its own, as a
  leaf gap;
- exact counts, held to 0.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional

import torch

SMALL_GRAD = 1e-3


def norm(x: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(x.double()))


def loss_gap(port: List[List[float]], ref: List[List[float]]) -> float:
    return max(abs(p - r) / abs(r) for ps, rs in zip(port, ref)
               for p, r in zip(ps, rs))


def leaf_gap(port: Dict[str, float], ref: Dict[str, float],
             ref_grad: Optional[Dict[str, float]] = None) -> float:
    """The worst leaf's gap; with ref_grad, the leaves whose reference
    gradient is under SMALL_GRAD of the median leaf's are left out."""
    keys = list(ref)
    if ref_grad is not None:
        med_g = statistics.median(ref_grad[k] for k in keys)
        keys = [k for k in keys if ref_grad[k] >= SMALL_GRAD * med_g]
    med = statistics.median(ref[k] for k in keys)
    return max(abs(port[k] - ref[k]) / max(ref[k], med) for k in keys)


def densify_readings(before: Dict[str, torch.Tensor],
                     after: Dict[str, torch.Tensor]) -> dict:
    """The counts and row norms of one densify/prune step from its live
    rows before and after ({field: [n, ...]}), in whatever order each side
    keeps them. A row after it whose mean is, bit for bit, a row's before
    it is that row kept (its first copy) or cloned (every further copy);
    any other row is a split child, two a split row. A row before it that
    is not kept was split or pruned: pruned are those beyond the split
    rows. The row norms are those of every field of the kept rows and of
    the children, but for the children's means: they carry the split noise,
    which each side draws for itself."""
    key_in = before["means"].contiguous().view(torch.int32)
    key_out = after["means"].contiguous().view(torch.int32)
    n_in = key_in.shape[0]
    _, inv = torch.unique(torch.cat([key_in, key_out]), dim=0,
                          return_inverse=True)
    known = torch.zeros(int(inv.max()) + 1 if inv.numel() else 0,
                        dtype=torch.bool, device=inv.device)
    known[inv[:n_in]] = True
    old = known[inv[n_in:]]
    kept = int(torch.unique(inv[n_in:][old]).numel())
    children = int((~old).sum())
    counts = {"clone": int(old.sum()) - kept, "split": children / 2,
              "prune": n_in - kept - children / 2}
    rows = {}
    for f, x in after.items():
        rows["kept." + f] = norm(x[old])
        if f != "means":
            rows["children." + f] = norm(x[~old])
    return {"counts": counts, "rows": rows}


NOWHERE = 1e30


def _nowhere(x):
    """A reading of x's shape that no limit holds (finite, so that the
    result line stays JSON)."""
    if isinstance(x, dict):
        return {k: _nowhere(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_nowhere(v) for v in x]
    return NOWHERE


def gaps(port: dict, ref: dict) -> Dict[str, float]:
    """Every number a cell compares, from two sets of readings of the same
    shape: "loss" [steps][models], "grad" and "change" {leaf: norm}, and
    the same under "pose_" for a pose fit; "stats" {name: norm};
    "densify" (`densify_readings`); "frames"
    (the frame each step drew) and "count_" keys are exact."""
    out = {}
    port = {k: v for k, v in port.items() if v is not None}
    for k in set(ref) - set(port):
        # a reading the port never gave (a step it never took) fails
        port[k] = _nowhere(ref[k])
    for pre in ("", "pose_"):
        if pre + "loss" not in ref:
            continue
        out[pre + "loss"] = loss_gap(port[pre + "loss"], ref[pre + "loss"])
        out[pre + "grad"] = leaf_gap(port[pre + "grad"], ref[pre + "grad"])
        out[pre + "change"] = leaf_gap(port[pre + "change"],
                                       ref[pre + "change"], ref[pre + "grad"])
    for k, r in ref.get("stats", {}).items():
        out[f"stats_{k}"] = abs(port["stats"][k] - r) / r
    if "densify" in ref:
        for k, r in ref["densify"]["counts"].items():
            out[f"densify_{k}"] = abs(port["densify"]["counts"][k] - r) / max(
                r, 1.0)
        out["densify_rows"] = leaf_gap(port["densify"]["rows"],
                                       ref["densify"]["rows"])
    if "frames" in ref:
        out["count_frames"] = float(sum(
            tuple(a) != tuple(b) for a, b in zip(port["frames"], ref["frames"])))
    for k in ref:
        if k.startswith("count_"):
            out[k] = float(abs(port[k] - ref[k]))
    return out
