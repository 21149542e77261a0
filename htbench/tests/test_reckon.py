"""The operation and byte counts of K1, K2 and the step on a hand-worked
case: five large Gaussians stacked in depth over the one 16x16 tile of a
16x16 image, each with opacity 0.95 (alpha just under 0.95 at every
pixel). A pixel's transmittance after k of them is about 0.05^k: 1.25e-4
after three, 6.25e-6 after four, so every pixel keeps three entries and
evaluates four (the fourth stops it)."""

import math

import torch

from htbench import reckon
from htbench.reference import splat

N, P = 5, 256


def view():
    dev = torch.device("cpu")
    params = {
        "means": torch.tensor([[0.0, 0.0, 5.0 + 0.1 * i] for i in range(N)]),
        "quats": torch.tensor([[0.0, 0.0, 0.0, 1.0]] * N),
        "log_scales": torch.full((N, 3), math.log(50.0)),
        "sh_dc": torch.zeros(N, 1, 3), "sh_rest": torch.zeros(N, 15, 3),
        "opacity_logit": torch.full((N, 1), math.log(0.95 / 0.05)),
    }
    cam = splat.Camera(torch.eye(4), [[10.0, 0, 8.0], [0, 10.0, 8.0],
                                      [0, 0, 1]], 16, 16, dev)
    return params, torch.ones(N, dtype=torch.bool), cam, 0


def test_counts_by_hand():
    c = reckon.blend_counts(*view())
    assert c == {"rows": N, "entries": N, "tiles": 1, "pixels": P,
                 "evals": 4 * P, "kept": 3 * P}


def test_work_by_hand():
    w = reckon.work([view()])
    assert w["K1"] == {"flops": 28 * 4 * P,
                       "bytes": 40 * N + 16 + 20 * P}
    assert w["K2"] == {"flops": 66 * 3 * P,
                       "bytes": 80 * N + 16 + 20 * P}
    assert w["step"]["flops"] == (28 * 4 * P + 66 * 3 * P + 903 * N
                                  + 9 * 238 * P + 13 * 59 * N)


def test_roofline_share():
    w = {"flops": 67e9, "bytes": 3.35e9}       # 1 ms by either bound
    assert abs(reckon.roofline_pct(w, 2e-3) - 50.0) < 1e-9
    assert reckon.bound_by({"flops": 1.0, "bytes": 1e6}) == "bytes"
