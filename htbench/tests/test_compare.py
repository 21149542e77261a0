"""The densify/prune readings on a hand-made step: ten rows, of which two
are cloned, three split (one of them with both children pruned) and one
pruned; the rows after it in another order than the step made them."""

import pytest
import torch

from htbench import compare


def rows(means):
    n = means.shape[0]
    return {"means": means, "log_scales": torch.arange(n * 3.0).view(n, 3),
            "opacity_logit": torch.ones(n, 1)}


def test_densify_counts_do_not_depend_on_row_order():
    before = rows(torch.arange(30.0).view(10, 3))
    kept = [0, 1, 2, 3, 4, 5]                  # 6, 7, 8 split, 9 pruned
    clones = [1, 4]
    split = [6, 7]                             # 8's children pruned
    children = before["means"][split].repeat(2, 1) + 0.5
    after = {f: torch.cat([x[kept], x[clones], x[split].repeat(2, *[1] * (
        x.ndim - 1))]) for f, x in before.items()}
    after["means"] = torch.cat([before["means"][kept],
                                before["means"][clones], children])
    order = torch.randperm(after["means"].shape[0],
                           generator=torch.Generator().manual_seed(3))
    after = {f: x[order] for f, x in after.items()}
    got = compare.densify_readings(before, after)
    # pruned: row 9, and row 8, split with both children pruned
    assert got["counts"] == {"clone": 2, "split": 2.0, "prune": 2.0}
    assert "children.means" not in got["rows"]
    assert got["rows"]["kept.means"] == pytest.approx(compare.norm(
        before["means"][kept + clones]))


def test_a_reading_the_port_never_gave_fails():
    ref = {"loss": [[1.0]], "grad": {"a": 1.0, "b": 2.0},
           "change": {"a": 1.0, "b": 2.0}, "stats": {"accum": 1.0},
           "densify": {"counts": {"clone": 4, "split": 2.0, "prune": 0.0},
                       "rows": {"kept.means": 3.0}}}
    port = dict(ref, densify=None, stats=None)
    got = compare.gaps(port, ref)
    assert got["densify_clone"] > 1e20 and got["stats_accum"] > 1e20
    assert got["loss"] == 0.0
