"""Faults planted in the port under a run, to show that the comparison
catches them (`tests/test_faults.py` on the CPU, `calibrate.py` on the
card, where they give a limit its upper reading):
- "unchanged": a training step returns its state unchanged (the fit, pose
  and single-model steps give back the models, poses and optimizer they
  were handed);
- "half": half of the batch left out, the mean taken over the rest (the
  second half of a batch of models, or the lower half of a single image's
  rows, out of the loss);
- "altered": the answer altered where it is produced (every rendered image
  scaled by 0.999);
- "densify": densify/prune with its gradient threshold lost, so that no
  row is cloned or split (pruning still runs); only a cell whose compared
  steps densify can show it, and its job lists it in its FAULTS.
One chip is all a cell uses, so there is no exchange between chips to
leave out."""

from __future__ import annotations

import contextlib
import importlib

COMMON = ("unchanged", "half", "altered")
FAULTS = COMMON + ("densify",)


def of(job_module) -> tuple:
    """The faults a job's compared steps can show."""
    return getattr(job_module, "FAULTS", COMMON)


def _patch(stack, module, name, make):
    m = importlib.import_module(module)
    fn = getattr(m, name)
    setattr(m, name, make(fn))
    stack.callback(setattr, m, name, fn)


@contextlib.contextmanager
def planted(fault: str):
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    with contextlib.ExitStack() as stack:
        if fault == "unchanged":
            def keep(fn):
                # fit_step(state, opt, ...), gaussian_train_step(state,
                # opt, ...), pose_step(state, deltas, bases, opt, ...)
                given = (1, 3) if fn.__name__ == "pose_step" else (0, 1)

                def step(*a, **kw):
                    out = fn(*a, **kw)
                    return (a[given[0]], a[given[1]]) + tuple(out[2:])
                return step

            _patch(stack, "ht3dgs_torch.train.phase_a", "fit_step", keep)
            _patch(stack, "ht3dgs_torch.train.phase_a", "pose_step", keep)
            _patch(stack, "ht3dgs_torch.train.step", "gaussian_train_step",
                   keep)
        elif fault == "half":
            def half(fn):
                def loss(image, gt, *a, **kw):
                    if image.ndim == 4:
                        out = fn(image, gt, *a, **kw)
                        keep = (image.new_ones(image.shape[0])
                                * (image.new_tensor(range(image.shape[0]))
                                   < image.shape[0] // 2))
                        return {k: v * keep for k, v in out.items()}
                    h = image.shape[0] // 2
                    return fn(image[:h], gt[:h], *a, **kw)
                return loss

            _patch(stack, "ht3dgs_torch.train.phase_a", "compute_loss", half)
            _patch(stack, "ht3dgs_torch.train.step", "compute_loss", half)
        elif fault == "densify":
            def threshold_lost(fn):
                def densify_and_prune(state, opt, noise, max_grad, *a, **kw):
                    return fn(state, opt, noise, float("inf"), *a, **kw)
                return densify_and_prune

            _patch(stack, "ht3dgs_torch.train.step", "densify_and_prune",
                   threshold_lost)
        else:
            def scaled(fn):
                def assemble(*a, **kw):
                    out = fn(*a, **kw)
                    out["image"] = out["image"] * 0.999
                    return out
                return assemble

            _patch(stack, "ht3dgs_torch.raster.tiled", "_assemble", scaled)
        yield
