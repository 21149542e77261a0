"""Evaluation helpers, counterpart of part of `ht3dgs.train.evals`.

Only `settle_eval_tile_args` is ported: `evaluate_on_training_images` calls
it. eval_nvs, eval_pose and render_nvs come with the eval slice (ROADMAP).
"""

from __future__ import annotations

from . import step as step_lib


def settle_eval_tile_args(trainer, state, camera, max_k: int = 16384):
    """Grow the tile capacities until an eval render of `state` drops
    nothing (max_per_tile x2 up to max_k, dup_factor x2 up to 64): a
    trainer's preset capacities may silently truncate a big merged model.
    Returns the settled tile_args tuple and sets trainer._tile_args."""
    ta = dict(trainer._tile_args) if trainer._tile_args else {}
    ta.setdefault("max_per_tile", 1024)
    ta.setdefault("dup_factor", 16)
    for _ in range(6):
        out = step_lib.render_eval(state, camera, mode=trainer._mode,
                                   tile_args=dict(ta))
        nd_t = int(out.get("n_dropped_tile", 0))
        nd_m = int(out.get("n_dropped_m", 0))
        if nd_t == 0 and nd_m == 0:
            break
        if nd_t:
            if ta["max_per_tile"] >= max_k:
                break
            ta["max_per_tile"] = min(2 * ta["max_per_tile"], max_k)
        if nd_m:
            ta["dup_factor"] = min(2 * ta["dup_factor"], 64)
        trainer.logger.info(f"[eval] tile capacity grown for eval: {ta} "
                            f"(nd_tile={nd_t}, nd_m={nd_m})")
    trainer._tile_args = tuple(sorted(ta.items()))
    return trainer._tile_args
