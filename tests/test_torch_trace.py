"""The port's tracer (`ht3dgs_torch.utils.profiling`: span, count,
tracing) on the CPU: the span tree of the trainer's iterations, nothing
recorded or touched with tracing off, the render's counters against
`binning_fill` and the state's live rows, and the spans in a
torch.profiler trace."""

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ht3dgs_torch.core.camera import make_camera  # noqa: E402
from ht3dgs_torch.core import adam  # noqa: E402
from ht3dgs_torch.data.readers import FrameInfo, SceneInfo  # noqa: E402
from ht3dgs_torch.raster import render, render_batched  # noqa: E402
from ht3dgs_torch.train import phase_a  # noqa: E402
from ht3dgs_torch.train import step as t_step  # noqa: E402
from ht3dgs_torch.train.hierarchy import (HTGaussianTrainer,  # noqa: E402
                                          ModelBundle)
from ht3dgs_torch.utils import profiling, synthetic  # noqa: E402
from ht3dgs_torch.utils.config import load_configs  # noqa: E402

from port_utils import torch_threads_per_worker  # noqa: E402,F401

H, W = 24, 32
# a small M and K, so the binning drops at both
TILE_ARGS = {"tile_h": 8, "tile_w": 16, "max_per_tile": 16,
             "dup_factor": 1}
STEP_CHILDREN = {"projection", "binning", "blend", "assemble", "loss",
                 "backward", "stats", "adam"}


@pytest.fixture(scope="module")
def scene():
    return synthetic.generate(n_frames=3, height=H, width=W,
                              n_gaussians=120, seed=3, device="cpu")


def _trainer(scene, tmp_path):
    model, pipe, optim = load_configs()
    model.expname, model.category, model.seq_name = "trace", "synt", "t"
    pipe.render_mode = "tiled"
    frames = [FrameInfo(uid=k, image_path=None, image_name=f"{k:04d}",
                        width=W, height=H, intrinsics=scene.intrinsics,
                        fovx=1.2, fovy=1.0, _image=scene.frames[k])
              for k in range(len(scene.frames))]
    info = SceneInfo(train_frames=frames, test_frames=[],
                     i_train=np.arange(len(frames)),
                     i_test=np.array([], np.int64), nerf_radius=1.0)

    class InMemory(HTGaussianTrainer):
        def setup_dataset(self):
            self.set_scene(info)

    here = os.getcwd()
    os.chdir(tmp_path)
    try:
        tr = InMemory("", model, pipe, optim, seed=0, device="cpu")
    finally:
        os.chdir(here)
    tr.set_scene(info)
    st = scene.state
    bundle = ModelBundle(state=st, opt=adam.init(st.params()), radius=2.0,
                         spatial_scale=2.0, poses=scene.poses_w2c.copy())
    return tr, bundle


def test_trainer_iterations_give_the_span_tree(scene, tmp_path):
    """Two iterations of MSS phase 2: each an `iteration` span with its
    trainer iteration as the id of every span inside it, frame, lrs and
    step under it, the step's layers under the step, each child inside its
    parent's interval; `tune` only on the step that reads the counters."""
    tr, bundle = _trainer(scene, tmp_path)
    tr.global_iteration = 20
    tr._steps_since_tune = 49
    with profiling.tracing() as t:
        tr.train_nonleaf_phase2(bundle, [0, 1, 2], 2)
    spans = t.spans
    assert all(s["end_ns"] is not None for s in spans)
    its = [s for s in spans if s["name"] == "iteration"]
    assert [s["step"] for s in its] == [21, 22]
    assert all(s["parent"] is None for s in its)
    for s in spans:
        if s["parent"] is None:
            continue
        p = spans[s["parent"]]
        assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] <= p["end_ns"]
        assert s["step"] == p["step"]
    for it, tuned in zip(its, (True, False)):
        kids = [s for s in spans if s["parent"] == it["id"]]
        names = {s["name"] for s in kids}
        assert names == {"frame", "lrs", "step"} | ({"tune"} if tuned
                                                    else set()), names
        (step,) = [s for s in kids if s["name"] == "step"]
        layers = {s["name"] for s in spans if s["parent"] == step["id"]}
        assert layers == STEP_CHILDREN, layers


def test_off_records_and_touches_nothing(scene, tmp_path, monkeypatch):
    """With tracing off no span is made and no counter's value is read:
    `span` hands back one shared object."""
    tr, bundle = _trainer(scene, tmp_path)

    def refuse(*a, **kw):
        raise AssertionError("tracing is off")

    monkeypatch.setattr(profiling._Span, "__init__", refuse)
    monkeypatch.setattr(profiling.Trace, "_add", refuse)

    class Untouchable:
        def __getattr__(self, name):
            raise AssertionError(f"count read .{name}")

    assert profiling.span("step") is profiling.span("adam", step=3)
    profiling.count("entries", Untouchable())
    tr.train_nonleaf_phase2(bundle, [0, 1, 2], 1)
    assert profiling._trace is None


def _pseudo_first(indices, ratio):
    """A random stream whose first phase-1 step is a pseudo step."""
    import random

    for seed in range(100):
        r = random.Random(seed)
        r.choice(indices)
        if r.random() < ratio:
            return random.Random(seed)
    raise AssertionError("no seed")


@pytest.mark.parametrize("traced", [True, False])
def test_pseudo_step_records_its_span_and_counters(scene, tmp_path, traced,
                                                   monkeypatch):
    """One MSS phase 1 step on a pseudo-view: with tracing on, one `pseudo`
    span inside the iteration's `frame` span, `pseudo_views` 1, and the
    child render's live rows and drops at K (a small K, so that it drops)
    in `pseudo_rows` and `pseudo_dropped_k`, equal to the render's own
    `live_rows` and `dropped_k` of that render; with tracing off nothing
    is made and no counter's value read."""
    tr, bundle = _trainer(scene, tmp_path)
    tr._tile_args = tuple(sorted(TILE_ARGS.items()))
    st = bundle.state
    children = [ModelBundle(state=st, opt=bundle.opt, radius=2.0,
                            spatial_scale=2.0, poses=bundle.poses,
                            start_fidx=k, to_visit_frames=[k, k + 1])
                for k in (0, 1)]
    tr.rng = _pseudo_first([0, 1, 2], tr.sched.mss_phase1_ratio)
    tr.global_iteration = 20
    pseudo_view = tr._pseudo_view
    rendered = []

    def kept(*a):
        rendered.append(a)
        return pseudo_view(*a)

    tr._pseudo_view = kept
    if not traced:
        def refuse(*a, **kw):
            raise AssertionError("tracing is off")

        monkeypatch.setattr(profiling._Span, "__init__", refuse)
        monkeypatch.setattr(profiling.Trace, "_add", refuse)
        tr.train_nonleaf_phase1(bundle, children, 1)
        assert profiling._trace is None and len(rendered) == 1
        return
    with profiling.tracing() as t:
        tr.train_nonleaf_phase1(bundle, children, 1)
    assert len(rendered) == 1
    spans = t.spans
    (pseudo,) = [s for s in spans if s["name"] == "pseudo"]
    frame = spans[pseudo["parent"]]
    assert frame["name"] == "frame" and frame["step"] == 21
    assert spans[frame["parent"]]["name"] == "iteration"
    inside = [s for s in spans if s["parent"] == pseudo["id"]]
    assert {s["name"] for s in inside} == {"projection", "binning", "blend",
                                           "assemble"}
    c = t.counters
    assert c["pseudo_views"] == 1
    # the child's render and the root's step each add to the render's own
    # counters: the root's rows are the child's here
    assert c["pseudo_rows"] == int(st.n_live()) == c["live_rows"] // 2
    assert 0 < c["pseudo_dropped_k"] <= c["dropped_k"]


def _fill(records):
    out = {"entries": 0, "slots": 0, "dropped_m": 0, "dropped_k": 0}
    for r in records:
        out["entries"] += r["n_entries"]
        out["slots"] += r["M"]
        out["dropped_m"] += r["dropped_m"]
        out["dropped_k"] += r["dropped_tile"]
    return out


@pytest.mark.parametrize("batched", [False, True])
def test_render_counters_equal_binning_fill(scene, batched):
    """The binning's and the projection's counters of one render (single,
    or B = 2 models stacked) against `binning_fill` of each model and its
    live rows and capacity, the same state, camera and tile arguments."""
    st = scene.state
    # a second model with a quarter of its rows dead
    live = st.live.clone()
    live[::4] = False
    states = [st, dataclasses.replace(st, live=live)]
    cams = [make_camera(H, W, scene.intrinsics, world_view=p, device="cpu")
            for p in scene.poses_w2c[:2]]
    n = 2 if batched else 1
    want = _fill([profiling.binning_fill(s, c, TILE_ARGS)[0]
                  for s, c in zip(states[:n], cams[:n])])
    assert want["dropped_m"] > 0 and want["dropped_k"] > 0
    want["live_rows"] = sum(int(s.n_live()) for s in states[:n])
    want["capacity_rows"] = sum(s.capacity for s in states[:n])
    with torch.no_grad(), profiling.tracing() as t:
        if batched:
            out = render_batched(phase_a.stack_states(states),
                                 phase_a.stack_cameras(cams), mode="tiled",
                                 tile_args=TILE_ARGS)
        else:
            out = render(st, cams[0], mode="tiled", tile_args=TILE_ARGS)
    want["valid_rows"] = int(out["valid"].sum())
    got = dict(t.counters)
    assert got.pop("dropped_compact") == 0
    assert got == want


@pytest.mark.parametrize("traced", [True, False])
def test_valid_rows_counts_the_projection(scene, traced, monkeypatch):
    """`valid_rows`, with tracing on, is the sum of the projection's
    valid over every render of the block; with tracing off nothing is
    counted (the counter's value is never read)."""
    cam = make_camera(H, W, scene.intrinsics, world_view=scene.poses_w2c[0],
                      device="cpu")
    import ht3dgs_torch.raster as raster

    real, seen = raster.project, []

    def spy(*a, **kw):
        proj = real(*a, **kw)
        seen.append(proj.valid)
        return proj

    monkeypatch.setattr(raster, "project", spy)
    if not traced:
        def refuse(*a, **kw):
            raise AssertionError("tracing is off")
        monkeypatch.setattr(profiling.Trace, "_add", refuse)
        with torch.no_grad():
            render(scene.state, cam, mode="tiled", tile_args=TILE_ARGS)
        assert profiling._trace is None and len(seen) == 1
        return
    with torch.no_grad(), profiling.tracing() as t:
        for _ in range(2):
            render(scene.state, cam, mode="tiled", tile_args=TILE_ARGS)
    assert len(seen) == 2 and seen[0].any()
    assert t.counters["valid_rows"] == sum(int(v.sum()) for v in seen)
    assert t.counters["live_rows"] == 2 * int(scene.state.n_live())


def test_spans_without_counters(scene):
    """tracing(counters=False), as profile_step takes it: the render's
    spans, and no counter touched."""
    cam = make_camera(H, W, scene.intrinsics, world_view=scene.poses_w2c[0],
                      device="cpu")
    with torch.no_grad(), profiling.tracing(counters=False) as t:
        render(scene.state, cam, mode="tiled", tile_args=TILE_ARGS)
    assert t.counters == {}
    assert [s["name"] for s in t.spans] == ["projection", "binning",
                                            "binning", "blend", "assemble"]


def test_torch_trace_holds_the_step_spans(scene, tmp_path):
    """torch_trace with tracing() around one tiny step writes a trace whose
    ranges include the step's spans."""
    st = scene.state
    cam = make_camera(H, W, scene.intrinsics, world_view=scene.poses_w2c[0],
                      device="cpu")
    gt = torch.as_tensor(scene.frames[0])
    log_dir = str(tmp_path / "trace")
    lrs = {k: 1e-3 for k in ("means", "sh_dc", "sh_rest", "opacity_logit",
                             "log_scales", "quats")}
    with profiling.torch_trace(log_dir), profiling.tracing() as t:
        t_step.gaussian_train_step(st, adam.init(st.params()), cam, gt, lrs,
                                   mode="tiled", tile_args=TILE_ARGS)
    (name,) = [f for f in os.listdir(log_dir)
               if f.endswith(".pt.trace.json")]
    with open(os.path.join(log_dir, name)) as f:
        ranges = {e.get("name") for e in json.load(f)["traceEvents"]
                  if e.get("cat") == "user_annotation"}
    assert {"step"} | STEP_CHILDREN <= ranges, ranges
    assert {s["name"] for s in t.spans} == {"step"} | STEP_CHILDREN
