"""The readers and layouts of the published configs (configs/tanks/*.yml,
configs/co3d/*.yml) held to the JAX package on the CPU: the COLMAP parsers
and writers, `read_colmap` (the tanks eval set), `read_co3d`, the
images_only reader above the 1.6K cap, the 13 configs and their mode paths,
`eval_pose` on a test split, and the photo scene's Tanks and CO3D writers.
Exact where the code is a copy; the two behaviours shared with the JAX
package that a repair would change (the floor-divided focal above 1600 px,
eval_pose's test frames against the train poses) are pinned as they are."""

import dataclasses
import glob
import gzip
import json
import os
import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")
PIL_Image = pytest.importorskip("PIL.Image")

from ht3dgs.data import colmap as j_colmap  # noqa: E402
from ht3dgs.data import readers as j_readers  # noqa: E402
from ht3dgs.train import evals as j_evals  # noqa: E402
from ht3dgs.train.hierarchy import HTGaussianTrainer as JTrainer  # noqa: E402
from ht3dgs.utils import config as j_config  # noqa: E402
from ht3dgs_torch.data import colmap as t_colmap  # noqa: E402
from ht3dgs_torch.data import readers as t_readers  # noqa: E402
from ht3dgs_torch.train import evals as t_evals  # noqa: E402
from ht3dgs_torch.train import hierarchy as t_hier  # noqa: E402
from ht3dgs_torch.utils import config as t_config  # noqa: E402
from ht3dgs_torch.utils import photo_scene  # noqa: E402
from ht3dgs_torch.utils.image import write_png  # noqa: E402
from ht3dgs_torch.utils.profiling import StepCounter  # noqa: E402

from port_utils import torch_threads_per_worker  # noqa: E402,F401

TTrainer = t_hier.HTGaussianTrainer
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*", "*.yml")))
FAMILY_FOVX = 1.369319187580747


def _same_frames(got, ref, pixels=()):
    """Two SceneInfos equal field by field; pixels of the frames at the
    given positions (train then test order) too."""
    np.testing.assert_array_equal(got.i_train, ref.i_train)
    np.testing.assert_array_equal(got.i_test, ref.i_test)
    assert got.nerf_radius == ref.nerf_radius
    for a, b in ((got.points, ref.points), (got.colors, ref.colors)):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    frames = list(zip(got.train_frames + got.test_frames,
                      ref.train_frames + ref.test_frames))
    assert len(frames) == len(ref.train_frames) + len(ref.test_frames)
    for g, r in frames:
        assert (g.uid, g.image_path, g.image_name, g.width, g.height,
                g.fovx, g.fovy, g.depth_path) == \
            (r.uid, r.image_path, r.image_name, r.width, r.height, r.fovx,
             r.fovy, r.depth_path)
        for x, y in ((g.intrinsics, r.intrinsics), (g.R, r.R), (g.T, r.T)):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    for i in pixels:
        g, r = frames[i]
        gi, ri = g.load_image(), np.asarray(r.load_image())
        assert gi.dtype == ri.dtype and np.array_equal(gi, ri)


def _random_poses(rng, n):
    poses = []
    for _ in range(n):
        q = rng.standard_normal(4)
        w2c = np.eye(4)
        w2c[:3, :3] = j_colmap.qvec2rotmat(q / np.linalg.norm(q))
        w2c[:3, 3] = rng.standard_normal(3)
        poses.append(w2c)
    return poses


# ---------------------------------------------------------------------------
# data/colmap.py
# ---------------------------------------------------------------------------

def _write_full_binary(d, rng):
    """A COLMAP binary model with every camera model, 2D points per image
    and tracks per point (the writers write neither), by the format."""
    ids = sorted(j_colmap.CAMERA_MODELS)
    with open(os.path.join(d, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(ids)))
        for cid, mid in enumerate(ids, 1):
            n = j_colmap.CAMERA_MODELS[mid][1]
            f.write(struct.pack("<iiQQ", cid, mid, 640 + cid, 480 - cid))
            f.write(struct.pack(f"<{n}d", *rng.uniform(1, 500, n)))
    with open(os.path.join(d, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", 5))
        for i in range(5):
            f.write(struct.pack("<idddddddi", 10 + i, *rng.standard_normal(7),
                                1 + i % len(ids)))
            f.write(f"img_{4 - i}.jpg".encode() + b"\x00")
            f.write(struct.pack("<Q", i))
            for _ in range(i):
                f.write(struct.pack("<ddq", *rng.standard_normal(2), -1))
    with open(os.path.join(d, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", 7))
        for i in range(7):
            f.write(struct.pack("<QdddBBBd", i + 3, *rng.standard_normal(3),
                                *rng.integers(0, 256, 3).tolist(),
                                float(rng.random())))
            f.write(struct.pack("<Q", i))
            f.write(struct.pack(f"<{2 * i}i", *range(2 * i)))


def _write_text(d, rng):
    with open(os.path.join(d, "cameras.txt"), "w") as f:
        f.write("# Camera list\n")
        for cid, (name, n) in enumerate(j_colmap.CAMERA_MODELS.values(), 1):
            params = " ".join(f"{p:.17g}" for p in rng.uniform(1, 500, n))
            f.write(f"{cid} {name} {320 + cid} {240 + cid} {params}\n")
    with open(os.path.join(d, "images.txt"), "w") as f:
        f.write("# Image list\n#   IMAGE_ID, QW, ...\n")
        for i in range(4):
            vals = " ".join(f"{v:.17g}" for v in rng.standard_normal(7))
            f.write(f"{i + 1} {vals} 1 frame_{i:03d}.png\n")
            f.write("1.5 2.5 -1 3.5 4.5 7\n")
    with open(os.path.join(d, "points3D.txt"), "w") as f:
        f.write("# 3D point list\n\n")
        for i in range(6):
            xyz = " ".join(f"{v:.17g}" for v in rng.standard_normal(3))
            rgb = " ".join(str(v) for v in rng.integers(0, 256, 3))
            f.write(f"{i + 1} {xyz} {rgb} {rng.random():.17g} 1 0 2 1\n")


def _same_model(got, ref):
    (gc, gi, gp), (rc, ri, rp) = got, ref
    assert list(gc) == list(rc) and list(gi) == list(ri)
    for k in rc:
        a, b = gc[k], rc[k]
        assert (a.id, a.model, a.width, a.height) == \
            (b.id, b.model, b.width, b.height)
        np.testing.assert_array_equal(a.params, b.params)
    for k in ri:
        a, b = gi[k], ri[k]
        assert (a.id, a.camera_id, a.name) == (b.id, b.camera_id, b.name)
        np.testing.assert_array_equal(a.qvec, b.qvec)
        np.testing.assert_array_equal(a.tvec, b.tvec)
    assert (gp is None) == (rp is None)
    for a, b in zip(gp or (), rp or ()):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("form", ["binary", "text"])
def test_colmap_parsers_equal_jax(form, tmp_path):
    """read_model (and each parser under it) of a model with every camera
    model, 2D point lists and tracks: the JAX parser's values exactly."""
    rng = np.random.default_rng(5)
    (_write_full_binary if form == "binary" else _write_text)(
        str(tmp_path), rng)
    got = t_colmap.read_model(str(tmp_path))
    _same_model(got, j_colmap.read_model(str(tmp_path)))
    assert len(got[0]) == len(t_colmap.CAMERA_MODELS)
    assert len(got[2][0]) == (7 if form == "binary" else 6)


def test_colmap_writers_and_intrinsics_equal_jax(tmp_path):
    """write_model's bytes, rotmat2qvec / qvec2rotmat (both branches of the
    quaternion), and camera_intrinsics for every camera model: the JAX
    package's exactly (ValueError for the models it does not take)."""
    rng = np.random.default_rng(6)
    poses = _random_poses(rng, 8)
    poses.append(np.diag([1.0, -1.0, -1.0, 1.0]))   # trace < 0
    for w2c in poses:
        q = t_colmap.rotmat2qvec(w2c[:3, :3])
        np.testing.assert_array_equal(q, j_colmap.rotmat2qvec(w2c[:3, :3]))
        np.testing.assert_array_equal(t_colmap.qvec2rotmat(q),
                                      j_colmap.qvec2rotmat(q))
    xyz, rgb = rng.standard_normal((9, 3)), rng.random((9, 3))
    for cl, d in ((t_colmap, tmp_path / "t"), (j_colmap, tmp_path / "j")):
        cams = {1: cl.ColmapCamera(1, "PINHOLE", 64, 36,
                                   np.array([50.0, 51.0, 32.0, 18.0]))}
        images = {i + 1: cl.ColmapImage(
            i + 1, cl.rotmat2qvec(w2c[:3, :3]), w2c[:3, 3], 1,
            f"{i:06d}.png") for i, w2c in enumerate(poses)}
        cl.write_model(str(d), cams, images, xyz, rgb)
    for name in ("cameras.bin", "images.bin", "points3D.bin"):
        assert (tmp_path / "t" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes()

    accepted = 0
    for name, n in t_colmap.CAMERA_MODELS.values():
        params = rng.uniform(1, 500, n)
        got = t_colmap.ColmapCamera(1, name, 64, 48, params)
        ref = j_colmap.ColmapCamera(1, name, 64, 48, params)
        try:
            want = j_colmap.camera_intrinsics(ref)
        except ValueError:
            with pytest.raises(ValueError):
                t_colmap.camera_intrinsics(got)
            continue
        K = t_colmap.camera_intrinsics(got)
        assert K.dtype == want.dtype and np.array_equal(K, want)
        accepted += 1
    assert accepted == 6


# ---------------------------------------------------------------------------
# data/readers.py
# ---------------------------------------------------------------------------

def _colmap_scene(root, n, w, h, fx, rng, png=True):
    """A PINHOLE COLMAP model of n random poses (names out of order in the
    model) with smooth PNG frames of w x h under images/."""
    poses = _random_poses(rng, n)
    cams = {3: t_colmap.ColmapCamera(3, "PINHOLE", w, h,
                                     np.array([fx, fx * 1.01, w / 2 + 0.5,
                                               h / 2 - 0.25]))}
    images = {i + 1: t_colmap.ColmapImage(
        i + 1, t_colmap.rotmat2qvec(p[:3, :3]), p[:3, 3], 3,
        f"{(i * 7) % n:06d}.png") for i, p in enumerate(poses)}
    t_colmap.write_model(os.path.join(root, "sparse", "0"), cams, images,
                         rng.standard_normal((5, 3)), rng.random((5, 3)))
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    if png:
        yy, xx = np.mgrid[0:h, 0:w]
        for i in range(n):
            rgb = np.stack([(xx * (i + 1) + yy) % 256, (3 * yy + i) % 256,
                            (xx ^ yy) % 256], -1).astype(np.uint8)
            write_png(os.path.join(root, "images", f"{i:06d}.png"), rgb)


@pytest.mark.parametrize("layout,n,w,h,pixels", [
    ("Francis", 17, 48, 30, (0, 15)),   # sample rate 8
    ("Family", 9, 48, 30, (1, 8)),      # sample rate 2
    ("Ignatius", 3, 1920, 1080, (0,)),  # over the cap: 1600x900, LANCZOS
])
def test_read_colmap_equal_jax(layout, n, w, h, pixels, tmp_path):
    """read_colmap, the eval set of every configs/tanks/*.yml: splits, K
    scaled to the load size, R, T, names, radius, points and decoded
    pixels equal the JAX reader's exactly."""
    root = str(tmp_path / "Tanks" / layout)
    _colmap_scene(root, n, w, h, 0.6 * w, np.random.default_rng(n))
    got = t_readers.read_colmap(root)
    _same_frames(got, j_readers.read_colmap(root), pixels)
    assert len(got.i_test) == len(range(
        (8 if layout != "Family" else 2) // 2, n,
        8 if layout != "Family" else 2))
    assert (got.train_frames[0].width, got.train_frames[0].height) == \
        ((1600, 900) if w > 1600 else (w, h))
    assert [f.image_name for f in got.train_frames[:2]] == \
        [f"{i:06d}" for i in got.i_train[:2]]


def _co3d_entries(seq, n, rng, size=(30, 40)):
    h, w = size
    return [{
        "sequence_name": seq, "frame_number": i,
        "image": {"path": f"hydrant/{seq}/images/frame{i + 1:06d}.png",
                  "size": [h, w]},
        "depth": {"path": f"hydrant/{seq}/depths/frame{i + 1:06d}.png"
                          ".geometric.png"},
        "viewpoint": {"R": j_colmap.qvec2rotmat(rng.standard_normal(4) / 2)
                      .tolist(),
                      "T": rng.standard_normal(3).tolist(),
                      "focal_length": rng.uniform(1.5, 2.5, 2).tolist(),
                      "principal_point": rng.uniform(-0.1, 0.1, 2).tolist()}}
        for i in range(n)]


def test_read_co3d_equal_jax(tmp_path):
    """read_co3d on a frame_annotations.jgz of two sequences, in the
    configs' layout ({data_path}/{category}/{subdir}/, category "co3d"):
    the config's sequence only, its stride-8 split, K from the NDC
    annotation, R, T, paths, the depth names the trainer asks for
    ({basename}.npy, extension kept) and pixels equal the JAX reader's."""
    rng = np.random.default_rng(8)
    root = tmp_path / "data" / "co3d"
    ann = root / "co3d" / "hydrant"
    ann.mkdir(parents=True)
    entries = (_co3d_entries("106_12648_23157", 11, rng)
               + _co3d_entries("999_1_2", 4, rng, size=(20, 24)))
    rng.shuffle(entries)
    with gzip.open(ann / "frame_annotations.jgz", "wt") as f:
        json.dump(entries, f)
    for e in entries:
        if e["sequence_name"] == "106_12648_23157":
            p = root / e["image"]["path"]
            p.parent.mkdir(parents=True, exist_ok=True)
            write_png(str(p), rng.integers(0, 256, (30, 40, 3), np.uint8))
    args = (str(root), "co3d", "hydrant_106_12648_23157")
    got = t_readers.read_co3d(*args)
    _same_frames(got, j_readers.read_co3d(*args), pixels=(0, 9, 10))
    np.testing.assert_array_equal(got.i_test, [4])
    order = [e for e in entries if e["sequence_name"] == "106_12648_23157"]
    for f, e in zip(sorted(got.train_frames + got.test_frames,
                           key=lambda f: f.uid), order):
        assert f.image_path == str(root / e["image"]["path"])
        assert f.image_name + ".npy" == os.path.basename(
            e["image"]["path"]) + ".npy"
        assert f.image_name.endswith(".png")
    for _ in range(3):
        pp, fl = rng.uniform(-0.2, 0.2, 2), rng.uniform(1, 3, 2)
        R, T = rng.standard_normal((3, 3)), rng.standard_normal(3)
        for a, b in zip(t_readers.co3d_pose_to_opencv(R, T),
                        j_readers.co3d_pose_to_opencv(R, T)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(
            t_readers.co3d_ndc_to_opencv(pp, fl, (30, 40)),
            j_readers.co3d_ndc_to_opencv(pp, fl, (30, 40)))


def test_read_images_only_focal_above_cap_shared(tmp_path):
    """Frames wider than 1600 px load at 1600 px wide with the focal
    floor-divided by int(w0 / w) = 1 (JAX package: readers.py:113-117):
    fx 1175 for Family's FovX at 1920 px, where the 1600-px frame's focal
    is 979.9. Kept in both packages for parity (ROADMAP Queue 3)."""
    for i in range(2):
        write_png(str(tmp_path / f"{i:06d}.png"),
                  np.zeros((1080, 1920, 3), np.uint8))
    got = t_readers.read_images_only(str(tmp_path), FAMILY_FOVX)
    ref = j_readers.read_images_only(str(tmp_path), FAMILY_FOVX)
    K = got.train_frames[0].intrinsics
    np.testing.assert_array_equal(K, ref.train_frames[0].intrinsics)
    assert (got.train_frames[0].width, got.train_frames[0].height) == \
        (1600, 900)
    assert K[0, 0] == 1175.0 and K[1, 1] == 1175.0
    assert round(1600 / (2 * np.tan(FAMILY_FOVX / 2)), 1) == 979.9


def test_reader_helpers_equal_jax():
    """_target_resolution, _split, sample_rate_for and _nerfpp_radius."""
    for w, h in ((1920, 1080), (1600, 900), (1601, 901), (640, 480),
                 (4000, 3)):
        for res in (-1, 1, 2, 4, 8, 400):
            assert t_readers._target_resolution(w, h, res) == \
                j_readers._target_resolution(w, h, res)
    for n in (0, 1, 2, 9, 24, 301):
        for rate in (2, 8):
            for a, b in zip(t_readers._split(n, rate),
                            j_readers._split(n, rate)):
                np.testing.assert_array_equal(a, b)
    for path, over in (("data/Tanks/Family/images", None),
                       ("data/Tanks/Francis", None), ("Family", 8),
                       ("x", 2)):
        assert t_readers.sample_rate_for(path, over) == \
            j_readers.sample_rate_for(path, over)
    rng = np.random.default_rng(2)
    frames = [t_readers.FrameInfo(0, None, "a", 4, 4, np.eye(3), 1.0, 1.0,
                                  R=p[:3, :3].astype(np.float32),
                                  T=p[:3, 3].astype(np.float32))
              for p in _random_poses(rng, 5)]
    assert t_readers._nerfpp_radius(frames) == \
        j_readers._nerfpp_radius(frames)


# ---------------------------------------------------------------------------
# utils/config.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", CONFIGS,
                         ids=[os.path.relpath(p, REPO) for p in CONFIGS])
def test_published_config_modes_equal_jax(path):
    """Each published config loads equal in both packages, and
    resolve_mode_paths gives the same source path and data type for every
    mode."""
    assert len(CONFIGS) == 13
    for mode in ("train", "pose_only", "eval_pose", "eval_nvs", "render"):
        got = t_config.load_configs(path)
        ref = j_config.load_configs(path)
        assert t_config.resolve_mode_paths(got[0], mode) == \
            j_config.resolve_mode_paths(ref[0], mode)
        for a, b in zip(got, ref):
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert got[0].data_type == (got[0].data_type_train if mode == "train"
                                    else got[0].data_type_eval)


def test_cli_list_override():
    """A list flag on the CLI reads as a flow sequence, as in a config
    file; the JAX package keeps the string, which its trainer cannot
    index. Every other flag gives both packages the same configs."""
    path = os.path.join(REPO, "configs", "tanks", "Family.yml")
    argv = ["--config", path, "--mode", "eval_nvs", "--single_step", "20",
            "--vfi_provider", "precomputed", "--vfi_dir", "data/vfi"]
    lst = ["--num_iterations_per_frame_each_level", "[20, 20, 20]"]
    tm, tp, to, _ = t_config.configs_from_cli(argv + lst)
    jm, jp, jo, _ = j_config.configs_from_cli(argv + lst)
    assert to.num_iterations_per_frame_each_level == [20, 20, 20]
    assert jo.num_iterations_per_frame_each_level == "[20, 20, 20]"
    jo.num_iterations_per_frame_each_level = [20, 20, 20]
    for a, b in ((tm, jm), (tp, jp), (to, jo)):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    with pytest.raises(ValueError, match="takes a list"):
        t_config.configs_from_cli(argv + [lst[0], "20"])


# ---------------------------------------------------------------------------
# eval_pose on the default split
# ---------------------------------------------------------------------------

def _eval_pose_trainer(cls, root, monkeypatch, **kw):
    path = os.path.join(REPO, "configs", "tanks", "Family.yml")
    model, pipe, optim = (t_config if cls is TTrainer else j_config) \
        .load_configs(path, {"vfi_provider": "none",
                             "depth_provider": "constant"})
    model.data_path_eval = root
    t_config.resolve_mode_paths(model, "eval_pose")
    return cls(model.source_path, model, pipe, optim, **kw)


@pytest.mark.parametrize("layout", ["Francis", "Family"])
def test_eval_pose_test_split_shared(layout, tmp_path, monkeypatch):
    """eval_pose with the default split (ROADMAP Queue 3): the trainer's
    frames are the test split while pose/pose.npz holds the train frames'
    poses. In a Francis-like layout (stride 8) both packages raise the same
    ValueError; for Family (stride 2) both report the same ATE/RPE, which
    compare the estimate of train frame 2k with the truth of test frame
    2k + 1: nonzero given the exact train poses."""
    monkeypatch.chdir(tmp_path)
    for mod in (t_evals, j_evals):
        monkeypatch.setattr(mod, "_plot_trajectories", lambda *a: None)
    root = str(tmp_path / "Tanks" / layout)
    gt = np.stack(photo_scene.camera_trajectory(24))
    cams = {1: t_colmap.ColmapCamera(1, "PINHOLE", 32, 18,
                                     np.array([20.0, 20.0, 16.0, 9.0]))}
    images = {i + 1: t_colmap.ColmapImage(
        i + 1, t_colmap.rotmat2qvec(p[:3, :3]), p[:3, 3], 1,
        f"{i:06d}.png") for i, p in enumerate(gt)}
    t_colmap.write_model(os.path.join(root, "sparse", "0"), cams, images,
                         np.zeros((1, 3)), np.zeros((1, 3)))
    results = []
    for cls, kw in ((TTrainer, {"device": "cpu"}), (JTrainer, {})):
        tr = _eval_pose_trainer(cls, root, monkeypatch, **kw)
        i_train = tr.scene_info.i_train
        os.makedirs(os.path.join(tr.result_path, "pose"), exist_ok=True)
        np.savez(os.path.join(tr.result_path, "pose", "pose.npz"),
                 poses_pred=gt[i_train].astype(np.float32))
        if layout == "Francis":
            with pytest.raises(ValueError) as e:
                tr.eval_pose()
            results.append(str(e.value))
        else:
            res = tr.eval_pose()
            results.append(tuple(res[k] for k in (
                "ATE", "RPE_trans_x100", "RPE_rot_deg")))
    assert results[0] == results[1]
    if layout == "Francis":
        assert results[0] == \
            "the shapes of A and B differ ((3, 3) vs (21, 3))"
    else:
        assert results[0][0] > 1e-3 and results[0][1] > 1e-2


# ---------------------------------------------------------------------------
# the photo scene in the published layouts
# ---------------------------------------------------------------------------

def test_midpoint_pose():
    """Slerp of the rotations at 1/2 (equal angles to both ends, on the
    geodesic) and the mean of the camera centres."""
    rng = np.random.default_rng(4)
    a, b = _random_poses(rng, 2)
    m = photo_scene.midpoint_pose(a, b)
    ca, cb, cm = (np.linalg.inv(p) for p in (a, b, m))

    def angle(r1, r2):
        return np.arccos(np.clip((np.trace(r1.T @ r2) - 1) / 2, -1, 1))

    np.testing.assert_allclose(cm[:3, 3], (ca[:3, 3] + cb[:3, 3]) / 2)
    np.testing.assert_allclose(angle(ca[:3, :3], cm[:3, :3]),
                               angle(cm[:3, :3], cb[:3, :3]), atol=1e-9)
    np.testing.assert_allclose(2 * angle(ca[:3, :3], cm[:3, :3]),
                               angle(ca[:3, :3], cb[:3, :3]), atol=1e-9)


def _check_vfi(poses, K, h, w, i_train, vfi_dir, depth_dir, names):
    """Each consecutive train pair's midpoint frame and depth, where the
    trainer looks them up, equal the render at the midpoint pose."""
    planes = photo_scene.default_planes(np.random.default_rng(0))
    pairs = list(zip(i_train[:-1], i_train[1:]))
    assert sorted(os.listdir(vfi_dir)) == sorted(
        f"{k}_to_{k + 1}.png" for k in range(len(pairs)))
    k, (a, b) = len(pairs) - 1, pairs[-1]
    rgb, dep = photo_scene.render_frame(
        planes, photo_scene.midpoint_pose(poses[a], poses[b]), K, h, w)
    got = t_readers.FrameInfo(0, os.path.join(vfi_dir, f"{k}_to_{k + 1}.png"),
                              "", w, h, K, 1.0, 1.0).load_image()
    np.testing.assert_array_equal(
        got, (rgb * 255).astype(np.uint8).astype(np.float32) / 255.0)
    np.testing.assert_array_equal(
        np.load(os.path.join(depth_dir, f"{names[a]}_vfi.npy")), dep)


def test_write_tanks_reads_back(tmp_path):
    """write_tanks in configs/tanks/Family.yml's layout: the images_only
    training folder (both packages' readers), the COLMAP eval set (true
    poses and K in both packages), per-frame depths and the train split's
    VFI frames under the names the trainer asks for."""
    scene = str(tmp_path / "data" / "Tanks" / "Family")
    h, w = 18, 32
    gt, K = photo_scene.write_tanks(scene, n_frames=6, height=h, width=w,
                                    fovx=FAMILY_FOVX, workers=2)
    for readers in (t_readers, j_readers):
        ev = readers.read_colmap(scene)
        np.testing.assert_array_equal(ev.i_test, [1, 3, 5])
        for f in ev.train_frames + ev.test_frames:
            np.testing.assert_allclose(f.gt_pose(), gt[f.uid], atol=1e-6)
            np.testing.assert_allclose(f.intrinsics, K, rtol=1e-6)
        tr = readers.read_images_only(os.path.join(scene, "images"),
                                      FAMILY_FOVX)
        assert [f.image_name for f in tr.train_frames] == \
            ["000001", "000003", "000005"]
        assert len(ev.points) == ((h + 15) // 16) * ((w + 15) // 16)
    names = [f"{i + 1:06d}" for i in range(6)]
    for n in names:
        assert np.load(os.path.join(scene, "depth", n + ".npy")).shape == \
            (h, w)
    fx = w / (2 * np.tan(FAMILY_FOVX / 2))
    _check_vfi(photo_scene.camera_trajectory(6),
               np.array([[fx, 0, w / 2], [0, fx, h / 2], [0, 0, 1]]), h, w,
               [0, 2, 4], os.path.join(scene, "vfi"),
               os.path.join(scene, "depth"), names)


def test_write_co3d_reads_back(tmp_path):
    """write_co3d in a configs/co3d/*.yml's layout: both packages' read_co3d
    give the true poses and the written K (the NDC annotation), the
    frames, the depths at {basename}.npy and the VFI frames of the
    stride-8 split where the trainer looks them up."""
    path = os.path.join(REPO, "configs", "co3d", "hydrant_106_12648_23157.yml")
    model, pipe, _ = t_config.load_configs(path)
    root = str(tmp_path)
    data = os.path.join(root, model.data_path_train)
    depth_dir = os.path.join(root, pipe.depth_dir)
    vfi_dir = os.path.join(root, "vfi")
    h, w = 18, 24
    gt, K = photo_scene.write_co3d(data, model.category, model.seq_name,
                                   depth_dir, vfi_dir, n_frames=10,
                                   height=h, width=w, workers=2)
    assert os.path.exists(os.path.join(data, "co3d", "hydrant",
                                       "frame_annotations.jgz"))
    for readers in (t_readers, j_readers):
        info = readers.read_co3d(data, model.category, model.seq_name)
        np.testing.assert_array_equal(info.i_test, [4])
        for f in info.train_frames + info.test_frames:
            np.testing.assert_allclose(f.gt_pose(), gt[f.uid], atol=1e-6)
            np.testing.assert_array_equal(f.intrinsics, K)
            assert os.path.exists(f.image_path)
            assert f.depth_path == os.path.join(depth_dir,
                                                f.image_name + ".npy")
            assert np.load(f.depth_path).shape == (h, w)
    i_train = [i for i in range(10) if i != 4]
    names = [f"frame{i + 1:06d}.png" for i in range(10)]
    _check_vfi(photo_scene.camera_trajectory(10), K.astype(np.float64), h,
               w, i_train, vfi_dir, depth_dir, names)


def test_step_counter_records_growths_and_resets():
    """StepCounter: each change of the tile arguments between steps, and
    the opacity resets the trainer makes through the step module."""
    from ht3dgs_torch.train import step as step_lib

    counter = StepCounter()
    originals = counter.wrap_steps()
    try:
        for i, ta in enumerate([None, None, {"max_per_tile": 2048},
                                {"max_per_tile": 2048},
                                {"max_per_tile": 4096, "dup_factor": 32}]):
            counter.steps[counter.current] += 1
            counter._step_tile_args((), {"tile_args": ta}, None)
        with pytest.raises(Exception):
            step_lib.reset_opacity(None, None)
    finally:
        StepCounter.restore(originals)
    assert counter.growths == [
        {"phase": None, "step": 3, "tile_args": {"max_per_tile": 2048}},
        {"phase": None, "step": 5,
         "tile_args": {"max_per_tile": 4096, "dup_factor": 32}}]
    assert counter.resets[None] == 1
    assert step_lib.reset_opacity is originals[-1][2]


CHURCH_CUTS = dict(phase_a_fit_iters=1, phase_a_pose_iters=1,
                   leaf_init_iters=1, single_step=1,
                   num_iterations_per_frame_each_level="[1, 1, 1]",
                   mss_phase1_iteration_per_frame=1, reset_recovery_iters=1,
                   capacity_presize=1)


def test_church_trains_from_colmap_layout(tmp_path, monkeypatch):
    """configs/tanks/Church.yml (data_type_train colmap, FovX null) through
    `run.main --config` on write_tanks' layout at 24x16, 8 frames (7 train
    at stride 8), every budget cut to a step and the capacity to the init
    cloud's (so that the renders take the oracle): the COLMAP reader's
    frames and focal train Phase A, the four leaves, both merges and MSS
    phases 1 and 2 at both non-leaf levels, and the checkpoint."""
    from ht3dgs_torch import run

    monkeypatch.chdir(tmp_path)
    fovx = 1.3604490659339243
    gt, K = photo_scene.write_tanks("data/Tanks/Church", n_frames=8,
                                    height=16, width=24, fovx=fovx,
                                    workers=2)
    seen = {}
    fit = TTrainer.hierarchical_training

    def kept(self):
        seen["trainer"] = self
        return fit(self)

    monkeypatch.setattr(TTrainer, "hierarchical_training", kept)
    argv = ["--mode", "train", "--config",
            os.path.join(REPO, "configs", "tanks", "Church.yml"),
            "--vfi_provider", "precomputed",
            "--vfi_dir", "data/Tanks/Church/vfi"]
    for k, v in CHURCH_CUTS.items():
        argv += [f"--{k}", str(v)]
    run.main(argv, device="cpu")
    tr = seen["trainer"]
    assert tr.model_cfg.data_type == "colmap" and tr.model_cfg.FovX is None
    assert [f.image_name for f in tr.data] == [
        f"{i + 1:06d}" for i in range(8) if i != 4]
    for f in tr.data:
        np.testing.assert_allclose(f.intrinsics, K, rtol=1e-6)
    timer = tr.timer.counts
    assert (timer["merge"], timer["nonleaf_phase1"],
            timer["nonleaf_phase2"]) == (3, 3, 3), dict(timer)
    assert tr.gs_bundle.to_visit_frames == list(range(7))
    assert os.path.exists(os.path.join(tr.result_path, "chkpnt",
                                       "model.npz"))
