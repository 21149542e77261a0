"""ht3dgs_torch's command line, trace capture, viewer bridge and photo
scene on the CPU: the five modes of `ht3dgs_torch.run.main` one after
another on a tiny synthetic video, a torch.profiler trace, one SIBR request
answered with the bytes render_eval gives, and photo_scene.write_dataset
against the JAX package's."""

import json
import os
import socket
import struct
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ht3dgs.utils import photo_scene as j_photo  # noqa: E402
from ht3dgs_torch import run  # noqa: E402
from ht3dgs_torch.cli import viewer  # noqa: E402
from ht3dgs_torch.core.camera import (intrinsics_from_fov,  # noqa: E402
                                      make_camera)
from ht3dgs_torch.train import step as t_step  # noqa: E402
from ht3dgs_torch.utils import photo_scene as t_photo  # noqa: E402
from ht3dgs_torch.utils import synthetic  # noqa: E402
from ht3dgs_torch.utils.profiling import torch_trace  # noqa: E402

from port_utils import torch_threads_per_worker  # noqa: E402,F401

H, W, FRAMES, FOVX = 24, 32, 4, 1.2


def _write_video(d):
    """The synthetic video as an images_only set, with depths, and a
    transforms_train.json beside the frames that describes the same frames
    with their true poses (a blender set, for the eval modes)."""
    scene = synthetic.generate(n_frames=FRAMES, height=H, width=W,
                               n_gaussians=200, fovx=FOVX, seed=5,
                               device="cpu")
    img_dir = synthetic.write_images_only(scene, os.path.join(d, "images"),
                                          depth_dir=os.path.join(d, "depth"))
    frames = []
    for i, w2c in enumerate(scene.poses_w2c):
        c2w = np.linalg.inv(w2c)
        c2w[:3, 1:3] *= -1            # OpenCV -> NeRF/OpenGL axes
        frames.append({"file_path": f"{i:04d}",
                       "transform_matrix": c2w.tolist()})
    with open(os.path.join(img_dir, "transforms_train.json"), "w") as f:
        json.dump({"camera_angle_x": FOVX, "frames": frames}, f)
    return img_dir


def test_run_main_all_modes(tmp_path, monkeypatch, capsys):
    d = str(tmp_path)
    img_dir = _write_video(d)
    monkeypatch.chdir(d)
    common = [
        "--data_path_train", img_dir, "--data_type_train", "images_only",
        "--data_path_eval", img_dir, "--data_type_eval", "blender",
        "--FovX", str(FOVX), "--no-eval", "--expname", "cli",
        "--category", "s", "--seq_name", "x", "--train_level", "0",
        "--render_mode", "oracle", "--depth_provider", "precomputed",
        "--depth_dir", os.path.join(d, "depth"), "--vfi_provider", "blend",
        "--train_pose_mode", "none", "--multi_source_supervision", "vfi",
        "--init_max_points", "200", "--capacity_presize", "2.0",
        "--phase_a_batch", "4", "--single_step", "4",
        "--phase_a_fit_iters", "8", "--phase_a_pose_iters", "4",
        "--leaf_init_iters", "8", "--reset_recovery_iters", "2",
        "--eval_nvs_epochs", "2"]
    out = os.path.join(d, "output", "cli", "s_x")
    run.main(["--mode", "train"] + common, device="cpu")
    assert os.path.exists(os.path.join(out, "chkpnt", "model.npz"))
    with np.load(os.path.join(out, "pose", "pose.npz")) as z:
        trained = z["poses_pred"]
    assert trained.shape == (FRAMES, 4, 4)

    # pose_only reads the eval set (the blender reader's unrounded focal)
    run.main(["--mode", "pose_only"] + common, device="cpu")
    with np.load(os.path.join(out, "pose", "pose.npz")) as z:
        poses = z["poses_pred"]
    assert poses.shape == (FRAMES, 4, 4) and np.isfinite(poses).all()
    np.testing.assert_array_equal(poses[0], np.eye(4))
    assert np.abs(poses - trained).max() < 0.05

    run.main(["--mode", "eval_pose"] + common, device="cpu")
    line = open(os.path.join(out, "pose", "pose_eval.txt")).read()
    assert line.startswith("RPE_trans: ") and "ATE: " in line

    run.main(["--mode", "eval_nvs"] + common, device="cpu")
    rows = open(os.path.join(out, "test", "test.txt")).read().splitlines()
    assert len(rows) == FRAMES + 1 and rows[-1].startswith("PSNR : ")
    assert float(rows[-1].split(",")[0].split(":")[1]) > 15.0

    run.main(["--mode", "render"] + common, device="cpu")
    assert len(os.listdir(os.path.join(out, "nvs", "bspline",
                                       "img_out"))) == 120

    # --distributed in one process without torchrun's environment: a
    # world of one rank, the same poses
    run.main(["--mode", "pose_only", "--distributed"] + common,
             device="cpu")
    assert "[distributed] process 0/1 on cpu" in capsys.readouterr().out
    with np.load(os.path.join(out, "pose", "pose.npz")) as z:
        np.testing.assert_array_equal(z["poses_pred"], poses)


def test_torch_trace_writes_a_trace(tmp_path):
    log_dir = str(tmp_path / "trace")
    with torch_trace(log_dir):
        x = torch.ones(64, 64)
        (x @ x).sum().item()
    files = os.listdir(log_dir)
    assert any(f.endswith(".pt.trace.json") for f in files), files
    with torch_trace(None):
        pass


def _free_port():
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    return port


def test_viewer_answers_a_sibr_request(tmp_path):
    """A bare state npz (no Adam or poses) served on a free loopback port:
    the reply is the uint8 render of the same camera."""
    scene = synthetic.generate(n_frames=1, height=8, width=8,
                               n_gaussians=64, seed=2, device="cpu")
    st = scene.state
    arrs = {f: getattr(st, f).numpy() for f in viewer.STATE_KEYS[:-1]}
    arrs["max_sh_degree"] = np.asarray(st.max_sh_degree)
    ckpt = str(tmp_path / "model.npz")
    np.savez(ckpt, **arrs)

    port = _free_port()
    threading.Thread(target=viewer.serve, args=(ckpt, "127.0.0.1", port),
                     kwargs={"device": "cpu"}, daemon=True).start()
    cli = None
    for _ in range(100):
        try:
            cli = socket.create_connection(("127.0.0.1", port), timeout=5)
            break
        except OSError:
            time.sleep(0.2)
    assert cli is not None
    cli.settimeout(120)
    h, w, fovx, fovy = 32, 48, 1.2, 0.9
    view = np.eye(4, dtype="<f4")
    view[:3, 3] = [0.1, -0.05, 0.2]
    msg = json.dumps({"resolution_x": w, "resolution_y": h, "fov_x": fovx,
                      "fov_y": fovy, "z_near": 0.01,
                      "z_far": 100.0}).encode()
    cli.sendall(struct.pack("<I", len(msg)) + msg + view.T.tobytes()
                + view.T.tobytes())
    (plen,) = struct.unpack("<I", viewer._read_exact(cli, 4))
    buf = viewer._read_exact(cli, plen)
    cli.close()
    assert plen == h * w * 3

    cam = make_camera(h, w, intrinsics_from_fov(fovx, h, w, fovy=fovy),
                      world_view=view, device="cpu")
    img = t_step.render_eval(st, cam, mode="auto")["image"].numpy()
    want = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    assert want.max() > 0
    assert buf == want.tobytes()


def test_photo_scene_matches_jax(tmp_path):
    from PIL import Image

    outs = {}
    for name, mod in (("t", t_photo), ("j", j_photo)):
        d = str(tmp_path / name)
        outs[name] = (d,) + mod.write_dataset(d, n_frames=3, height=24,
                                              width=32)
    (dt, pt, kt), (dj, pj, kj) = outs["t"], outs["j"]
    np.testing.assert_array_equal(pt, pj)
    np.testing.assert_array_equal(kt, kj)
    assert open(os.path.join(dt, "transforms_train.json")).read() == \
        open(os.path.join(dj, "transforms_train.json")).read()
    for i in range(3):
        name = f"r_{i:03d}"
        a, b = (np.asarray(Image.open(os.path.join(x, "train",
                                                   name + ".png")))
                for x in (dt, dj))
        np.testing.assert_array_equal(a, b)
        assert a.std() > 5.0
        np.testing.assert_array_equal(
            np.load(os.path.join(dt, "depth", name + ".npy")),
            np.load(os.path.join(dj, "depth", name + ".npy")))
