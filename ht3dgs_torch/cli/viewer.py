"""Remote-viewer bridge (the SIBR network_gui protocol, server side).

Counterpart of `ht3dgs.cli.viewer`. A client sends a 4-byte little-endian
JSON length, the JSON (resolution_x/_y, fov_x/_y, ...), then the view and
projection matrices as 4x4 little-endian float32 (the view matrix
transposed); the server answers with a 4-byte length and the rendered RGB
as uint8 [H, W, 3] bytes. A request with a zero resolution gets no answer.

Run: `python -m ht3dgs_torch.cli.viewer --checkpoint output/.../chkpnt/model.npz`
"""

from __future__ import annotations

import argparse
import json
import socket
import struct
import traceback

import numpy as np

from .. import interop
from ..core.camera import intrinsics_from_fov, make_camera
from ..core.gaussians import PARAM_FIELDS
from ..train import step as step_lib

# the checkpoint's GaussianState fields (its Adam moments and poses are
# not needed to render)
STATE_KEYS = PARAM_FIELDS + ("live", "max_radii2d", "grad_accum",
                             "grad_denom", "active_sh_degree",
                             "max_sh_degree")


def _read_exact(conn, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("client closed")
        buf += chunk
    return buf


def load_state(checkpoint: str, device="cuda"):
    """The GaussianState of a model.npz (or a bare state npz)."""
    with np.load(checkpoint) as z:
        return interop.state_from_numpy({k: z[k] for k in STATE_KEYS},
                                        device)


def _handle(conn, state, device) -> None:
    """Answer one client's requests until it closes the connection."""
    try:
        while True:
            (jlen,) = struct.unpack("<I", _read_exact(conn, 4))
            msg = json.loads(_read_exact(conn, jlen).decode("utf-8"))
            h = int(msg["resolution_y"])
            w = int(msg["resolution_x"])
            if h == 0 or w == 0:
                continue
            fovy = float(msg["fov_y"])
            fovx = float(msg["fov_x"])
            # znear/zfar are fixed in the projection; the projection matrix
            # is recomputed from the FoV
            view = np.frombuffer(_read_exact(conn, 64),
                                 dtype="<f4").reshape(4, 4).T.copy()
            _read_exact(conn, 64)
            K = intrinsics_from_fov(fovx, h, w, fovy=fovy)
            cam = make_camera(h, w, K, world_view=view, device=device)
            out = step_lib.render_eval(state, cam, mode="auto")
            img = out["image"].cpu().numpy()
            payload = (np.clip(img, 0, 1) * 255).astype(np.uint8).tobytes()
            conn.sendall(struct.pack("<I", len(payload)) + payload)
    except (ConnectionError, json.JSONDecodeError):
        pass
    except Exception:
        traceback.print_exc()
    finally:
        conn.close()


def serve(checkpoint: str, host: str = "127.0.0.1", port: int = 6009,
          max_sh_degree: int = 3, device="cuda"):
    state = load_state(checkpoint, device)
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind((host, port))
    srv.listen(1)
    print(f"viewer bridge on {host}:{port}")
    while True:
        conn, addr = srv.accept()
        print(f"client {addr}")
        _handle(conn, state, device)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=6009)
    args = p.parse_args()
    serve(args.checkpoint, args.host, args.port)


if __name__ == "__main__":
    main()
