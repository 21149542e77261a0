"""Writes the image fixtures of this folder and their manifest.

    python tests/torch_images/generate.py

The fixtures are encoded with Pillow (and a few PNG forms Pillow does not
write, by hand), and `manifest.json` records the shape, dtype and SHA-256
of what Pillow decodes from each: `np.asarray(Image.open(f))` ("open_array")
and `np.asarray(Image.open(f).convert("RGB"))` ("load_rgb8"), and for the
1080p frame its LANCZOS resize to 1600x900 ("lanczos_1600x900"). The CPU
tests recompute every hash with Pillow and hold `ht3dgs_torch.data.imgcodec`
to them; `chip_smoke.py` holds the card machine's build of the decoder to
the manifest alone (that machine has no Pillow).
"""

import hashlib
import json
import os
import shutil
import struct
import sys
import zlib

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
LANCZOS_SIZE = (1600, 900)


def digest(a: np.ndarray) -> dict:
    a = np.ascontiguousarray(a)
    return {"shape": list(a.shape), "dtype": str(a.dtype),
            "sha256": hashlib.sha256(a.tobytes()).hexdigest()}


def pillow_entry(path: str) -> dict:
    from PIL import Image

    with Image.open(path) as im:
        entry = {"open_array": digest(np.asarray(im)),
                 "load_rgb8": digest(np.asarray(im.convert("RGB")))}
        if im.size == (1920, 1080):
            entry["lanczos_1600x900"] = digest(np.asarray(
                im.convert("RGB").resize(LANCZOS_SIZE, Image.LANCZOS)))
    return entry


def png_bytes(w: int, h: int, depth: int, ctype: int, rows: bytes,
              plte: bytes = None, trns: bytes = None,
              interlace: int = 0) -> bytes:
    """A PNG of already filtered rows (a filter byte before each row)."""
    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if plte is not None:
        out += chunk(b"PLTE", plte)
    if trns is not None:
        out += chunk(b"tRNS", trns)
    return out + chunk(b"IDAT", zlib.compress(rows)) + chunk(b"IEND", b"")


def smooth(h: int, w: int, rng) -> np.ndarray:
    y, x = np.mgrid[0:h, 0:w]
    a = np.stack([np.sin(x / 6.0 + k) * np.cos(y / 4.0 - k) * 100 + 128
                  for k in range(3)], -1)
    return np.clip(a + rng.normal(0, 8, a.shape), 0, 255).astype(np.uint8)


def frame_1080p() -> np.ndarray:
    """A 1920x1080 render of the photo-plane scene (utils.photo_scene)."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    from ht3dgs_torch.core.camera import intrinsics_from_fov
    from ht3dgs_torch.utils import photo_scene

    planes = photo_scene.default_planes(np.random.default_rng(0))
    K = intrinsics_from_fov(1.2, 1080, 1920)
    pose = photo_scene.camera_trajectory(8)[3]
    rgb, _ = photo_scene.render_frame(planes, pose, K, 1080, 1920)
    return (np.clip(rgb, 0, 1) * 255).astype(np.uint8)


def main():
    import matplotlib
    from PIL import Image

    rng = np.random.default_rng(8)
    files = {}

    def save(name, im, **kw):
        im.save(os.path.join(HERE, name), **kw)
        files[name] = None

    a = smooth(17, 33, rng)
    save("base420_33x17.jpg", Image.fromarray(a), quality=90)
    save("prog444_33x17.jpg", Image.fromarray(a), quality=90,
         subsampling=0, progressive=True)
    save("rst422_33x17.jpg", Image.fromarray(a), quality=90, subsampling=1,
         restart_marker_blocks=2)
    save("gray_prog_17x33.jpg", Image.fromarray(a.transpose(1, 0, 2)[..., 0]),
         quality=80, progressive=True)
    save("prog420_1x1.jpg", Image.fromarray(a[:1, :1]), progressive=True)
    b = smooth(21, 19, rng)
    save("rgba_21x19.png", Image.fromarray(np.concatenate(
        [b, b[..., :1]], -1), "RGBA"))
    save("i16_21x19.png", Image.fromarray(
        b[..., 0].astype(np.uint16) * 257 + 3))
    pal = Image.fromarray(b).quantize(16)
    save("pal4_trns_21x19.png", pal, bits=4,
         transparency=bytes(range(0, 160, 10)))
    # 16-bit RGB, Adam7-interlaced: forms Pillow does not write
    rgb16 = (smooth(9, 11, rng).astype(np.uint16) * 251).astype(">u2")
    passes = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
              (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
    rows = b""
    for xs, ys, dx, dy in passes:
        sub = rgb16[ys::dy, xs::dx]
        for r in sub:
            rows += b"\x00" + r.tobytes()
    with open(os.path.join(HERE, "rgb16_adam7_11x9.png"), "wb") as f:
        f.write(png_bytes(11, 9, 16, 2, rows, interlace=1))
    files["rgb16_adam7_11x9.png"] = None
    shutil.copyfile(os.path.join(matplotlib.get_data_path(), "sample_data",
                                 "grace_hopper.jpg"),
                    os.path.join(HERE, "grace_hopper.jpg"))
    files["grace_hopper.jpg"] = None
    save("frame_1080p.jpg", Image.fromarray(frame_1080p()), quality=75)

    manifest = {name: pillow_entry(os.path.join(HERE, name))
                for name in sorted(files)}
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
