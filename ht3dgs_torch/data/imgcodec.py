"""PNG and JPEG decoding and Pillow's LANCZOS/BILINEAR resizes, without
Pillow.

The JAX package reads its inputs through Pillow; the machine with the card
has no Pillow, so the port decodes its frames here and gives the same
arrays, bit for bit, as Pillow 12.1 (libjpeg-turbo 3.1, zlib):

- `open_array(path)` is `np.asarray(Image.open(path))`, mode by mode: "L"
  [H, W] uint8, "I;16" [H, W] uint16, "RGB"/"RGBA"/"LA" [H, W, C] uint8,
  "P" palette indices uint8, "1" bool;
- `load_rgb8(path)` is `np.asarray(Image.open(path).convert("RGB"))`:
  alpha dropped without compositing, gray replicated, a palette looked up,
  16-bit gray clipped to 255 (Pillow's I;16 -> RGB rule);
- `image_size(path)` reads the header alone.

EXIF orientation is not applied, as `Image.open` does not apply it.

PNG chunks are parsed here and inflated with `zlib`; the row filters are
undone by `csrc/imgdec.cc`, which also decodes JPEG whole. That library is
host code, built by `kernels.load("imgdec")` at first use with the host
compiler. A form that Pillow would read differently, or that the decoder
does not take, raises ValueError.

`resize_lanczos_rgb8` and `resize_bilinear_f32` follow Pillow's
`Resample.c`: a horizontal pass then a vertical pass, with the filter's
support scaled by the downscale factor; 8-bit data through 22-bit
fixed-point taps and a clipped uint8 intermediate, float data through
double taps and a float32 intermediate.
"""

from __future__ import annotations

import ctypes
import math
import struct
import zlib
from typing import Tuple

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"

# (bit depth, colour type) -> Pillow's mode of the decoded image
_PNG_MODES = {
    (1, 0): "1", (2, 0): "L", (4, 0): "L", (8, 0): "L", (16, 0): "I;16",
    (8, 2): "RGB", (16, 2): "RGB",
    (1, 3): "P", (2, 3): "P", (4, 3): "P", (8, 3): "P",
    (8, 4): "LA", (16, 4): "RGBA",
    (8, 6): "RGBA", (16, 6): "RGBA",
}
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# Adam7 passes: x start, y start, x step, y step
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _lib():
    from .. import kernels

    return kernels.load("imgdec")


# ---------------------------------------------------------------------------
# headers
# ---------------------------------------------------------------------------

def image_size(path) -> Tuple[int, int]:
    """(width, height) of a PNG or JPEG file, parsed from its header alone
    (a JPEG's markers up to its frame header)."""
    with open(path, "rb") as f:
        head = f.read(24)
        if head[:8] == PNG_SIGNATURE:
            if head[12:16] != b"IHDR":
                raise ValueError(f"{path}: PNG does not start with IHDR")
            return struct.unpack(">II", head[16:24])
        if head[:2] != b"\xff\xd8":
            raise ValueError(f"{path}: not a PNG or JPEG file")
        w, h, _ = _jpeg_info(head + f.read(), path)
        return w, h


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

def _unfilter(raw: bytes, rows: int, stride: int, bpp: int) -> np.ndarray:
    if len(raw) < rows * (stride + 1):
        raise ValueError("PNG image data is truncated")
    src = np.frombuffer(raw, np.uint8, rows * (stride + 1))
    out = np.empty((rows, stride), np.uint8)
    bad = _lib().ht3dgs_png_unfilter(src.ctypes.data, rows, stride, bpp,
                                      out.ctypes.data)
    if bad:
        raise ValueError(f"PNG row {bad} has an unknown filter type")
    return out


def _samples(rows: np.ndarray, width: int, depth: int,
             channels: int) -> np.ndarray:
    """Unfiltered rows [h, stride] -> samples [h, width, channels]."""
    h = rows.shape[0]
    n = width * channels
    if depth == 16:
        s = rows[:, :2 * n].view(">u2").astype(np.uint16)
    elif depth == 8:
        s = rows[:, :n]
    else:
        bits = np.unpackbits(rows, axis=1)[:, :n * depth]
        s = bits.reshape(h, n, depth)
        s = (s << np.arange(depth - 1, -1, -1, dtype=np.uint8)).sum(
            axis=2, dtype=np.uint8)
    return s.reshape(h, width, channels)


def _decode_png(data: bytes, path) -> Tuple[np.ndarray, str, np.ndarray]:
    """(the array `np.asarray` gives for Pillow's image, Pillow's mode,
    palette [256, 3] or None)."""
    pos, ihdr, plte, idat = 8, None, None, []
    while pos + 8 <= len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n:
            raise ValueError(f"{path}: PNG chunk {tag!r} is truncated")
        pos += 12 + n
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            plte = body
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if ihdr is None or not idat:
        raise ValueError(f"{path}: PNG lacks IHDR or IDAT")
    w, h, depth, ctype, comp, filt, interlace = ihdr
    mode = _PNG_MODES.get((depth, ctype))
    if mode is None or comp != 0 or filt != 0:
        raise ValueError(f"{path}: PNG bit depth {depth} with colour type "
                         f"{ctype} is not valid")
    if interlace not in (0, 1):
        raise ValueError(f"{path}: PNG interlace method {interlace} is not "
                         "supported")
    if w == 0 or h == 0:
        raise ValueError(f"{path}: PNG has zero size")
    raw = zlib.decompress(b"".join(idat))
    ch = _PNG_CHANNELS[ctype]
    bpp = max(1, depth * ch // 8)

    def stride(width):
        return (width * ch * depth + 7) // 8

    dtype = np.uint16 if depth == 16 else np.uint8
    if interlace == 0:
        px = _samples(_unfilter(raw, h, stride(w), bpp), w, depth, ch)
    else:
        px = np.zeros((h, w, ch), dtype)
        off = 0
        for xs, ys, dx, dy in _ADAM7:
            pw, ph = (w - xs + dx - 1) // dx, (h - ys + dy - 1) // dy
            if pw <= 0 or ph <= 0:
                continue
            size = ph * (stride(pw) + 1)
            rows = _unfilter(raw[off:off + size], ph, stride(pw), bpp)
            px[ys::dy, xs::dx] = _samples(rows, pw, depth, ch)
            off += size
    palette = None
    if ctype == 3:
        if plte is None:
            raise ValueError(f"{path}: PNG with a palette lacks PLTE")
        # Pillow looks entries past the PLTE's up as black
        palette = np.zeros((256, 3), np.uint8)
        n = min(len(plte) // 3, 256)
        palette[:n] = np.frombuffer(plte, np.uint8, 3 * n).reshape(n, 3)
    return _png_array(px, depth, mode), mode, palette


def _png_array(px: np.ndarray, depth: int, mode: str) -> np.ndarray:
    """Samples -> what `np.asarray` gives for Pillow's image of that mode."""
    if mode == "1":
        return px[..., 0] != 0
    if mode == "L":
        scale = {2: 85, 4: 17, 8: 1}[depth]
        return px[..., 0] * np.uint8(scale)
    if mode == "I;16":
        return px[..., 0]
    if depth == 16:   # RGB;16B, RGBA;16B and LA;16B keep the high bytes
        hi = (px >> 8).astype(np.uint8)
        if px.shape[-1] == 2:
            return np.concatenate([hi[..., :1]] * 3 + [hi[..., 1:]], axis=-1)
        return hi
    if mode == "P":
        return px[..., 0]
    return px


# ---------------------------------------------------------------------------
# JPEG
# ---------------------------------------------------------------------------

def _jpeg_info(data: bytes, path) -> Tuple[int, int, int]:
    """(width, height, channels) from the markers up to the frame header."""
    dims = (ctypes.c_int * 3)()
    err = ctypes.create_string_buffer(256)
    if _lib().ht3dgs_jpeg_info(data, len(data), dims, err, 256):
        raise ValueError(f"{path}: {err.value.decode()}")
    return tuple(dims)


def _decode_jpeg(data: bytes, path) -> np.ndarray:
    w, h, c = _jpeg_info(data, path)
    out = np.empty((h, w, c) if c == 3 else (h, w), np.uint8)
    err = ctypes.create_string_buffer(256)
    if _lib().ht3dgs_jpeg_decode(data, len(data), out.ctypes.data, out.size,
                                 err, 256):
        raise ValueError(f"{path}: {err.value.decode()}")
    return out


# ---------------------------------------------------------------------------
# public readers
# ---------------------------------------------------------------------------

def _decode(path):
    """(array as open_array gives it, Pillow's mode, palette or None)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] == PNG_SIGNATURE:
        return _decode_png(data, path)
    if data[:2] == b"\xff\xd8":
        arr = _decode_jpeg(data, path)
        return arr, ("L" if arr.ndim == 2 else "RGB"), None
    raise ValueError(f"{path}: not a PNG or JPEG file")


def open_array(path) -> np.ndarray:
    """`np.asarray(PIL.Image.open(path))` for a PNG or JPEG file."""
    return _decode(path)[0]


def load_rgb8(path) -> np.ndarray:
    """`np.asarray(PIL.Image.open(path).convert("RGB"))`: [H, W, 3] uint8."""
    arr, mode, palette = _decode(path)
    if mode == "RGB":
        return arr
    if mode == "RGBA":
        return np.ascontiguousarray(arr[..., :3])
    if mode == "P":
        return palette[arr]
    if mode == "1":
        gray = arr.astype(np.uint8) * np.uint8(255)
    elif mode == "I;16":
        gray = np.minimum(arr, 255).astype(np.uint8)
    elif mode == "LA":
        gray = arr[..., 0]
    else:
        gray = arr
    return np.repeat(gray[..., None], 3, axis=-1)


# ---------------------------------------------------------------------------
# resampling (Pillow's Resample.c)
# ---------------------------------------------------------------------------

_PRECISION_BITS = 32 - 8 - 2


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def _lanczos(x: float) -> float:
    if -3.0 <= x < 3.0:
        return _sinc(x) * _sinc(x / 3)
    return 0.0


def _bilinear(x: float) -> float:
    if x < 0.0:
        x = -x
    return 1.0 - x if x < 1.0 else 0.0


def _taps(in_size: int, out_size: int, filt, support: float):
    """Per output sample: source indices [out, ksize] (padding taps point at
    a valid sample) and normalised double weights [out, ksize] (0 beyond the
    sample's taps), in the order Pillow sums them."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    idx = np.zeros((out_size, ksize), np.int64)
    kk = np.zeros((out_size, ksize), np.float64)
    ss = 1.0 / filterscale
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [filt((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for v in w:   # in order, as C adds them (no compensated sum)
            ww += v
        if ww != 0.0:
            w = [v / ww for v in w]
        idx[xx, :xmax] = np.arange(xmin, xmin + xmax)
        idx[xx, xmax:] = xmin
        kk[xx, :xmax] = w
    return idx, kk


def _fixed(kk: np.ndarray) -> np.ndarray:
    """Pillow's normalize_coeffs_8bpc: round half away from zero at 22
    fraction bits."""
    scaled = kk * (1 << _PRECISION_BITS)
    return np.trunc(np.where(scaled < 0, scaled - 0.5, scaled + 0.5)
                    ).astype(np.int64)


def _pass(img: np.ndarray, idx, k, acc: np.ndarray) -> np.ndarray:
    """One resampling pass along axis 0 of img: acc[o] += img[idx[o, t]] *
    k[o, t] for each tap t in turn. Gathering whole rows of axis 0 keeps
    every step a contiguous copy."""
    rows = img.reshape(img.shape[0], -1)
    tmp = np.empty_like(acc)
    for t in range(idx.shape[1]):
        np.multiply(rows[idx[:, t]], k[:, t, None], out=tmp,
                    dtype=acc.dtype, casting="unsafe")
        acc += tmp
    return acc.reshape((idx.shape[0],) + img.shape[1:])


def _pass_8bpc(img: np.ndarray, idx, k) -> np.ndarray:
    # int32 as Pillow's C sums: the taps' fixed-point magnitudes sum to
    # little more than 1 << 22, so 255 times them stays far below 1 << 31
    acc = np.full((idx.shape[0], img[0].size), 1 << (_PRECISION_BITS - 1),
                  np.int32)
    out = _pass(img, idx, k.astype(np.int32), acc) >> _PRECISION_BITS
    return np.clip(out, 0, 255).astype(np.uint8)


def _pass_f32(img: np.ndarray, idx, k) -> np.ndarray:
    acc = np.zeros((idx.shape[0], img[0].size), np.float64)
    return _pass(img, idx, k, acc).astype(np.float32)


def resize_lanczos_rgb8(img: np.ndarray, width: int, height: int
                        ) -> np.ndarray:
    """`Image.fromarray(img).resize((width, height), Image.LANCZOS)` on
    [H, W, 3] uint8, exactly."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"resize_lanczos_rgb8 takes [H, W, 3] uint8, got "
                         f"{img.shape} {img.dtype}")
    h0, w0 = img.shape[:2]
    out = img
    if width != w0:
        idx, kk = _taps(w0, width, _lanczos, 3.0)
        out = _pass_8bpc(out.transpose(1, 0, 2), idx, _fixed(kk)
                         ).transpose(1, 0, 2)
    if height != h0:
        idx, kk = _taps(h0, height, _lanczos, 3.0)
        out = _pass_8bpc(out, idx, _fixed(kk))
    return np.array(out, order="C")


def resize_bilinear_f32(img: np.ndarray, width: int, height: int
                        ) -> np.ndarray:
    """`Image.fromarray(img).resize((width, height), Image.BILINEAR)` on an
    [H, W] float32 map (mode "F"), exactly: double taps summed in Pillow's
    order, a float32 intermediate."""
    img = np.asarray(img)
    if img.dtype != np.float32 or img.ndim != 2:
        raise ValueError(f"resize_bilinear_f32 takes [H, W] float32, got "
                         f"{img.shape} {img.dtype}")
    h0, w0 = img.shape
    out = img
    if width != w0:
        idx, kk = _taps(w0, width, _bilinear, 1.0)
        out = _pass_f32(out.T, idx, kk).T
    if height != h0:
        idx, kk = _taps(h0, height, _bilinear, 1.0)
        out = _pass_f32(out, idx, kk)
    return np.array(out, order="C")
