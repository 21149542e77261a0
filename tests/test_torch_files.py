"""ht3dgs_torch reads its own inputs: PNG and JPEG decoding
(`data.imgcodec` + `csrc/imgdec.cc`), Pillow's LANCZOS and BILINEAR
resizes, and YAML configs (`utils.config.load_yaml`), held against what the
JAX package computes with Pillow 12.1 (libjpeg-turbo 3.1, zlib) and
PyYAML's `safe_load`: equal arrays (np.array_equal, dtype and shape
included) and equal configs. Then the readers against the JAX package's,
and the CLI training from a JPEG folder with PIL and yaml blocked."""

import dataclasses
import glob
import hashlib
import json
import math
import os
import struct
import sys
import zlib

import numpy as np
import pytest
import yaml
from PIL import Image

torch = pytest.importorskip("torch")

from ht3dgs.data import depth as j_depth  # noqa: E402
from ht3dgs.data import readers as j_readers  # noqa: E402
from ht3dgs.utils import config as j_config  # noqa: E402
from ht3dgs_torch import run  # noqa: E402
from ht3dgs_torch.data import depth as t_depth  # noqa: E402
from ht3dgs_torch.data import imgcodec  # noqa: E402
from ht3dgs_torch.data import readers as t_readers  # noqa: E402
from ht3dgs_torch.utils import config as t_config  # noqa: E402
from ht3dgs_torch.utils import synthetic  # noqa: E402

from port_utils import torch_threads_per_worker  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "torch_images")
# odd sizes: a single MCU, rows of 1-3 chroma samples (libjpeg replicates
# instead of interpolating below 3), ragged MCUs on both axes
SIZES = ((1, 1), (3, 5), (17, 33), (48, 64))


def _smooth(h, w, rng):
    y, x = np.mgrid[0:h, 0:w]
    a = np.stack([np.sin(x / 5.0 + k) * np.cos(y / 3.0 - k) * 100 + 128
                  for k in range(3)], -1)
    return np.clip(a + rng.normal(0, 10, a.shape), 0, 255).astype(np.uint8)


def _assert_like_pillow(path):
    with Image.open(path) as im:
        ref = np.asarray(im)
        ref_rgb = np.asarray(im.convert("RGB"))
        size = im.size
    got = imgcodec.open_array(path)
    assert got.dtype == ref.dtype and got.shape == ref.shape, path
    assert np.array_equal(got, ref), path
    rgb = imgcodec.load_rgb8(path)
    assert rgb.dtype == np.uint8 and np.array_equal(rgb, ref_rgb), path
    assert tuple(imgcodec.image_size(path)) == size


# ---------------------------------------------------------------------------
# JPEG
# ---------------------------------------------------------------------------

JPEG_FORMS = {
    "baseline_420": dict(subsampling=2),
    "baseline_422": dict(subsampling=1),
    "baseline_444": dict(subsampling=0),
    "progressive_420": dict(subsampling=2, progressive=True),
    "progressive_422": dict(subsampling=1, progressive=True),
    "progressive_444": dict(subsampling=0, progressive=True),
    "restart_420": dict(subsampling=2, restart_marker_blocks=1),
    "restart_progressive": dict(subsampling=2, progressive=True,
                                restart_marker_rows=1),
    "optimized_huffman": dict(subsampling=2, optimize=True),
    "gray": dict(gray=True),
    "gray_progressive": dict(gray=True, progressive=True),
}


@pytest.mark.parametrize("form", sorted(JPEG_FORMS))
def test_jpeg_equals_pillow(form, tmp_path):
    """Random and smooth images at odd sizes and two qualities, encoded by
    Pillow in one form, decode to Pillow's very bytes."""
    kw = dict(JPEG_FORMS[form])
    gray = kw.pop("gray", False)
    rng = np.random.default_rng(sorted(JPEG_FORMS).index(form))
    for h, w in SIZES:
        for kind in ("random", "smooth"):
            a = (rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
                 if kind == "random" else _smooth(h, w, rng))
            im = Image.fromarray(a[..., 0] if gray else a)
            for q in (20, 92):
                p = str(tmp_path / f"{kind}_{h}x{w}_q{q}.jpg")
                im.save(p, quality=q, **kw)
                _assert_like_pillow(p)


def test_jpeg_photograph_equals_pillow():
    """A real photograph: matplotlib's grace_hopper.jpg, baseline 4:2:0,
    512x600."""
    import matplotlib

    path = os.path.join(matplotlib.get_data_path(), "sample_data",
                        "grace_hopper.jpg")
    _assert_like_pillow(path)
    assert imgcodec.load_rgb8(path).shape == (600, 512, 3)


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _filtered_rows(samples, depth, rng):
    """samples [h, w, ch] -> PNG rows, each under a random filter type."""
    rows = []
    for r in samples.reshape(samples.shape[0], -1):
        if depth == 16:
            rows.append(np.frombuffer(r.astype(">u2").tobytes(), np.uint8))
        elif depth == 8:
            rows.append(r.astype(np.uint8))
        else:
            bits = np.unpackbits(r.astype(np.uint8)[:, None], axis=1)
            rows.append(np.packbits(bits[:, 8 - depth:].ravel()))
    bpp = max(1, depth * samples.shape[2] // 8)
    out, prev = b"", np.zeros(len(rows[0]), np.int64)
    for cur in rows:
        cur = cur.astype(np.int64)
        a = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        t = int(rng.integers(0, 5))
        p = a + prev - c
        paeth = np.where((abs(p - a) <= abs(p - prev)) & (abs(p - a)
                         <= abs(p - c)), a,
                         np.where(abs(p - prev) <= abs(p - c), prev, c))
        pred = (0, a, prev, (a + prev) // 2, paeth)[t]
        out += bytes([t]) + ((cur - pred) % 256).astype(np.uint8).tobytes()
        prev = cur
    return out


def _write_png(path, samples, depth, ctype, rng, plte=None, trns=None,
               interlace=0):
    h, w = samples.shape[:2]
    if interlace:
        rows = b"".join(_filtered_rows(samples[ys::dy, xs::dx], depth, rng)
                        for xs, ys, dx, dy in _ADAM7
                        if xs < w and ys < h)
    else:
        rows = _filtered_rows(samples, depth, rng)

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    body = chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0,
                                      interlace))
    if plte is not None:
        body += chunk(b"PLTE", plte)
    if trns is not None:
        body += chunk(b"tRNS", trns)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + body
                + chunk(b"IDAT", zlib.compress(rows)) + chunk(b"IEND", b""))


PNG_FORMS = [(1, 0), (2, 0), (4, 0), (8, 0), (16, 0), (8, 2), (16, 2),
             (1, 3), (2, 3), (4, 3), (8, 3), (8, 4), (16, 4), (8, 6), (16, 6)]


@pytest.mark.parametrize("depth,ctype", PNG_FORMS)
def test_png_equals_pillow(depth, ctype, tmp_path):
    """Every bit depth and colour type, plain and Adam7, with and without
    tRNS where the type takes one, every row filter, at 1x1 and odd sizes;
    a palette shorter than its indices reach (Pillow reads black there)."""
    rng = np.random.default_rng(depth * 10 + ctype)
    ch = _CHANNELS[ctype]
    for h, w in ((1, 1), (7, 13), (20, 9)):
        s = rng.integers(0, 1 << depth, (h, w, ch))
        plte = None
        if ctype == 3:
            n = min(1 << depth, 200)
            plte = rng.integers(0, 256, 3 * n).astype(np.uint8).tobytes()
        trns_forms = [None]
        if ctype == 0:
            trns_forms.append(struct.pack(">H", int(s[0, 0, 0])))
        elif ctype == 2:
            trns_forms.append(struct.pack(">HHH", *map(int, s[0, 0])))
        elif ctype == 3:
            trns_forms.append(bytes(range(0, 250, 50)))
        for interlace in (0, 1):
            for trns in trns_forms:
                p = str(tmp_path / f"{h}x{w}_{interlace}_{trns is None}.png")
                _write_png(p, s, depth, ctype, rng, plte, trns, interlace)
                _assert_like_pillow(p)


def test_png_written_by_pillow_and_write_png(tmp_path):
    """PNGs as Pillow writes them (its own filters and compression) and as
    utils.image.write_png writes them: the same pixels."""
    from ht3dgs_torch.utils.image import write_png

    rng = np.random.default_rng(3)
    a = _smooth(23, 31, rng)
    for mode, arr in (("RGB", a), ("L", a[..., 0]),
                      ("RGBA", np.concatenate([a, a[..., :1]], -1)),
                      ("I;16", a[..., 0].astype(np.uint16) * 300)):
        p = str(tmp_path / f"{mode.replace(';', '')}.png")
        Image.fromarray(arr).save(p)
        _assert_like_pillow(p)
    p = str(tmp_path / "write_png.png")
    write_png(p, a)
    _assert_like_pillow(p)
    assert np.array_equal(imgcodec.load_rgb8(p), a)


# ---------------------------------------------------------------------------
# forms that are refused
# ---------------------------------------------------------------------------

def _jpeg_bytes(**kw):
    import io

    buf = io.BytesIO()
    Image.fromarray(_smooth(16, 16, np.random.default_rng(0))).save(
        buf, format="JPEG", **kw)
    return buf.getvalue()


def _patch_sof(data: bytes, marker: int = None, precision: int = None,
               y_sampling: int = None) -> bytes:
    i = data.index(b"\xff\xc0")
    b = bytearray(data)
    if marker is not None:
        b[i + 1] = marker
    if precision is not None:
        b[i + 4] = precision
    if y_sampling is not None:
        b[i + 11] = y_sampling      # first component's H/V factors
    return bytes(b)


def _patch_dht(data: bytes, table: int, count1: int) -> bytes:
    """The JPEG with its table-th Huffman table given count1 codes of
    length 1, taken from its shortest other lengths so the table's symbol
    count (and so the segment's length) stays as it was."""
    b, i = bytearray(data), -1
    for _ in range(table + 1):
        i = b.index(b"\xff\xc4", i + 1)
    counts = list(b[i + 5:i + 21])       # after FFC4, length, Tc/Th
    new, rest = [0] * 16, sum(counts) - count1
    for n in range(15, 0, -1):
        new[n] = min(counts[n], rest)
        rest -= new[n]
    new[0] = count1 + rest
    b[i + 5:i + 21] = bytes(new)
    return bytes(b)


def _png_with(interlace=0, filter_type=0):
    raw = bytes([filter_type]) + bytes(3)

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", 1, 1, 8, 2, 0, 0,
                                         interlace))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


REFUSED = {
    "arithmetic": (lambda: _patch_sof(_jpeg_bytes(), marker=0xC9),
                   "arithmetic"),
    "arithmetic_progressive": (lambda: _patch_sof(_jpeg_bytes(),
                                                  marker=0xCA), "arithmetic"),
    "lossless": (lambda: _patch_sof(_jpeg_bytes(), marker=0xC3), "lossless"),
    "hierarchical": (lambda: _patch_sof(_jpeg_bytes(), marker=0xC5),
                     "hierarchical"),
    "12_bit": (lambda: _patch_sof(_jpeg_bytes(), precision=12), "12-bit"),
    "cmyk": (lambda: _cmyk_jpeg(), "CMYK"),
    "adobe_rgb": (lambda: _jpeg_bytes(keep_rgb=True, subsampling=0), "RGB"),
    "sampling_h1v2": (lambda: _patch_sof(_jpeg_bytes(subsampling=2),
                                         y_sampling=0x12), "sampling"),
    # malformed Huffman tables: an all-ones code (as libjpeg, no code may
    # be all ones), then tables whose codes overflow the 9-bit lookahead
    "huffman_all_ones": (lambda: _patch_dht(_jpeg_bytes(), 0, 2),
                         "over-subscribed"),
    "huffman_oversubscribed": (lambda: _patch_dht(_jpeg_bytes(), 0, 3),
                               "over-subscribed"),
    "huffman_oversubscribed_ac": (lambda: _patch_dht(_jpeg_bytes(), 1, 162),
                                  "over-subscribed"),
    "png_interlace": (lambda: _png_with(interlace=2), "PNG interlace"),
    "png_filter": (lambda: _png_with(filter_type=7), "filter type"),
    "not_an_image": (lambda: b"GIF89a" + bytes(20), "not a PNG or JPEG"),
}


def _cmyk_jpeg():
    import io

    buf = io.BytesIO()
    Image.new("CMYK", (8, 8), (1, 2, 3, 4)).save(buf, format="JPEG")
    return buf.getvalue()


@pytest.mark.parametrize("form", sorted(REFUSED))
def test_unsupported_form_raises(form, tmp_path):
    make, words = REFUSED[form]
    p = tmp_path / "img"
    p.write_bytes(make())
    for fn in (imgcodec.open_array, imgcodec.load_rgb8):
        with pytest.raises(ValueError, match=words):
            fn(str(p))


@pytest.mark.parametrize("form", sorted(f for f in REFUSED
                                         if f.startswith("huffman")))
def test_malformed_huffman_table_refused_by_pillow_too(form, tmp_path):
    p = tmp_path / "img.jpg"
    p.write_bytes(REFUSED[form][0]())
    # the tables follow the frame header: both still read the size
    assert imgcodec.image_size(str(p)) == Image.open(p).size
    with pytest.raises(OSError, match="broken data stream"):
        Image.open(p).load()


# ---------------------------------------------------------------------------
# resizes
# ---------------------------------------------------------------------------

RESIZES = ((1080, 1920, 900, 1600), (37, 45, 20, 30), (20, 30, 37, 45),
           (50, 40, 50, 17), (9, 9, 3, 3), (5, 7, 11, 2))


@pytest.mark.parametrize("h0,w0,h1,w1", RESIZES)
def test_resizes_equal_pillow(h0, w0, h1, w1):
    """LANCZOS on 8-bit RGB and BILINEAR on float32 (mode F), down and up,
    one axis alone: both exactly equal Pillow's (no ulp of slack)."""
    rng = np.random.default_rng(h0 * w1)
    a = rng.integers(0, 256, (h0, w0, 3), dtype=np.uint8)
    got = imgcodec.resize_lanczos_rgb8(a, w1, h1)
    ref = np.asarray(Image.fromarray(a).resize((w1, h1), Image.LANCZOS))
    assert got.dtype == ref.dtype and np.array_equal(got, ref)
    f = (rng.random((h0, w0)) * 7).astype(np.float32)
    got = imgcodec.resize_bilinear_f32(f, w1, h1)
    ref = np.asarray(Image.fromarray(f).resize((w1, h1), Image.BILINEAR))
    assert got.dtype == ref.dtype == np.float32
    assert np.array_equal(got, ref)


# ---------------------------------------------------------------------------
# the fixtures that chip_smoke.py holds the card machine's decoder to
# ---------------------------------------------------------------------------

def _digest(a):
    a = np.ascontiguousarray(a)
    return {"shape": list(a.shape), "dtype": str(a.dtype),
            "sha256": hashlib.sha256(a.tobytes()).hexdigest()}


def _manifest():
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", sorted(_manifest()))
def test_fixture_manifest(name):
    """The manifest is Pillow's (recomputed here, so it cannot drift from
    its files), and the port decodes to it."""
    entry = _manifest()[name]
    path = os.path.join(FIXTURES, name)
    with Image.open(path) as im:
        assert _digest(np.asarray(im)) == entry["open_array"]
        rgb = im.convert("RGB")
        assert _digest(np.asarray(rgb)) == entry["load_rgb8"]
        if "lanczos_1600x900" in entry:
            assert _digest(np.asarray(rgb.resize((1600, 900), Image.LANCZOS))
                           ) == entry["lanczos_1600x900"]
    assert _digest(imgcodec.open_array(path)) == entry["open_array"]
    got = imgcodec.load_rgb8(path)
    assert _digest(got) == entry["load_rgb8"]
    if "lanczos_1600x900" in entry:
        assert _digest(imgcodec.resize_lanczos_rgb8(got, 1600, 900)) \
            == entry["lanczos_1600x900"]
    assert os.path.getsize(path) < 400_000


def test_fixtures_fit_their_budget():
    total = sum(os.path.getsize(p) for p in glob.glob(
        os.path.join(FIXTURES, "*")))
    assert total <= 400 * 1024


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*", "*.yml")))


def _same(a, b):
    if isinstance(a, float) and isinstance(b, float) \
            and math.isnan(a) and math.isnan(b):
        return True
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(map(_same, a, b))
    return a == b


@pytest.mark.parametrize("path", CONFIGS,
                         ids=[os.path.relpath(p, REPO) for p in CONFIGS])
def test_config_equals_jax(path):
    """The port's load_configs equals the JAX package's, field by field, and
    its parser gives yaml.safe_load's document."""
    with open(path) as f:
        text = f.read()
    assert _same(t_config.load_yaml(text), yaml.safe_load(text))
    for got, ref in zip(t_config.load_configs(path),
                        j_config.load_configs(path)):
        assert [f.name for f in dataclasses.fields(got)] == \
            [f.name for f in dataclasses.fields(ref)]
        for f in dataclasses.fields(got):
            assert _same(getattr(got, f.name), getattr(ref, f.name)), f.name


def test_config_count():
    assert len(CONFIGS) == 13


SCALARS = [
    "1e-4", "1.0e-4", "1.e5", "1.0e+5", "1.5E-3", "-1e5", "12e03", "0.",
    ".5", "+.5", "3.", "1_000.5", "yes", "No", "on", "OFF", "True", "FALSE",
    "y", "n", "~", "null", "Null", "NULL", "", "0x1F", "0o17", "017", "08",
    "0", "-0", "+12", "1_000", "0_7", "_1", "1__2", "1:30", "-1:30",
    "190:20:30", "1:60", ".inf", "-.Inf", "+.INF", ".nan", ".NaN",
    "hello world", "a:b", "a#b", "2002-1-5", "--x", "x - y",
    "'quoted # not a comment'", "'it''s'", '"back\\\\slash"',
    '"say \\"hi\\""', "[1, 2.5, x, 'y', [3, [4]]]", "[]", "[1, 2, ]",
    "[1e-4, yes, ~, null]", "plain # comment",
]


def test_yaml_scalars_equal_safe_load():
    """A table of plain, quoted and flow values resolves as PyYAML's YAML
    1.1 safe_load resolves it (1e-4 a string, yes a bool, 017 octal, 1:30
    base 60, ...)."""
    for v in SCALARS:
        text = f"k: {v}\n"
        ref, got = yaml.safe_load(text), t_config.load_yaml(text)
        assert _same(got, ref), (v, ref, got)


DOCUMENTS = [
    "a:\n  b: 1\n  c:\n    - x\n    - 2\nd:\n- 1\n- [2]\n",
    "---\na: 1 # c\nb: 'x # y' # z\n",
    "# comments only\n",
    "'x y': 1\n\"z\": [a, b]\n1: a\n2.5: b\nnull: c\n",
    "a:\n  -\n  - 1\n  -\n    - 2\n",
    "a:\n    deep:\n        deeper: [1]\n    back: 2\nz:\n",
    "- 1\n- two\n",
    "scalar\n",
]


@pytest.mark.parametrize("i", range(len(DOCUMENTS)))
def test_yaml_documents_equal_safe_load(i):
    text = DOCUMENTS[i]
    assert _same(t_config.load_yaml(text), yaml.safe_load(text))


YAML_REFUSED = {
    "anchor": "a: &x 1\n", "alias": "a: *x\n", "tag": "a: !!str 1\n",
    "block_scalar": "a: |\n  x\n", "folded_scalar": "a: >\n  x\n",
    "flow_mapping": "a: {b: 1}\n", "complex_key": "? a\n: 1\n",
    "two_documents": "a: 1\n---\nb: 2\n", "merge_key": "<<: 1\n",
    "timestamp": "a: 2001-12-14t21:59:43.10-05:00\n",
    "date": "a: 2002-12-14\n", "binary_int": "a: 0b101\n",
    "base60_float": "a: 1:30.5\n", "escape_tab": 'a: "x\\ty"\n',
    "escape_hex": 'a: ["\\x41"]\n',
    "tab_indent": "a:\n\tb: 1\n", "bad_indent": "a: 1\n b: 2\n",
    "mapping_in_value": "a: b: c\n", "open_quote": "a: 'x\n",
    "open_flow": "a: [1, 2\n", "compact_mapping": "- a\n- b: 1\n",
    "directive": "%YAML 1.1\n---\na: 1\n", "dash_value": "a: -\n",
}


@pytest.mark.parametrize("form", sorted(YAML_REFUSED))
def test_yaml_outside_subset_raises(form):
    """What the parser does not take raises ValueError with its line, never
    a different document."""
    with pytest.raises(ValueError, match=r"YAML line \d+"):
        t_config.load_yaml(YAML_REFUSED[form])


# ---------------------------------------------------------------------------
# readers
# ---------------------------------------------------------------------------

def test_readers_equal_jax(tmp_path):
    """read_images_only + load_image on a JPEG folder, frames wider than
    1600 so both resize with LANCZOS, and PrecomputedDepth on 8- and 16-bit
    PNGs of another size than the frame (BILINEAR): np.array_equal with the
    JAX package's readers."""
    rng = np.random.default_rng(11)
    img_dir = tmp_path / "images"
    img_dir.mkdir()
    for i in range(3):
        Image.fromarray(_smooth(40, 1700, rng)).save(
            img_dir / f"{i:04d}.jpg", quality=85, progressive=i == 1)
    got = t_readers.read_images_only(str(img_dir), 1.2, sample_rate=2)
    ref = j_readers.read_images_only(str(img_dir), 1.2, sample_rate=2)
    assert [f.image_name for f in got.train_frames + got.test_frames] == \
        [f.image_name for f in ref.train_frames + ref.test_frames]
    for g, r in zip(got.train_frames + got.test_frames,
                    ref.train_frames + ref.test_frames):
        assert (g.width, g.height) == (r.width, r.height) == (1600, 37)
        assert np.array_equal(g.intrinsics, r.intrinsics)
        gi, ri = g.load_image(), np.asarray(r.load_image())
        assert gi.dtype == ri.dtype == np.float32 and np.array_equal(gi, ri)

    depth_dir = tmp_path / "depth"
    depth_dir.mkdir()
    d = rng.random((30, 41))
    Image.fromarray((d * 255).astype(np.uint8)).save(depth_dir / "d8.png")
    Image.fromarray((d * 65535).astype(np.uint16)).save(depth_dir / "d16.png")
    frame = np.zeros((23, 57, 3), np.float32)
    for name in ("d8", "d16"):
        for disp in (False, True):
            g = t_depth.PrecomputedDepth(str(depth_dir), is_disparity=disp)(
                frame, name)
            r = j_depth.PrecomputedDepth(str(depth_dir), is_disparity=disp)(
                frame, name)
            assert g.dtype == r.dtype and np.array_equal(g, r), (name, disp)


def test_precomputed_vfi_npy_imports_nothing(tmp_path, monkeypatch):
    from ht3dgs_torch.data import vfi

    mid = np.random.default_rng(0).random((4, 5, 3)).astype(np.float32)
    np.save(tmp_path / "0_to_1.npy", mid)
    Image.fromarray((mid * 255).astype(np.uint8)).save(tmp_path / "1_to_2.png")
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    prov = vfi.PrecomputedVFI(str(tmp_path))
    assert np.array_equal(prov(None, None, "0_to_1"), mid)
    assert np.array_equal(prov(None, None, "1_to_2"),
                          (mid * 255).astype(np.uint8) / np.float32(255.0))


# ---------------------------------------------------------------------------
# the CLI from files, without PIL or yaml
# ---------------------------------------------------------------------------

H, W, FRAMES, FOVX = 24, 32, 4, 1.2


def test_cli_trains_from_jpegs_without_pil_or_yaml(tmp_path, monkeypatch):
    """`run.main(["--mode", "train", "--config", cfg.yml], device="cpu")` on
    a 4-frame 32x24 JPEG video, with PIL and yaml unimportable, as on the
    machine with the card."""
    scene = synthetic.generate(n_frames=FRAMES, height=H, width=W,
                               n_gaussians=200, fovx=FOVX, seed=5,
                               device="cpu")
    img_dir, depth_dir = tmp_path / "images", tmp_path / "depth"
    img_dir.mkdir()
    depth_dir.mkdir()
    for i, (f, d) in enumerate(zip(scene.frames, scene.depths)):
        Image.fromarray((f * 255).astype(np.uint8)).save(
            img_dir / f"{i:04d}.jpg", quality=95)
        np.save(depth_dir / f"{i:04d}.npy", d)
    cfg = tmp_path / "cfg.yml"
    cfg.write_text(f"""\
# a tiny images_only run
ModelParams:
    FovX: {FOVX}
    data_path_train: {img_dir}
    data_type_train: images_only
    eval: no
    expname: files
    category: s
    seq_name: x
PipelineParams:
    train_level: 0
    render_mode: oracle
    depth_provider: precomputed
    depth_dir: '{depth_dir}'
    vfi_provider: blend
    train_pose_mode: null
    multi_source_supervision: vfi
    init_max_points: 200
    capacity_presize: 2.0
    phase_a_batch: 4
OptimizationParams:
    single_step: 4
    phase_a_fit_iters: 8
    phase_a_pose_iters: 4
    leaf_init_iters: 8
    reset_recovery_iters: 2
    num_iterations_per_frame_each_level: [4, 4, 4]
""")
    model, pipe, optim = t_config.load_configs(str(cfg))
    assert (model.eval, pipe.train_pose_mode, pipe.depth_dir) == \
        (False, None, str(depth_dir))
    for mod in ("PIL", "PIL.Image", "yaml"):
        monkeypatch.setitem(sys.modules, mod, None)
    monkeypatch.chdir(tmp_path)
    run.main(["--mode", "train", "--config", str(cfg)], device="cpu")
    out = tmp_path / "output" / "files" / "s_x"
    assert (out / "chkpnt" / "model.npz").exists()
    with np.load(out / "pose" / "pose.npz") as z:
        assert z["poses_pred"].shape == (FRAMES, 4, 4)
        assert np.all(np.isfinite(z["poses_pred"]))
