"""fsnerf_tpu_torch's image decoder against fsnerf_tpu's libjpeg / libpng
decoder (fsnerf_tpu.native.decode_images, which builds here): JPEG files
written by PIL and by a small baseline writer (tests/torch_jpeg_writer.py)
for the layouts PIL does not write, files cut short, the JPEGs the port
refuses by name, Adam7-interlaced PNGs of every color type and bit depth,
PNG and JPEG files in one call, and an LLFF scene stored as JPEG.

Every comparison is bitwise on the float32 pixels (each 8-bit value times
1/255): the port mirrors libjpeg-turbo 2.1.5's islow IDCT, fancy
upsampling and color conversion, and libpng's conversions.
"""

import io
import os
import struct
import zlib

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from fsnerf_tpu.data import llff as jllff
from fsnerf_tpu.native import decode_images as jdecode
from fsnerf_tpu_torch import native
from fsnerf_tpu_torch.data import llff
from torch_jpeg_writer import write_jpeg

SIZES = [(1, 1), (7, 9), (37, 53), (101, 77)]


def _image(h, w, seed, smooth=False):
    """uint8 [h, w, 3]: uniform noise, or smooth gradients with some noise
    (the content a camera gives)."""
    rng = np.random.default_rng(seed)
    if not smooth:
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([128 + 100 * np.sin(xx / 9.0), 128 + 90 * np.cos(yy / 7.0),
                    (xx * 3 + yy * 2) % 256], -1)
    return (img + rng.normal(0, 6, img.shape)).clip(0, 255).astype(np.uint8)


def _assert_same_as_jax(path):
    want = jdecode([path])
    got = native.decode_images([path])
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want, err_msg=str(path))
    assert native.probe_image(path) == want.shape[1:]


# (name, size, save options, smooth content)
PIL_CASES = [(f"{h}x{w}-sub{sub}-{'prog' if prog else 'base'}", (h, w),
              dict(quality=95, subsampling=sub, progressive=prog), False)
             for h, w in SIZES for sub in (0, 1, 2) for prog in (False, True)]
PIL_CASES += [
    ("q50-sub2", (37, 53), dict(quality=50, subsampling=2), True),
    ("q50-sub1-prog", (37, 53), dict(quality=50, subsampling=1,
                                     progressive=True), True),
    ("smooth-sub2", (101, 77), dict(quality=95, subsampling=2), True),
    ("smooth-sub2-prog", (101, 77), dict(quality=95, subsampling=2,
                                         progressive=True), True),
    ("optimize-sub1", (37, 53), dict(quality=95, subsampling=1,
                                     optimize=True), False),
    ("optimize-sub2", (7, 9), dict(quality=50, subsampling=2,
                                   optimize=True), True),
    ("restart-blocks", (37, 53), dict(quality=95, subsampling=2,
                                      restart_marker_blocks=3), False),
    ("restart-blocks-prog", (37, 53), dict(
        quality=95, subsampling=2, restart_marker_blocks=2,
        progressive=True), False),
    ("restart-rows", (101, 77), dict(quality=95, subsampling=1,
                                     restart_marker_rows=1), True),
    ("restart-rows-prog", (37, 53), dict(quality=95, subsampling=0,
                                         restart_marker_rows=2,
                                         progressive=True), False),
    ("keep-rgb", (37, 53), dict(quality=95, keep_rgb=True,
                                subsampling=0), False),
    ("keep-rgb-prog", (7, 9), dict(quality=95, keep_rgb=True,
                                   subsampling=0, progressive=True), False),
]


@pytest.mark.parametrize("name,size,opts,smooth", PIL_CASES,
                         ids=[c[0] for c in PIL_CASES])
def test_pil_jpeg_matches_jax_decoder(tmp_path, name, size, opts, smooth):
    path = tmp_path / f"{name}.jpg"
    Image.fromarray(_image(*size, seed=len(name), smooth=smooth)).save(
        path, **opts)
    _assert_same_as_jax(str(path))


@pytest.mark.parametrize("size", [(1, 1), (37, 53)])
@pytest.mark.parametrize("prog", [False, True])
def test_gray_jpeg_matches_jax_decoder(tmp_path, size, prog):
    """One component: gray copied to R, G and B (gray_rgb_convert)."""
    path = tmp_path / "gray.jpg"
    Image.fromarray(_image(*size, seed=3)[..., 0]).save(
        path, quality=90, progressive=prog)
    _assert_same_as_jax(str(path))


Q = np.clip(np.arange(64) // 2 + 2, 1, 255)
SAMPLINGS = {"444": [(1, 1)] * 3, "422": [(2, 1), (1, 1), (1, 1)],
             "420": [(2, 2), (1, 1), (1, 1)], "440": [(1, 2), (1, 1), (1, 1)],
             "411": [(4, 1), (1, 1), (1, 1)],
             "mixed": [(2, 2), (2, 1), (1, 2)],
             "chroma-larger": [(1, 1), (2, 2), (2, 2)],
             "421": [(4, 2), (1, 1), (1, 1)]}
WRITER_CASES = [(f"{s}-{'inter' if inter else 'separate'}", s, inter, rst)
                for s in SAMPLINGS for inter, rst in ((True, 0), (False, 2))]
WRITER_CASES += [("420-inter-restart", "420", True, 2),
                 ("411-inter-restart", "411", True, 1)]


@pytest.mark.parametrize("name,sampling,interleaved,restart", WRITER_CASES,
                         ids=[c[0] for c in WRITER_CASES])
def test_written_layouts_match_jax_decoder(tmp_path, name, sampling,
                                           interleaved, restart):
    """Sampling factors PIL does not write (4:4:0 through h1v2 fancy
    upsampling, 4:1:1 and the others through replication), one scan per
    component, restart intervals across them, and a 16-bit quantization
    table (SOF1), at sizes from 1x1 to ones no MCU divides."""
    for h, w in ((1, 1), (13, 11), (3, 40), (40, 3), (16, 16)):
        rgb = _image(h, w, seed=h * w, smooth=True)
        data = write_jpeg([rgb[..., i] for i in range(3)],
                          SAMPLINGS[sampling], [Q, Q + 3, Q * 300],
                          interleaved=interleaved, restart=restart)
        path = tmp_path / f"{name}-{h}x{w}.jpg"
        path.write_bytes(data)
        _assert_same_as_jax(str(path))


@pytest.mark.parametrize("markers", [
    dict(jfif=False, adobe=0), dict(jfif=False, adobe=1),
    dict(jfif=False, ids=[82, 71, 66]), dict(jfif=False, ids=[5, 6, 7]),
    dict(jfif=True, ids=[82, 71, 66])],
    ids=["adobe-0-rgb", "adobe-1-ycc", "ids-RGB", "ids-other", "jfif-RGB"])
def test_color_space_guess_matches_jax_decoder(tmp_path, markers):
    """libjpeg's guess of the color space of three components: JFIF means
    YCbCr, an Adobe transform 0 RGB, IDs 'R', 'G', 'B' RGB, else YCbCr."""
    rgb = _image(13, 11, seed=5, smooth=True)
    path = tmp_path / "c.jpg"
    path.write_bytes(write_jpeg([rgb[..., i] for i in range(3)],
                                SAMPLINGS["422"], [Q] * 3, **markers))
    _assert_same_as_jax(str(path))


def test_jpeg_without_huffman_tables_takes_the_default_ones(tmp_path):
    """A baseline file with its DHT segments removed (as Motion-JPEG frames
    ship): libjpeg-turbo assumes the standard tables, which PIL's
    unoptimized files use."""
    buf = io.BytesIO()
    Image.fromarray(_image(37, 53, seed=6)).save(buf, "JPEG", quality=80)
    raw, out, pos = buf.getvalue(), bytearray(b"\xff\xd8"), 2
    while raw[pos + 1] != 0xDA:
        n = struct.unpack(">H", raw[pos + 2:pos + 4])[0]
        if raw[pos + 1] != 0xC4:
            out += raw[pos:pos + 2 + n]
        pos += 2 + n
    assert b"\xff\xc4" not in out
    path = tmp_path / "nodht.jpg"
    path.write_bytes(bytes(out) + raw[pos:])
    _assert_same_as_jax(str(path))


@settings(max_examples=10, deadline=None, database=None)
@given(h=st.integers(1, 40), w=st.integers(1, 40), sub=st.sampled_from([0, 1, 2]),
       prog=st.booleans(), quality=st.integers(20, 100), optimize=st.booleans(),
       restart=st.integers(0, 4), seed=st.integers(0, 2 ** 16))
def test_random_jpegs_match_jax_decoder(tmp_path_factory, h, w, sub, prog,
                                        quality, optimize, restart, seed):
    path = tmp_path_factory.mktemp("hyp") / "r.jpg"
    Image.fromarray(_image(h, w, seed, smooth=seed % 2 == 0)).save(
        path, quality=quality, subsampling=sub, progressive=prog,
        optimize=optimize, restart_marker_blocks=restart)
    _assert_same_as_jax(str(path))


@pytest.mark.parametrize("case", [
    ("baseline", 0.3, {}), ("baseline", 0.9, {}),
    ("restarts", 0.5, dict(restart_marker_blocks=2)),
    ("progressive-last-scan", 0.97, dict(progressive=True))],
    ids=lambda c: f"{c[0]}-{c[1]}")
def test_jpeg_cut_short_matches_jax_decoder(tmp_path, case):
    """A file cut short: libjpeg-turbo warns and reads zero bits, then
    leaves the rest of the segment's blocks empty (gray), and the JAX
    decoder succeeds; the port gives the same pixels. A progressive file
    cut in its last scan has every coefficient band refined, so no block
    smoothing applies."""
    _, frac, opts = case
    buf = io.BytesIO()
    Image.fromarray(_image(37, 53, seed=8)).save(buf, "JPEG", quality=90,
                                                 **opts)
    raw = buf.getvalue()
    path = tmp_path / "cut.jpg"
    path.write_bytes(raw[:int(len(raw) * frac)])
    _assert_same_as_jax(str(path))


def test_corrupt_jpegs_the_jax_decoder_refuses_raise(tmp_path):
    """60 files with 1-3 entropy-coded bytes overwritten at random (seeded):
    every file the JAX decoder fails on raises IOError in the port. Those
    both decode are not compared here: libjpeg-turbo's SIMD IDCT treats
    the overflowing coefficients of corrupt data otherwise than its C
    IDCT, which the port mirrors (tests/jpeg_fuzz.py compares them with
    JSIMD_FORCENONE=1: equal on every file both read)."""
    rng = np.random.default_rng(12)
    refused = 0
    for n in range(60):
        buf = io.BytesIO()
        prog = bool(n % 2)
        Image.fromarray(_image(*rng.integers(8, 40, 2), seed=n)).save(
            buf, "JPEG", quality=int(rng.integers(30, 96)),
            subsampling=n % 3, progressive=prog,
            restart_marker_blocks=int(rng.integers(0, 3)))
        raw = bytearray(buf.getvalue())
        sos = raw.find(b"\xff\xda") if prog else raw.rfind(b"\xff\xda")
        for _ in range(int(rng.integers(1, 4))):
            raw[int(rng.integers(sos + 14, len(raw) - 2))] = int(
                rng.integers(0, 256))
        path = str(tmp_path / f"c{n}.jpg")
        with open(path, "wb") as fh:
            fh.write(bytes(raw))
        try:
            jdecode([path])
        except IOError:
            refused += 1
            with pytest.raises(IOError):
                native.decode_images([path])
    assert refused > 0


def _rewritten(raw, marker, offset, value):
    b = bytearray(raw)
    b[raw.index(bytes([0xFF, marker])) + offset] = value
    return bytes(b)


@pytest.mark.parametrize("kind,match,jax_reads", [
    ("sof3", "lossless", False), ("sof5", "hierarchical", False),
    ("sof9", "arithmetic", True), ("sof10", "arithmetic", False),
    ("12-bit", "12-bit", False), ("cmyk", "4-component", False),
    ("progressive-cut", "block smoothing", True)])
def test_jpeg_refusals_name_their_reason(tmp_path, kind, match, jax_reads):
    """The JPEGs the port refuses raise NotImplementedError naming why:
    the SOF marker byte rewritten (SOF3, SOF5, SOF9, SOF10), the precision
    byte rewritten to 12, a CMYK file, and a progressive file cut short
    before its last scans (libjpeg decodes it with block smoothing, not
    reproduced). The JAX decoder fails on each of these but two: its
    libjpeg-turbo decodes arithmetic-coded data (the rewritten SOF9 file
    reads as noise), and it smooths the cut progressive file."""
    buf = io.BytesIO()
    img = Image.fromarray(_image(37, 53, seed=9))
    if kind == "cmyk":
        img.convert("CMYK").save(buf, "JPEG")
    else:
        img.save(buf, "JPEG", quality=90,
                 progressive=kind == "progressive-cut")
    raw = buf.getvalue()
    codes = {"sof3": 0xC3, "sof5": 0xC5, "sof9": 0xC9, "sof10": 0xCA}
    if kind in codes:
        raw = _rewritten(raw, 0xC0, 1, codes[kind])
    elif kind == "12-bit":
        raw = _rewritten(raw, 0xC0, 4, 12)
    elif kind == "progressive-cut":
        raw = raw[:len(raw) // 2]
    path = str(tmp_path / f"{kind}.jpg")
    with open(path, "wb") as fh:
        fh.write(raw)
    if jax_reads:
        assert jdecode([path]).shape == (1, 37, 53, 3)
    else:
        with pytest.raises(IOError):
            jdecode([path])
    with pytest.raises(NotImplementedError, match=match):
        native.decode_images([path])


FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "jpeg")
FIXTURE_NAMES = sorted(n for n in os.listdir(FIXTURES) if n.endswith(".jpg"))


@pytest.mark.parametrize("name", FIXTURE_NAMES)
def test_jpeg_fixtures_hold_the_jax_decoders_pixels(name):
    """tests/data/jpeg/ (tests/make_jpeg_fixtures.py), which the card's
    machine decodes without libjpeg: both decoders give the stored uint8
    pixels times 1/255."""
    path = os.path.join(FIXTURES, name)
    with np.load(os.path.join(FIXTURES, "pixels.npz")) as npz:
        want = np.multiply(npz[name], np.float32(1) / np.float32(255),
                           dtype=np.float32)
    np.testing.assert_array_equal(jdecode([path])[0], want)
    np.testing.assert_array_equal(native.decode_images([path])[0], want)


def test_files_dispatch_by_suffix_then_magic(tmp_path):
    """decode_any's order: the suffix first (a JPEG named .png fails in
    both decoders), then the magic bytes (a JPEG or PNG without a known
    suffix decodes)."""
    img = _image(9, 7, seed=10)
    jpg = tmp_path / "a.bin"
    Image.fromarray(img).save(jpg, "JPEG")
    png = tmp_path / "b.dat"
    Image.fromarray(img).save(png, "PNG")
    for path in (jpg, png):
        _assert_same_as_jax(str(path))
    wrong = tmp_path / "c.png"
    wrong.write_bytes(jpg.read_bytes())
    with pytest.raises(IOError):
        jdecode([str(wrong)])
    with pytest.raises(IOError, match="not a PNG"):
        native.decode_images([str(wrong)])


@pytest.mark.parametrize("channels", [None, 3, 4])
def test_png_and_jpeg_in_one_call(tmp_path, channels):
    """A mix in one call, in either order, converted to the first file's
    channels or the ones asked for (3 -> 4 adds an alpha of 1, 4 -> 3
    drops it)."""
    img = _image(13, 11, seed=11)
    jpg = str(tmp_path / "a.jpg")
    Image.fromarray(img).save(jpg, quality=90)
    png = str(tmp_path / "b.png")
    Image.fromarray(np.concatenate([img, img[..., :1]], -1), "RGBA").save(png)
    for paths in ([jpg, png, jpg], [png, jpg]):
        want = jdecode(paths, channels=channels)
        got = native.decode_images(paths, channels=channels)
        np.testing.assert_array_equal(got, want)


def test_llff_scene_of_jpegs_loads_as_jax(tmp_path):
    """load_llff_scene over an images_8/ of JPEGs (4:2:0, quality 95, a
    width and height no MCU divides) equals the JAX loader's result."""
    scene = tmp_path / "fern"
    (scene / "images_8").mkdir(parents=True)
    H, W, n = 19, 27, 5
    rows = []
    for i in range(n):
        Image.fromarray(_image(H, W, seed=20 + i, smooth=True)).save(
            scene / "images_8" / f"im_{i:03d}.JPG", quality=95, subsampling=2)
        c2w = np.zeros((3, 5), np.float32)
        c2w[:3, :3] = [[0, -1, 0], [1, 0, 0], [0, 0, 1]]
        c2w[:3, 3] = [0.1 * i, 0.0, 0.05 * i]
        c2w[:, 4] = [H * 8, W * 8, 400.0]
        rows.append(np.concatenate([c2w.ravel(), [2.0, 8.0]]))
    np.save(scene / "poses_bounds.npy", np.asarray(rows, np.float32))
    want = jllff.load_llff_scene(str(scene), factor=8)
    got = llff.load_llff_scene(str(scene), factor=8)
    assert got["imgs"].shape == (n, H, W, 3)
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v),
                                      err_msg=k)


# ---------------- Adam7-interlaced PNGs ----------------

ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _pack(sub, depth):
    """Rows [h, rowbytes] of samples [h, w, s] at a bit depth."""
    h, w, s = sub.shape
    if depth == 16:
        return sub.astype(">u2").reshape(h, -1).view(np.uint8)
    if depth == 8:
        return sub.reshape(h, -1).astype(np.uint8)
    per = 8 // depth
    vals = np.zeros((h, -(-w // per) * per), np.uint8)
    vals[:, :w] = sub[..., 0]
    vals = vals.reshape(h, -1, per)
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    return (vals << shifts).sum(-1).astype(np.uint8)


def _filtered(row, prev, f, bpp):
    """One row of raw bytes coded with PNG filter f."""
    x, b = row.astype(np.int64), prev.astype(np.int64)
    a = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])[:len(x)]
    c = np.concatenate([np.zeros(bpp, np.int64), b[:-bpp]])[:len(x)]
    if f == 1:
        pred = a
    elif f == 2:
        pred = b
    elif f == 3:
        pred = (a + b) // 2
    elif f == 4:
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    else:
        pred = 0
    return bytes([f]) + ((x - pred) % 256).astype(np.uint8).tobytes()


def _chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def adam7_png(samples, depth, color, filters, palette=None, trns=None):
    """The bytes of an Adam7-interlaced PNG of samples [H, W, s] (uint16
    at depth 16), each pass's rows coded with `filters` in turn."""
    h, w, s = samples.shape
    bpp = max(1, s * depth // 8)
    data, k = bytearray(), 0
    for x0, y0, dx, dy in ADAM7:
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        rows = _pack(sub, depth)
        prev = np.zeros(rows.shape[1], np.uint8)
        for r in rows:
            data += _filtered(r, prev, filters[k % len(filters)], bpp)
            prev, k = r, k + 1
    out = b"\x89PNG\r\n\x1a\n" + _chunk(
        b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 1))
    if palette is not None:
        out += _chunk(b"PLTE", palette.tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    return out + _chunk(b"IDAT", zlib.compress(bytes(data))) \
        + _chunk(b"IEND", b"")


ADAM7_KINDS = [(0, d) for d in (1, 2, 4, 8, 16)] + [(2, 8), (2, 16)] \
    + [(3, d) for d in (1, 2, 4, 8)] + [(4, 8), (4, 16), (6, 8), (6, 16)]


@pytest.mark.parametrize("color,depth", ADAM7_KINDS,
                         ids=[f"color{c}-depth{d}" for c, d in ADAM7_KINDS])
def test_adam7_png_matches_jax_decoder(tmp_path, color, depth):
    """Seven passes, some of them empty (sizes 1x1 to 13x11), each filter
    type alone and all five in turn; gray, RGB and palette images also
    with a tRNS chunk."""
    s = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    rng = np.random.default_rng(color * 100 + depth)
    top = (1 << depth) if color != 3 else min(1 << depth, 7)
    palette = (rng.integers(0, 256, (top, 3), dtype=np.uint8)
               if color == 3 else None)
    n = 0
    for h, w in ((1, 1), (2, 3), (5, 1), (1, 9), (8, 8), (13, 11)):
        px = rng.integers(0, top, (h, w, s)).astype(
            np.uint16 if depth == 16 else np.uint8)
        trns_opts = [None]
        if color == 3:
            trns_opts.append(bytes(rng.integers(0, 256, top - 2,
                                                dtype=np.uint8)))
        elif color in (0, 2):
            trns_opts.append(struct.pack(f">{s}H", *px[0, 0, :s].tolist()))
        for filters in ((0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4)):
            for trns in trns_opts:
                path = tmp_path / f"i{n}.png"
                path.write_bytes(adam7_png(px, depth, color, filters,
                                           palette, trns))
                assert Image.open(path).info.get("interlace") == 1
                _assert_same_as_jax(str(path))
                n += 1
