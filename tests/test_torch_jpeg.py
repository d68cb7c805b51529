"""fsnerf_tpu_torch's image decoder against fsnerf_tpu's libjpeg / libpng
decoder (fsnerf_tpu.native.decode_images, which builds here): JPEG files
written by PIL and by a small baseline writer (tests/torch_jpeg_writer.py)
for the layouts PIL does not write, arithmetic-coded files made from PIL's
coefficients (tests/jpeg_transcode.c, compiled here with gcc and
libjpeg), files cut short, progressive files libjpeg block-smooths,
corrupt files, the JPEGs the port refuses by name, Adam7-interlaced PNGs
of every color type and bit depth, PNG and JPEG files in one call, and an
LLFF scene stored as JPEG.

Every comparison is bitwise on the float32 pixels (each 8-bit value times
1/255): the port mirrors libjpeg-turbo 2.1.5's islow IDCT, fancy
upsampling and color conversion, and libpng's conversions. Where block
smoothing or corrupt data overflow the IDCT, libjpeg-turbo's SIMD IDCT
(which it runs where the CPU has it) differs from its C IDCT, which the
port mirrors: those files are compared with the JAX decoder run with
JSIMD_FORCENONE=1, in a process of its own
(tests/make_jpeg_fixtures.py::c_idct_pixels).
"""

import hashlib
import io
import json
import os
import subprocess
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
from fsnerf_tpu_torch.native.jpeg import D_SMOOTH, read_jpeg
from make_jpeg_fixtures import c_idct_pixels, transcoder
from torch_jpeg_writer import write_jpeg

SIZES = [(1, 1), (7, 9), (37, 53), (101, 77)]
def _assert_same_as_c_idct(paths):
    """Each file: the port reads it to the pixels of the JAX decoder run
    with libjpeg's C IDCT (tests/make_jpeg_fixtures.py::c_idct_pixels), or
    raises IOError where that fails. Returns how many both read."""
    read = 0
    for path, want in zip(paths, c_idct_pixels(paths)):
        if want is None:
            with pytest.raises(IOError):
                native.decode_images([str(path)])
            continue
        np.testing.assert_array_equal(native.decode_images([str(path)])[0],
                                      want, err_msg=str(path))
        read += 1
    return read


@pytest.fixture(scope="module")
def transcode(tmp_path_factory):
    """tests/jpeg_transcode.c, compiled: transcode(src, dst, *flags) writes
    dst from src's coefficients and returns its path."""
    exe = transcoder(str(tmp_path_factory.mktemp("transcoder")))

    def run(src, dst, *flags):
        subprocess.run([exe, *flags, str(src), str(dst)], check=True)
        return str(dst)

    return run


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


def _arith_flags(progressive, restart=0):
    return (["-a"] + (["-p"] if progressive else [])
            + (["-r", str(restart)] if restart else []))


@pytest.mark.parametrize("restart", [0, 1, 3])
@pytest.mark.parametrize("sof", ["sof9", "sof10"])
def test_arithmetic_jpegs_match_jax_decoder(tmp_path, transcode, sof,
                                            restart):
    """PIL's files at SIZES x subsampling 0/1/2, their coefficients taken
    to arithmetic coding: sequential (SOF9, one DAC marker) or progressive
    with jpeg_simple_progression's ten scans (SOF10, a DAC marker before
    each), with restart intervals of 0, 1 and 3 MCUs."""
    code = b"\xff\xc9" if sof == "sof9" else b"\xff\xca"
    for h, w in SIZES:
        for sub in (0, 1, 2):
            src = tmp_path / f"{h}x{w}-{sub}.jpg"
            Image.fromarray(_image(h, w, seed=h * w + sub)).save(
                src, quality=90, subsampling=sub)
            path = transcode(src, tmp_path / f"a-{h}x{w}-{sub}.jpg",
                             *_arith_flags(sof == "sof10", restart))
            with open(path, "rb") as fh:
                assert code in fh.read()
            _assert_same_as_jax(path)


@pytest.mark.parametrize("sof", ["sof9", "sof10"])
def test_arithmetic_gray_jpeg_matches_jax_decoder(tmp_path, transcode, sof):
    """One component, arithmetic-coded: one DC and one AC statistics area
    per scan."""
    for h, w in ((1, 1), (37, 53)):
        src = tmp_path / f"g{h}.jpg"
        Image.fromarray(_image(h, w, seed=3, smooth=True)[..., 0]).save(
            src, quality=90)
        _assert_same_as_jax(transcode(src, tmp_path / f"ag{h}.jpg",
                                      *_arith_flags(sof == "sof10", 2)))


@pytest.mark.parametrize("dac", ["0,0,1", "2,6,12", "15,15,63", "1,1,0"])
def test_arithmetic_conditioning_matches_jax_decoder(tmp_path, transcode,
                                                     dac):
    """DAC markers with other conditioning than the default L 0, U 1, K 5:
    the DC differences' small and large categories (arith_dc_L, _U) and
    the AC coefficients past which the larger magnitude categories take
    the other bins (arith_ac_K), sequential and progressive, on smooth
    content at quality 50 and noise at quality 95."""
    for i, (smooth, q) in enumerate(((True, 50), (False, 95))):
        src = tmp_path / f"s{i}.jpg"
        Image.fromarray(_image(37, 53, seed=i, smooth=smooth)).save(
            src, quality=q, subsampling=2)
        for prog in (False, True):
            _assert_same_as_jax(transcode(
                src, tmp_path / f"d{i}{prog}.jpg", "-d", dac,
                *_arith_flags(prog, 3)))


def test_arithmetic_bad_conditioning_raises(tmp_path, transcode):
    """A DAC value whose L is above its U, and a DAC table index past the
    16 tables: both decoders refuse the file."""
    src = tmp_path / "s.jpg"
    Image.fromarray(_image(13, 11, seed=4)).save(src, quality=90)
    raw = open(transcode(src, tmp_path / "a.jpg", "-a"), "rb").read()
    dac = raw.index(b"\xff\xcc")
    for offset, value in ((5, 0x15), (4, 0x20)):
        bad = bytearray(raw)
        bad[dac + offset] = value
        path = str(tmp_path / f"bad{offset}.jpg")
        with open(path, "wb") as fh:
            fh.write(bytes(bad))
        with pytest.raises(IOError):
            jdecode([path])
        with pytest.raises(IOError, match="DAC"):
            native.decode_images([path])


@pytest.mark.parametrize("sof", ["sof9", "sof10"])
def test_arithmetic_jpeg_cut_short_matches_jax_decoder(tmp_path, transcode,
                                                       sof):
    """Arithmetic-coded files cut at ten lengths: past the end the decoder
    reads zero bytes (a marker inside arithmetic-coded data is legal), at
    each restart its statistics start again, and a progressive one cut
    before its last scans is block-smoothed. The zero data decodes to
    large coefficients: compared with libjpeg's C IDCT."""
    src = tmp_path / "s.jpg"
    Image.fromarray(_image(37, 53, seed=5, smooth=True)).save(
        src, quality=90, subsampling=2)
    raw = open(transcode(src, tmp_path / "a.jpg",
                         *_arith_flags(sof == "sof10", 2)), "rb").read()
    paths = []
    for frac in (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 0.97):
        paths.append(tmp_path / f"cut{frac}.jpg")
        paths[-1].write_bytes(raw[:int(len(raw) * frac)])
    assert _assert_same_as_c_idct(paths) >= 5


@settings(max_examples=10, deadline=None, database=None)
@given(h=st.integers(1, 40), w=st.integers(1, 40),
       sub=st.sampled_from([0, 1, 2]), prog=st.booleans(),
       quality=st.integers(20, 100), restart=st.integers(0, 4),
       seed=st.integers(0, 2 ** 16))
def test_random_arithmetic_jpegs_match_jax_decoder(
        tmp_path_factory, transcode, h, w, sub, prog, quality, restart,
        seed):
    """test_random_jpegs_match_jax_decoder's shapes, arithmetic-coded."""
    tmp = tmp_path_factory.mktemp("hyp")
    Image.fromarray(_image(h, w, seed, smooth=seed % 2 == 0)).save(
        tmp / "r.jpg", quality=quality, subsampling=sub)
    _assert_same_as_jax(transcode(tmp / "r.jpg", tmp / "a.jpg",
                                  *_arith_flags(prog, restart)))


@pytest.mark.parametrize("sub", [0, 1, 2])
def test_progressive_jpegs_cut_short_match_jax_decoder(tmp_path, sub):
    """Progressive files cut at ten fractions of their length: libjpeg
    block-smooths those whose scans leave some of AC coefficients 1-9
    unrefined (jdcoefct.c decompress_smooth_data: each block's estimates
    from the DC values of its 5 x 5 neighbours; without any AC data the
    DC smoothed too), the iMCU rows past where the last scan's data ran
    out with the progression before that scan. Its estimates can overflow
    the IDCT: compared with libjpeg's C IDCT."""
    paths = []
    for h, w in ((37, 53), (101, 77)):
        buf = io.BytesIO()
        Image.fromarray(_image(h, w, seed=h + sub, smooth=True)).save(
            buf, "JPEG", quality=90, subsampling=sub, progressive=True)
        raw = buf.getvalue()
        for frac in (0.15, 0.25, 0.35, 0.45, 0.55, 0.65, 0.75, 0.85, 0.93,
                     0.98):
            paths.append(tmp_path / f"{h}-{frac}.jpg")
            paths[-1].write_bytes(raw[:int(len(raw) * frac)])
    smoothed = 0
    for path in paths:
        try:
            smoothed += int(read_jpeg(str(path), path.read_bytes())
                            .desc[D_SMOOTH])
        except IOError:
            pass
    assert smoothed >= 5
    assert _assert_same_as_c_idct(paths) >= 10


SCRIPTS = {"ac1-9-unrefined": "0,1,2:0-0,0,1;0:1-9,0,2;1:1-9,0,1;"
                              "0:10-63,0,0;1:10-63,0,0;2:1-63,0,0;"
                              "0,1,2:0-0,1,0",
           "dc-only": "0,1,2:0-0,0,0"}


@pytest.mark.parametrize("script", SCRIPTS)
def test_smoothed_scan_scripts_match_jax_decoder(tmp_path, transcode,
                                                 script):
    """Whole progressive files libjpeg block-smooths: a scan script whose
    scans never refine AC coefficients 1-9 of the luma and of Cb (each
    estimate clamped below its coefficient's next bit), and one with the
    DC scan alone (every AC coefficient and the DC estimated), at SIZES x
    subsampling 0/1/2; compared with libjpeg's C IDCT."""
    paths = []
    for h, w in SIZES:
        for sub in (0, 1, 2):
            src = tmp_path / f"{h}x{w}-{sub}.jpg"
            Image.fromarray(_image(h, w, seed=w + sub, smooth=True)).save(
                src, quality=90, subsampling=sub)
            paths.append(transcode(src, tmp_path / f"p-{h}x{w}-{sub}.jpg",
                                   "-s", SCRIPTS[script]))
            assert read_jpeg(paths[-1], open(paths[-1], "rb").read()) \
                .desc[D_SMOOTH]
    assert _assert_same_as_c_idct(paths) == len(paths)


def test_corrupt_jpegs_the_jax_decoder_refuses_raise(tmp_path):
    """60 files with 1-3 entropy-coded bytes overwritten at random (seeded):
    every file the JAX decoder fails on raises IOError in the port, and
    every file it reads the port reads to the same pixels, under
    libjpeg-turbo's C IDCT (JSIMD_FORCENONE=1: its SIMD IDCT treats the
    overflowing coefficients of corrupt data otherwise), stray markers in
    the data included: libjpeg's resynchronization at a restart skips
    those it refuses elsewhere (tests/jpeg_fuzz.py: the same over 600
    files)."""
    rng = np.random.default_rng(12)
    paths = []
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
        paths.append(str(tmp_path / f"c{n}.jpg"))
        with open(paths[-1], "wb") as fh:
            fh.write(bytes(raw))
    read = _assert_same_as_c_idct(paths)
    assert 0 < read < len(paths)


def _rewritten(raw, marker, offset, value):
    b = bytearray(raw)
    b[raw.index(bytes([0xFF, marker])) + offset] = value
    return bytes(b)


@pytest.mark.parametrize("kind,match,jax_reads", [
    ("sof3", "lossless", False), ("sof5", "hierarchical", False),
    ("sof9", "arithmetic", True), ("sof10", "arithmetic", False),
    ("sof11", "lossless", False), ("sof13", "hierarchical", False),
    ("12-bit", "12-bit", False), ("cmyk", "4-component", False),
    ("progressive-cut", "block smoothing", True)])
def test_jpeg_refusals_name_their_reason(tmp_path, kind, match, jax_reads):
    """Files the JAX decoder reads the port reads to the same pixels; those
    it fails on the port refuses too, naming the kind (`match`) where the
    port does not read it. The SOF marker byte rewritten: SOF3 (lossless),
    SOF5 (hierarchical), SOF11 (arithmetic lossless) and SOF13
    (hierarchical arithmetic) are refused by name; SOF9 reads the Huffman
    data as arithmetic-coded (noise, the same in both); SOF10 fails on the
    baseline scan's Ss/Se as progressive parameters (IOError in both). The
    precision byte rewritten to 12 and a CMYK file are refused by name. A
    progressive file cut short before its last scans is block-smoothed,
    the same in both. Compared with libjpeg's C IDCT: the noise and the
    smoothing overflow the IDCT."""
    buf = io.BytesIO()
    img = Image.fromarray(_image(37, 53, seed=9))
    if kind == "cmyk":
        img.convert("CMYK").save(buf, "JPEG")
    else:
        img.save(buf, "JPEG", quality=90,
                 progressive=kind == "progressive-cut")
    raw = buf.getvalue()
    codes = {"sof3": 0xC3, "sof5": 0xC5, "sof9": 0xC9, "sof10": 0xCA,
             "sof11": 0xCB, "sof13": 0xCD}
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
        assert _assert_same_as_c_idct([path]) == 1
        return
    with pytest.raises(IOError):
        jdecode([path])
    if kind == "sof10":
        with pytest.raises(IOError, match="progressive parameters"):
            native.decode_images([path])
    else:
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


def test_view_pair_holds_its_digest():
    """tests/data/jpeg/view/: one 504x378 view as Huffman and SOF9 files of
    the same coefficients (chip_smoke.py phase 22d times them on the
    card's host): both decoders give each the uint8 pixels whose SHA-256
    sha256.json holds, the same for the two."""
    root = os.path.join(FIXTURES, "view")
    with open(os.path.join(root, "sha256.json")) as fh:
        want = json.load(fh)
    assert len(want) == 2 and len({v["sha256"] for v in want.values()}) == 1
    for name, ref in want.items():
        path = os.path.join(root, name)
        for px in (jdecode([path])[0], native.decode_images([path])[0]):
            u8 = np.round(px * 255).astype(np.uint8)
            assert list(u8.shape) == ref["shape"]
            assert hashlib.sha256(u8.tobytes()).hexdigest() == ref["sha256"]


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
