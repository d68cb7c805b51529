"""Write the JPEG fixtures of tests/data/jpeg/ and their pixels.

    python tests/make_jpeg_fixtures.py

Needs gcc and libjpeg (the files of new kinds come from the coefficients
of others through tests/jpeg_transcode.c). Each fixture is a small JPEG
of one mode the port's decoder reads, most with a width and a height that
no MCU divides:

- PIL's and tests/torch_jpeg_writer.py's Huffman files: progressive,
  4:2:0 with restart markers, gray, 4:2:2, 4:4:0, an RGB JPEG;
- arithmetic-coded ones: SOF9 at 4:2:0 with restarts, SOF9 gray, SOF10
  at 4:2:2, SOF9 with other DAC conditioning than the default (arith_*);
- progressive Huffman files libjpeg block-smooths: one cut short, one
  whose scans never refine AC coefficients 1-9 (smoothed_*);
- two corrupt files of tests/jpeg_fuzz.py's set with a stray marker in
  the entropy-coded data that libjpeg reads by resynchronizing past it at
  a restart (resync_*).

pixels.npz holds, under each file's name, the uint8 pixels fsnerf_tpu's
libjpeg decoder gives: the port must decode each file to exactly those
values times 1/255 in float32 (tests/test_torch_jpeg.py on the CPU,
tests/test_torch_cuda.py and chip_smoke.py on the card's machine, which
has no libjpeg). Every fixture added with the arithmetic-coded ones
decodes to the same pixels with libjpeg-turbo's SIMD IDCT and its C IDCT
(JSIMD_FORCENONE=1), which the port mirrors and which differ where block
smoothing or corrupt data overflow the IDCT: the script checks it, so
that the stored pixels are libjpeg's either way.

view/ holds one 504x378 view (an LLFF images_8 size) twice, Huffman and
SOF9 from the same coefficients, for chip_smoke.py's host timing (phase
22d), and in sha256.json the SHA-256 of the uint8 pixels libjpeg gives
each (the two the same; their pixels would add ~1.1 MB to pixels.npz).
"""

import hashlib
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

from fsnerf_tpu.native import decode_images  # noqa: E402
from fsnerf_tpu_torch.native.jpeg import D_SMOOTH, read_jpeg  # noqa: E402
from jpeg_fuzz import corrupt_jpegs  # noqa: E402
from torch_jpeg_writer import write_jpeg  # noqa: E402

OUT = os.path.join(HERE, "data", "jpeg")
VIEW = os.path.join(OUT, "view")
# the arithmetic-coded fixtures: (name, source fixture, transcoder flags)
ARITH = (("arith_restart_420.jpg", "restart_420.jpg", ["-a", "-r", "3"]),
         ("arith_gray.jpg", "gray.jpg", ["-a"]),
         ("arith_prog_422.jpg", "optimized_422.jpg", ["-a", "-p"]),
         ("arith_dac_420.jpg", "progressive_420.jpg",
          ["-a", "-d", "2,6,12"]))
# a scan script that never refines luma AC 1-9 (left at Al 2)
NO_REFINE = ("0,1,2:0-0,0,1;0:1-9,0,2;0:10-63,0,0;1:1-63,0,0;2:1-63,0,0;"
             "0,1,2:0-0,1,0")
# tests/jpeg_fuzz.py's files (by index in its seeded set) that libjpeg reads
# past a stray marker, resynchronizing at a restart: a baseline and a
# progressive one
RESYNC = {421: "resync_baseline.jpg", 51: "resync_progressive.jpg"}
VIEW_H, VIEW_W = 378, 504


def transcoder(tmp: str) -> str:
    """tests/jpeg_transcode.c, compiled into tmp."""
    exe = os.path.join(tmp, "jpeg_transcode")
    subprocess.run(["gcc", "-O2", "-o", exe,
                    os.path.join(HERE, "jpeg_transcode.c"), "-ljpeg"],
                   check=True)
    return exe


def transcode(exe: str, src: str, dst: str, flags) -> None:
    subprocess.run([exe, *flags, src, dst], check=True)


_C_IDCT = """
import sys, numpy as np
from fsnerf_tpu.native import decode_images
out = {}
for i, path in enumerate(sys.argv[2:]):
    try:
        out[f"a{i}"] = decode_images([path])[0]
    except IOError:
        pass
np.savez(sys.argv[1], **out)
"""


def c_idct_pixels(paths) -> list:
    """fsnerf_tpu's decoder's float32 pixels of each file (None where it
    fails) with libjpeg-turbo's C IDCT: JSIMD_FORCENONE=1, which the
    library reads when it loads, so in a process of its own."""
    with tempfile.TemporaryDirectory() as tmp:
        npz = os.path.join(tmp, "c_idct.npz")
        subprocess.run([sys.executable, "-c", _C_IDCT, npz,
                        *(os.path.abspath(str(p)) for p in paths)],
                       check=True,
                       cwd=os.path.dirname(HERE), stderr=subprocess.DEVNULL,
                       env=dict(os.environ, JSIMD_FORCENONE="1"))
        with np.load(npz) as z:
            return [z[f"a{i}"] if f"a{i}" in z.files else None
                    for i in range(len(paths))]


def one_answer(path: str) -> bool:
    """Whether libjpeg's SIMD and C IDCTs give `path` the same pixels."""
    return np.array_equal(decode_images([path])[0], c_idct_pixels([path])[0])


def smoothed_cut(path: str) -> None:
    """A progressive 4:2:0 file cut short, at the first of a few lengths
    where libjpeg block-smooths it and its two IDCTs agree."""
    from io import BytesIO

    buf = BytesIO()
    Image.fromarray(smooth(29, 43, 6)).save(buf, "JPEG", quality=90,
                                            subsampling=2, progressive=True)
    raw = buf.getvalue()
    for frac in (0.5, 0.45, 0.55, 0.4, 0.6, 0.35, 0.65):
        cut = raw[:int(len(raw) * frac)]
        with open(path, "wb") as fh:
            fh.write(cut)
        try:
            smoothed = read_jpeg(path, cut).desc[D_SMOOTH]
        except IOError:     # cut in a marker segment libjpeg refuses
            continue
        if smoothed and one_answer(path):
            return
    raise RuntimeError("no cut of the smoothed fixture has one answer")


def view(h: int, w: int) -> np.ndarray:
    """chip_smoke.py phase 22c's content at an LLFF images_8 size."""
    rng = np.random.default_rng(2)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([128 + 100 * np.sin(xx / 10.4) * np.cos(yy / 7.6),
                    128 + 90 * np.cos((xx + yy) / 5.9),
                    (xx / 2 + yy / 1.5) % 256], -1)
    return (img + rng.normal(0, 3, img.shape)).clip(0, 255).astype(np.uint8)


def smooth(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([128 + 100 * np.sin(xx / 5.0), 128 + 90 * np.cos(yy / 4.0),
                    (xx * 5 + yy * 3) % 256], -1)
    return (img + rng.normal(0, 10, img.shape)).clip(0, 255).astype(np.uint8)


def main():
    os.makedirs(OUT, exist_ok=True)
    files = {
        "progressive_420.jpg": (smooth(45, 61, 0), dict(
            quality=90, subsampling=2, progressive=True)),
        "restart_420.jpg": (smooth(37, 53, 1), dict(
            quality=95, subsampling=2, restart_marker_blocks=2)),
        "gray.jpg": (smooth(31, 29, 2)[..., 0], dict(quality=85)),
        "optimized_422.jpg": (smooth(23, 45, 3), dict(
            quality=75, subsampling=1, optimize=True)),
        "rgb.jpg": (smooth(21, 33, 4), dict(quality=95, keep_rgb=True,
                                            subsampling=0)),
    }
    for name, (img, opts) in files.items():
        Image.fromarray(img).save(os.path.join(OUT, name), **opts)
    rgb = smooth(19, 27, 5)
    q = np.clip(np.arange(64) // 2 + 2, 1, 255)
    with open(os.path.join(OUT, "sampled_440.jpg"), "wb") as fh:
        fh.write(write_jpeg([rgb[..., i] for i in range(3)],
                            [(1, 2), (1, 1), (1, 1)], [q, q + 3, q + 3],
                            restart=2))
    added = []
    with tempfile.TemporaryDirectory() as tmp:
        exe = transcoder(tmp)
        for name, src, flags in ARITH:
            transcode(exe, os.path.join(OUT, src), os.path.join(OUT, name),
                      flags)
            added.append(name)
        src = os.path.join(tmp, "src.jpg")
        Image.fromarray(smooth(27, 35, 7)).save(src, quality=90,
                                                subsampling=2)
        transcode(exe, src, os.path.join(OUT, "smoothed_no_refine.jpg"),
                  ["-s", NO_REFINE])
        smoothed_cut(os.path.join(OUT, "smoothed_cut.jpg"))
        added += ["smoothed_no_refine.jpg", "smoothed_cut.jpg"]
        for i, raw in enumerate(corrupt_jpegs(max(RESYNC) + 1)):
            if i in RESYNC:
                with open(os.path.join(OUT, RESYNC[i]), "wb") as fh:
                    fh.write(raw)
                added.append(RESYNC[i])
        os.makedirs(VIEW, exist_ok=True)
        huff = os.path.join(VIEW, "view_504x378.jpg")
        Image.fromarray(view(VIEW_H, VIEW_W)).save(huff, quality=90,
                                                   subsampling=2)
        transcode(exe, huff, os.path.join(VIEW, "view_504x378_arith.jpg"),
                  ["-a"])
    bad = [n for n in added if not one_answer(os.path.join(OUT, n))]
    if bad:
        raise RuntimeError(f"libjpeg's two IDCTs disagree on {bad}")
    digests = {}
    for name in sorted(os.listdir(VIEW)):
        if name.endswith(".jpg"):
            px = np.round(decode_images([os.path.join(VIEW, name)])[0]
                          * 255).astype(np.uint8)
            digests[name] = {"shape": list(px.shape), "sha256":
                             hashlib.sha256(px.tobytes()).hexdigest()}
    with open(os.path.join(VIEW, "sha256.json"), "w") as fh:
        json.dump(digests, fh, indent=1, sort_keys=True)
        fh.write("\n")
    pixels = {}
    for name in sorted(os.listdir(OUT)):
        if name.endswith(".jpg"):
            f = decode_images([os.path.join(OUT, name)])[0]
            pixels[name] = np.round(f * 255).astype(np.uint8)
    np.savez_compressed(os.path.join(OUT, "pixels.npz"), **pixels)
    print({k: v.shape for k, v in pixels.items()})


if __name__ == "__main__":
    main()
