"""The port's image decoder and a PNG writer.

`decode_images` reads PNG and JPEG files, in any mix, to [N, H, W, C]
float32 in [0, 1] (each 8-bit value times 1/255 in float32): the pixels
fsnerf_tpu/native's libpng / libjpeg decoder gives. A file is a PNG or a
JPEG by its suffix, else by its magic bytes, as that decoder's decode_any
decides.

PNG: 16-bit channels stripped to their high byte, a palette expanded to
RGB, gray to RGB, and a valid tRNS chunk to an alpha channel; an
Adam7-interlaced file is decoded pass by pass. The chunks are parsed and
the image data inflated with Python's zlib; the five row filters are undone
by loader.cpp, one image per thread.

JPEG (native/jpeg.py): the markers are parsed in Python, and loader.cpp
decodes each image on its own thread as libjpeg-turbo 2.1.5 decodes it
with that decoder's settings (RGB output, the islow IDCT, fancy
upsampling, block smoothing), Huffman or arithmetic-coded; the kinds of
JPEG it refuses (those libjpeg-turbo refuses too) raise
NotImplementedError naming why.

It is the only image reader of the port (data/blender.py, data/llff.py)
and needs no image library: loader.cpp includes no library headers, and
neither libpng nor libjpeg is linked. The library builds with g++ at first
use into fsnerf_tpu_torch/build/, under a name that carries a hash of the
source and the flags, so an edited source rebuilds; a build that fails
raises with the compiler's output.

`write_png` writes 8-bit RGB or RGBA PNGs (filter 0 on every row), for the
path renders' frames and for synthesized scenes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
import zlib
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

import numpy as np

from . import jpeg

SOURCE = Path(__file__).resolve().with_name("loader.cpp")
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-Wall", "-shared")
LIBS = ("-lpthread",)
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# Adam7's passes: (first column, first row, column step, row step)
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
# images read and decoded together (bounds the host memory held)
BATCH = 64
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libfsnerf_loader_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """The decoder's library (loader.cpp), compiled with g++ when it is not built yet;
    RuntimeError with the compiler's output when the build fails."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE), *LIBS]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"the image decoder did not build: {' '.join(cmd)}"
                           f" -> {proc.returncode}\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, path)
    return path


def get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.fsnerf_unfilter.restype = ctypes.c_int
        lib.fsnerf_unfilter.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_void_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int]
        lib.fsnerf_jpeg_decode.restype = ctypes.c_int
        lib.fsnerf_jpeg_decode.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_void_p), ctypes.c_int, ctypes.c_int]
        _lib = lib
    return _lib


@dataclass
class _Png:
    """One PNG file's header and chunks."""

    path: str
    width: int
    height: int
    depth: int            # bits per sample
    color: int            # 0 gray, 2 RGB, 3 palette, 4 gray+alpha, 6 RGBA
    data: bytes           # the concatenated IDAT chunks (deflated)
    palette: Optional[np.ndarray] = None    # [P, 3] uint8
    trns: Optional[bytes] = None
    interlaced: bool = False                  # Adam7

    @property
    def samples(self) -> int:
        return {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[self.color]

    def rowbytes_of(self, w: int) -> int:
        """Bytes of a row of `w` pixels, without its filter byte."""
        return (w * self.samples * self.depth + 7) // 8

    @property
    def rowbytes(self) -> int:
        return self.rowbytes_of(self.width)

    @property
    def bpp(self) -> int:
        return max(1, self.samples * self.depth // 8)

    @property
    def channels(self) -> int:
        """Channels after the conversions: 3 (RGB) or 4 (RGBA)."""
        return 4 if self.color in (4, 6) or self.trns is not None else 3


def _read_png(path: str, raw: bytes) -> _Png:
    """The header and chunks of the PNG file `path`, whose bytes are
    `raw`."""
    if raw[:8] != PNG_SIGNATURE:
        raise IOError(f"{path} is not a PNG file")
    pos, idat, fields, early_trns = 8, [], {}, False
    while pos + 12 <= len(raw):
        (n,) = struct.unpack(">I", raw[pos:pos + 4])
        kind, body = raw[pos + 4:pos + 8], raw[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", raw[pos + 8 + n:pos + 12 + n])
        if len(body) != n or zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise IOError(f"{path}: corrupt {kind.decode(errors='replace')} "
                          f"chunk")
        if kind == b"IDAT":
            idat.append(body)
        elif kind in (b"IHDR", b"PLTE", b"tRNS"):
            fields[kind] = body
            early_trns |= kind == b"tRNS" and b"PLTE" not in fields
        elif kind == b"IEND":
            break
        pos += 12 + n
    if b"IHDR" not in fields or not idat:
        raise IOError(f"{path}: no IHDR or IDAT chunk")
    w, h, depth, color, _, _, interlace = struct.unpack(">IIBBBBB",
                                                        fields[b"IHDR"])
    if interlace not in (0, 1):
        raise IOError(f"{path}: unknown interlace method {interlace}")
    if color not in (0, 2, 3, 4, 6) or depth not in (1, 2, 4, 8, 16):
        raise IOError(f"{path}: bad color type {color} / depth {depth}")
    palette = None
    if color == 3:
        if b"PLTE" not in fields:
            raise IOError(f"{path}: palette image without PLTE")
        palette = np.frombuffer(fields[b"PLTE"], np.uint8).reshape(-1, 3)
    trns = fields.get(b"tRNS")
    # png_handle_tRNS: a chunk of the wrong length for the color type, or
    # a palette's before its PLTE, is invalid (a warning) and ignored
    if trns is not None and not (
            len(trns) == 2 if color == 0 else len(trns) == 6 if color == 2
            else color == 3 and 0 < len(trns) <= len(palette)
            and not early_trns):
        trns = None
    return _Png(path, w, h, depth, color, b"".join(idat), palette, trns,
                bool(interlace))


def _samples(png: _Png, rows: np.ndarray, w: int) -> np.ndarray:
    """Unfiltered rows [h, rowbytes] of `w` pixels as samples [h, w,
    samples] at the file's bit depth (uint16 for 16-bit files)."""
    h, s = rows.shape[0], png.samples
    if png.depth == 16:
        return rows.view(">u2").reshape(h, w, s).astype(np.uint16)
    if png.depth == 8:
        return rows.reshape(h, w, s)
    shifts = np.arange(8 - png.depth, -1, -png.depth, dtype=np.uint8)
    vals = (rows[:, :, None] >> shifts) & ((1 << png.depth) - 1)
    return vals.reshape(h, -1)[:, :w, None]


def _to_8bit(png: _Png, px: np.ndarray) -> np.ndarray:
    """uint8 [H, W, 3 or 4] pixels of an image's samples [H, W, samples],
    converted as the libpng decoder converts them."""
    alpha = None
    if png.trns is not None and png.color in (0, 2):
        key = np.frombuffer(png.trns, ">u2")[:png.samples]
        alpha = np.where((px == key).all(-1), 0, 255).astype(np.uint8)
    if png.color == 3:
        idx = px[..., 0]
        out = png.palette[idx]
        if png.trns is not None:
            a = np.full(len(png.palette), 255, np.uint8)
            t = np.frombuffer(png.trns, np.uint8)[:len(a)]
            a[:len(t)] = t
            out = np.concatenate([out, a[idx][..., None]], -1)
        return out
    if png.depth == 16:
        px = (px >> 8).astype(np.uint8)
    elif png.depth < 8:
        px = (px * (255 // ((1 << png.depth) - 1))).astype(np.uint8)
    if png.color in (0, 4):
        px = np.concatenate([np.repeat(px[..., :1], 3, -1), px[..., 1:]], -1)
    if alpha is not None:
        px = np.concatenate([px, alpha[..., None]], -1)
    return px


def _unfilter(src: List[np.ndarray], h: int, rowbytes: int, bpp: int,
              n_threads: int, paths: List[str]) -> List[np.ndarray]:
    """Undo the row filters of images that share h, rowbytes and bytes per
    pixel (loader.cpp, one image per thread): src[i] holds h rows of one
    filter byte and rowbytes bytes; returns [h, rowbytes] uint8 each."""
    for p, a in zip(paths, src):
        if a.size < h * (rowbytes + 1):
            raise IOError(f"{p}: truncated image data")
    dst = [np.empty((h, rowbytes), np.uint8) for _ in src]
    ptrs = ctypes.c_void_p * len(src)
    rc = get_lib().fsnerf_unfilter(
        len(src), ptrs(*[a.ctypes.data for a in src]),
        ptrs(*[a.ctypes.data for a in dst]), h, rowbytes, bpp, n_threads)
    if rc:
        raise IOError(f"{paths[rc - 1]}: unknown PNG row filter")
    return dst


def _adam7_samples(png: _Png, data: np.ndarray,
                   n_threads: int) -> np.ndarray:
    """Samples [H, W, samples] of an Adam7-interlaced image from its
    inflated data: seven passes, each a sub-image of its own width, row
    bytes and filter bytes (none where the image is too small for it),
    unfiltered and scattered to its pixels."""
    px = np.empty((png.height, png.width, png.samples),
                  np.uint16 if png.depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy in ADAM7:
        pw = (png.width - x0 + dx - 1) // dx
        ph = (png.height - y0 + dy - 1) // dy
        if pw <= 0 or ph <= 0:
            continue
        rb = png.rowbytes_of(pw)
        (rows,) = _unfilter([data[pos:pos + ph * (rb + 1)]], ph, rb, png.bpp,
                            n_threads, [png.path])
        pos += ph * (rb + 1)
        px[y0::dy, x0::dx] = _samples(png, rows, pw)
    return px


def _decode_pngs(pngs: List[_Png], dst: List[np.ndarray],
                 n_threads: int) -> None:
    """Decode `pngs` into the float32 [H, W, C] arrays `dst`."""
    inv255 = np.float32(1.0) / np.float32(255.0)
    data = [np.frombuffer(zlib.decompress(p.data), np.uint8) for p in pngs]
    px = [None] * len(pngs)
    groups = {}
    for i, p in enumerate(pngs):
        if p.interlaced:
            px[i] = _adam7_samples(p, data[i], n_threads)
        else:
            groups.setdefault((p.rowbytes, p.bpp), []).append(i)
    for (rowbytes, bpp), idx in groups.items():
        rows = _unfilter([data[i] for i in idx], pngs[idx[0]].height,
                         rowbytes, bpp, n_threads,
                         [pngs[i].path for i in idx])
        for i, r in zip(idx, rows):
            px[i] = _samples(pngs[i], r, pngs[i].width)
    for p, x, out in zip(pngs, px, dst):
        c = out.shape[-1]
        x = _to_8bit(p, x)[..., :c]
        np.multiply(x, inv255, out=out[..., :x.shape[-1]], dtype=np.float32)
        if x.shape[-1] < c:
            out[..., 3] = 1.0


def _is_png(path: str, raw: bytes) -> bool:
    """Whether fsnerf_tpu/native's decode_any reads `path` as a PNG (True)
    or a JPEG (False): by the suffix, else by the magic bytes."""
    lower = path.lower()
    if lower.endswith(".png"):
        return True
    if lower.endswith((".jpg", ".jpeg")):
        return False
    if len(raw) >= 4 and raw[:2] == b"\x89P":
        return True
    if len(raw) >= 4 and raw[:2] == b"\xff\xd8":
        return False
    raise IOError(f"{path} is neither a PNG nor a JPEG file")


def _read(path: str):
    """A _Png or a jpeg.Jpeg of the image file `path`."""
    with open(path, "rb") as fh:
        raw = fh.read()
    if _is_png(path, raw):
        return _read_png(path, raw)
    return jpeg.read_jpeg(path, raw)


def probe_image(path: str):
    """(h, w, c) of an image file: c is 3, or 4 with an alpha channel (a
    JPEG is always 3)."""
    img = _read(path)
    if isinstance(img, _Png):
        return img.height, img.width, img.channels
    return img.height, img.width, 3


def decode_images(paths: List[str], n_threads: int = 0,
                  channels: Optional[int] = None) -> np.ndarray:
    """Decode `paths`, PNG and JPEG files in any mix, to [N, H, W, C]
    float32 in [0, 1].

    All images must share H x W; `channels` defaults to the first image's
    channel count (3 or 4), and the others are converted to it (an alpha
    channel of 1 added, or the alpha dropped).
    """
    if not paths:
        raise ValueError("no images to decode")
    h, w, c = probe_image(paths[0])
    if channels is not None:
        c = channels
    out = np.empty((len(paths), h, w, c), np.float32)
    for b0 in range(0, len(paths), BATCH):
        imgs = [_read(p) for p in paths[b0:b0 + BATCH]]
        for img in imgs:
            if (img.height, img.width) != (h, w):
                raise IOError(f"failed decoding {img.path} (size/format "
                              f"mismatch with {paths[0]}: {h}x{w})")
        pngs = [i for i, img in enumerate(imgs) if isinstance(img, _Png)]
        jpegs = [i for i, img in enumerate(imgs)
                 if not isinstance(img, _Png)]
        if pngs:
            _decode_pngs([imgs[i] for i in pngs],
                         [out[b0 + i] for i in pngs], n_threads)
        if jpegs:
            jpeg.decode_into([imgs[i] for i in jpegs],
                             [out[b0 + i] for i in jpegs], n_threads)
    return out


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """The PNG bytes of a uint8 [H, W, 3] (RGB) or [H, W, 4] (RGBA) image,
    8 bits per channel, every row filtered with filter 0 (none)."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[-1] not in (3, 4):
        raise ValueError(f"write_png takes uint8 [H, W, 3 or 4], not "
                         f"{img.dtype} {list(img.shape)}")
    h, w, c = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           img.reshape(h, w * c)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, 6 if c == 4 else 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + _chunk(b"IEND", b""))


def write_png(path, img: np.ndarray) -> None:
    """Write `img` (see encode_png) to `path`."""
    with open(path, "wb") as fh:
        fh.write(encode_png(img))
