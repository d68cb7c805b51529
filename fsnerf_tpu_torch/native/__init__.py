"""The port's image decoder and a PNG writer.

`decode_images` reads PNG files to [N, H, W, C] float32 in [0, 1] (each
8-bit value times 1/255 in float32), the pixels fsnerf_tpu/native's
libpng decoder gives: 16-bit channels stripped to their high byte, a
palette expanded to RGB, gray to RGB, and a tRNS chunk to an alpha channel.
It is the only image reader of the port (data/blender.py::load_images).
The chunks are parsed and the image data inflated with Python's zlib;
the five PNG row filters are undone by loader.cpp, one image per thread,
which needs no library headers (libpng and libjpeg are not required). The
library builds with g++ at first use into fsnerf_tpu_torch/build/, under a
name that carries a hash of the source and the flags, so an edited source
rebuilds; a build that fails raises with the compiler's output. JPEG files
and interlaced PNGs raise.

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

SOURCE = Path(__file__).resolve().with_name("loader.cpp")
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-Wall", "-shared")
LIBS = ("-lpthread",)
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# images inflated and unfiltered together (bounds the host memory held)
BATCH = 64
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libfsnerf_loader_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """The unfilter library, compiled with g++ when it is not built yet;
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

    @property
    def samples(self) -> int:
        return {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[self.color]

    @property
    def rowbytes(self) -> int:
        return (self.width * self.samples * self.depth + 7) // 8

    @property
    def bpp(self) -> int:
        return max(1, self.samples * self.depth // 8)

    @property
    def channels(self) -> int:
        """Channels after the conversions: 3 (RGB) or 4 (RGBA)."""
        return 4 if self.color in (4, 6) or self.trns is not None else 3


def _read_png(path: str) -> _Png:
    with open(path, "rb") as fh:
        raw = fh.read()
    if raw[:2] == b"\xff\xd8":
        raise NotImplementedError(
            f"{path}: JPEG decoding needs jpeglib.h (libjpeg), which the "
            f"port's decoder does not use; convert the images to PNG")
    if raw[:8] != PNG_SIGNATURE:
        raise IOError(f"{path} is not a PNG file")
    pos, idat, fields = 8, [], {}
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
        elif kind == b"IEND":
            break
        pos += 12 + n
    if b"IHDR" not in fields or not idat:
        raise IOError(f"{path}: no IHDR or IDAT chunk")
    w, h, depth, color, _, _, interlace = struct.unpack(">IIBBBBB",
                                                        fields[b"IHDR"])
    if interlace:
        raise NotImplementedError(f"{path}: interlaced PNGs are not read")
    if color not in (0, 2, 3, 4, 6) or depth not in (1, 2, 4, 8, 16):
        raise IOError(f"{path}: bad color type {color} / depth {depth}")
    palette = None
    if color == 3:
        if b"PLTE" not in fields:
            raise IOError(f"{path}: palette image without PLTE")
        palette = np.frombuffer(fields[b"PLTE"], np.uint8).reshape(-1, 3)
    return _Png(path, w, h, depth, color, b"".join(idat), palette,
                fields.get(b"tRNS"))


def _samples(png: _Png, rows: np.ndarray) -> np.ndarray:
    """The unfiltered rows [H, rowbytes] as samples [H, W, samples] at the
    file's bit depth (uint16 for 16-bit files)."""
    h, w, s = png.height, png.width, png.samples
    if png.depth == 16:
        return rows.view(">u2").reshape(h, w, s).astype(np.uint16)
    if png.depth == 8:
        return rows.reshape(h, w, s)
    shifts = np.arange(8 - png.depth, -1, -png.depth, dtype=np.uint8)
    vals = (rows[:, :, None] >> shifts) & ((1 << png.depth) - 1)
    return vals.reshape(h, -1)[:, :w, None]


def _to_8bit(png: _Png, rows: np.ndarray) -> np.ndarray:
    """uint8 [H, W, 3 or 4] pixels of an image's unfiltered rows, converted
    as the libpng decoder converts them."""
    px = _samples(png, rows)
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


def probe_image(path: str):
    """(h, w, c) of an image file: c is 3, or 4 with an alpha channel."""
    png = _read_png(path)
    return png.height, png.width, png.channels


def _unfilter(pngs: List[_Png], n_threads: int) -> List[np.ndarray]:
    """Inflate each image's data and undo its row filters (loader.cpp, one
    image per thread); [H, rowbytes] uint8 per image. All images share H,
    rowbytes and bytes per pixel."""
    p0 = pngs[0]
    src = [np.frombuffer(zlib.decompress(p.data), np.uint8) for p in pngs]
    for p, a in zip(pngs, src):
        if a.size < p.height * (p.rowbytes + 1):
            raise IOError(f"{p.path}: truncated image data")
    dst = [np.empty((p0.height, p0.rowbytes), np.uint8) for _ in pngs]
    ptrs = ctypes.c_void_p * len(pngs)
    rc = get_lib().fsnerf_unfilter(
        len(pngs), ptrs(*[a.ctypes.data for a in src]),
        ptrs(*[a.ctypes.data for a in dst]), p0.height, p0.rowbytes,
        p0.bpp, n_threads)
    if rc:
        raise IOError(f"{pngs[rc - 1].path}: unknown PNG row filter")
    return dst


def decode_images(paths: List[str], n_threads: int = 0,
                  channels: Optional[int] = None) -> np.ndarray:
    """Decode `paths` to [N, H, W, C] float32 in [0, 1].

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
    inv255 = np.float32(1.0) / np.float32(255.0)
    for b0 in range(0, len(paths), BATCH):
        pngs = [_read_png(p) for p in paths[b0:b0 + BATCH]]
        groups = {}
        for i, p in enumerate(pngs):
            if (p.height, p.width) != (h, w):
                raise IOError(f"failed decoding {p.path} (size/format "
                              f"mismatch with {paths[0]}: {h}x{w})")
            groups.setdefault((p.rowbytes, p.bpp), []).append(i)
        for idx in groups.values():
            rows = _unfilter([pngs[i] for i in idx], n_threads)
            for i, r in zip(idx, rows):
                px = _to_8bit(pngs[i], r)[..., :c]
                dst = out[b0 + i]
                np.multiply(px, inv255, out=dst[..., :px.shape[-1]],
                            dtype=np.float32)
                if px.shape[-1] < c:
                    dst[..., 3] = 1.0
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
