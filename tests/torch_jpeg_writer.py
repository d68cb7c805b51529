"""A small baseline JPEG writer for the decoder tests: the layouts PIL does
not write (4:4:0 and 4:1:1 sampling, one scan per component, 16-bit
quantization tables, an Adobe marker or none, any component IDs).

The files are valid sequential Huffman JPEGs (SOF0, or SOF1 with 16-bit
tables) coded with the standard tables of the JPEG standard's Annex K;
their pixels are whatever a decoder makes of them, which the tests hold
between two decoders.
"""

import struct

import numpy as np

from fsnerf_tpu_torch.native.jpeg import (NATURAL, _STD_AC_BITS,
                                          _STD_AC_VALS, _STD_DC_BITS,
                                          _STD_DC_VALS)

_K = np.arange(8)
# the orthonormal 8-point DCT-II matrix
_DCT = np.sqrt(np.where(_K[:, None] == 0, 1 / 8, 2 / 8)) * np.cos(
    (2 * _K[None, :] + 1) * _K[:, None] * np.pi / 16)


def _codes(bits, vals):
    """{symbol: (code, length)} of a canonical Huffman table."""
    out, code, k = {}, 0, 0
    for length, n in enumerate(bits, 1):
        for _ in range(n):
            out[vals[k]] = (code, length)
            code, k = code + 1, k + 1
        code <<= 1
    return out


class _Bits:
    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, code, length):
        self.acc, self.n = (self.acc << length) | code, self.n + length
        while self.n >= 8:
            self.n -= 8
            byte = (self.acc >> self.n) & 0xFF
            self.out.append(byte)
            if byte == 0xFF:
                self.out.append(0)

    def flush(self):
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)


def _segment(marker, body):
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def write_jpeg(planes, sampling, quality_tables, *, ids=None,
               interleaved=True, restart=0, jfif=True, adobe=None):
    """The bytes of a baseline JPEG.

    planes: uint8 [H, W] per component, full size (each is decimated to its
    sampling); sampling: (h, v) per component; quality_tables: one [64]
    quantization table (natural order) per component, 16-bit in the file
    when any value exceeds 255; ids: component IDs (1, 2, 3 ...);
    interleaved: one scan of every component, else one scan each;
    restart: the restart interval in MCUs; jfif: write a JFIF APP0;
    adobe: the transform byte of an Adobe APP14 marker (None: none).
    """
    n = len(planes)
    height, width = planes[0].shape
    ids = ids or list(range(1, n + 1))
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    dc_codes = _codes(_STD_DC_BITS[0], _STD_DC_VALS)
    ac_codes = _codes(_STD_AC_BITS[0], _STD_AC_VALS[0])
    out = bytearray(b"\xff\xd8")
    if jfif:
        out += _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    if adobe is not None:
        out += _segment(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00"
                        + bytes([adobe]))
    wide = any(np.max(q) > 255 for q in quality_tables)
    for i, q in enumerate(quality_tables):
        zz = np.asarray(q)[NATURAL]
        body = (bytes([0x10 | i]) + zz.astype(">u2").tobytes()
                if np.max(q) > 255 else bytes([i]) + zz.astype(np.uint8)
                .tobytes())
        out += _segment(0xDB, body)
    sof = struct.pack(">BHHB", 8, height, width, n)
    for i, (h, v) in enumerate(sampling):
        sof += bytes([ids[i], (h << 4) | v, i])
    out += _segment(0xC1 if wide else 0xC0, sof)
    out += _segment(0xC4, bytes([0x00, *_STD_DC_BITS[0], *_STD_DC_VALS])
                    + bytes([0x10, *_STD_AC_BITS[0]]) + _STD_AC_VALS[0])
    if restart:
        out += _segment(0xDD, struct.pack(">H", restart))

    mcus_x = -(-width // (hmax * 8))
    mcus_y = -(-height // (vmax * 8))
    coefs = []
    for (h, v), plane, q in zip(sampling, planes, quality_tables):
        sub = plane[::vmax // v, ::hmax // h].astype(np.float64)
        ph, pw = mcus_y * v * 8, mcus_x * h * 8
        sub = np.pad(sub, ((0, ph - sub.shape[0]), (0, pw - sub.shape[1])),
                     mode="edge")
        blocks = (sub - 128).reshape(ph // 8, 8, pw // 8, 8).transpose(
            0, 2, 1, 3)
        dct = _DCT @ blocks @ _DCT.T
        quant = np.round(dct.reshape(ph // 8, pw // 8, 64)
                         / np.asarray(q, np.float64)).astype(np.int64)
        dw, dh = -(-width * h // hmax), -(-height * v // vmax)
        coefs.append((quant[..., NATURAL], -(-dw // 8), -(-dh // 8)))

    def code_block(bits, zz, pred):
        diff = int(zz[0]) - pred
        size = int(abs(diff)).bit_length()
        bits.put(*dc_codes[size])
        if size:
            bits.put(diff if diff > 0 else diff + (1 << size) - 1, size)
        run = 0
        last = max([k for k in range(1, 64) if zz[k]] or [0])
        for k in range(1, last + 1):
            c = int(zz[k])
            if c == 0:
                run += 1
                continue
            while run > 15:
                bits.put(*ac_codes[0xF0])
                run -= 16
            size = abs(c).bit_length()
            bits.put(*ac_codes[(run << 4) | size])
            bits.put(c if c > 0 else c + (1 << size) - 1, size)
            run = 0
        if last < 63:
            bits.put(*ac_codes[0x00])
        return int(zz[0])

    scans = [list(range(n))] if interleaved else [[i] for i in range(n)]
    for comps in scans:
        sos = bytes([len(comps)])
        for i in comps:
            sos += bytes([ids[i], 0x00])
        out += _segment(0xDA, sos + b"\x00\x3f\x00")
        if len(comps) == 1:
            c = comps[0]
            _, bw, bh = coefs[c]
            units = [[(c, by, bx)] for by in range(bh) for bx in range(bw)]
        else:
            units = [[(c, my * sampling[c][1] + yi, mx * sampling[c][0] + xi)
                      for c in comps for yi in range(sampling[c][1])
                      for xi in range(sampling[c][0])]
                     for my in range(mcus_y) for mx in range(mcus_x)]
        bits, pred, rst = _Bits(), [0] * n, 0
        for u, unit in enumerate(units):
            if restart and u and u % restart == 0:
                bits.flush()
                bits.out += bytes([0xFF, 0xD0 + rst])
                rst, pred = (rst + 1) & 7, [0] * n
            for c, by, bx in unit:
                pred[c] = code_block(bits, coefs[c][0][by, bx], pred[c])
        bits.flush()
        out += bits.out
    return bytes(out + b"\xff\xd9")
