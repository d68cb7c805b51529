"""JPEG files for the port's image decoder: markers and tables in Python,
the hot loops in loader.cpp.

`read_jpeg` parses a file's markers as libjpeg-turbo 2.1.5's marker reader
does (jdmarker.c) and lays its frame, scans, quantization tables (latched
at each component's first scan, jdinput.c), Huffman tables, arithmetic
conditioning (DAC, as each scan starts with it) and block smoothing's
progression latches out as flat arrays; `decode_into` hands them to
loader.cpp's `fsnerf_jpeg_decode`, which decodes one image per thread
(entropy decoding, block smoothing, dequantization, the islow integer
IDCT, fancy upsampling and YCbCr -> RGB, each as libjpeg-turbo computes
it) and writes float32 pixels (each 8-bit value times 1/255). The pixels
are those fsnerf_tpu/native's libjpeg decoder gives with its settings:
JCS_RGB output, JDCT_ISLOW, fancy upsampling, block smoothing on, whole
file read before output.

Read: 8-bit JPEGs, Huffman or arithmetic-coded, baseline / extended
sequential (SOF0, SOF1, SOF9) and progressive (SOF2, SOF10); interleaved
and non-interleaved scans; any integral sampling factors; restart
intervals; 8- and 16-bit quantization tables; DAC conditioning; one
component (gray, output as RGB) or three (YCbCr, or RGB when an Adobe
marker says transform 0 or the component IDs are 'R', 'G', 'B' without a
JFIF marker). A progressive file whose scans leave any of AC coefficients
1-9 unrefined (a download cut short, or such a scan script) is
block-smoothed as libjpeg smooths it (jdcoefct.c). A file cut short
decodes as libjpeg decodes it: the missing data reads as zero bits, then
as empty blocks; a marker segment cut short reads the stdio source's fake
EOIs. Corrupt data follows libjpeg-turbo's C code (restart
resynchronization, which may skip a stray marker libjpeg refuses
elsewhere, garbage codes, the IDCT wrapping overflowing values; its SIMD
IDCT, which libjpeg-turbo runs where the CPU has it, computes those in
16-bit lanes and differs).

Refused, by name, as the JAX decoder refuses them: lossless (SOF3, SOF11),
hierarchical (SOF5-7, SOF13-15), 12-bit samples, components other than 1
or 3 (CMYK / YCCK), fractional sampling ratios.
"""

from __future__ import annotations

import ctypes
import struct
from dataclasses import dataclass
from typing import List

import numpy as np

# jpeg_natural_order: zigzag index -> natural (row-major) index
NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
# the layout of `desc` (loader.cpp reads the same offsets)
(D_WIDTH, D_HEIGHT, D_NCOMP, D_COLOR, D_NSCANS, D_HMAX, D_VMAX,
 D_PROGRESSIVE) = range(8)
D_COMPS = 8             # h, v of component c at D_COMPS + 2 c
D_SMOOTH = 16           # 1: block smoothing (jdcoefct.c) applies
D_LATCH = 17            # component c's coef_bits_latch[10], then its
LATCH_WORDS = 20        # prev_coef_bits_latch[10], at D_LATCH + 20 c
D_SCANS = D_LATCH + 4 * LATCH_WORDS   # scan s at D_SCANS + SCAN_WORDS s
# a scan's words: the number of its components, their indices (4), Ss, Se,
# Ah, Al, the restart interval, where its data starts, per component the
# Huffman DC and AC tables (4 + 4: rows of huff, -1 where none), whether
# it is arithmetic-coded, whether a marker libjpeg refuses lies in its
# data (S_LOW), and per component its arithmetic conditioning (COND_WORDS
# each: DC and AC table numbers, then arith_dc_L and arith_dc_U of its DC
# table and arith_ac_K of its AC table)
(S_N, S_COMPS, S_SS, S_SE, S_AH, S_AL, S_RESTART, S_START, S_DC, S_AC,
 S_ARITH, S_LOW, S_COND) = (0, 1, 5, 6, 7, 8, 9, 10, 11, 15, 19, 20, 21)
COND_WORDS = 5
SCAN_WORDS = S_COND + 4 * COND_WORDS
COLOR_GRAY, COLOR_YCC, COLOR_RGB = 0, 1, 2
NUM_ARITH_TBLS = 16
MAX_SAMP, MAX_BLOCKS_IN_MCU, MAX_DIMENSION = 4, 10, 65500
# quantizer positions block smoothing divides by (jdcoefct.c: Q00 .. Q30)
SMOOTH_Q = (0, 1, 8, 16, 9, 2, 3, 10, 17, 24)
# the SOF markers read: (progressive, arithmetic-coded)
SOF_READ = {0xC0: (False, False), 0xC1: (False, False), 0xC2: (True, False),
            0xC9: (False, True), 0xCA: (True, True)}
SOF_NAMES = {
    0xC3: "lossless (SOF3)", 0xC5: "hierarchical (SOF5)",
    0xC6: "hierarchical (SOF6)", 0xC7: "hierarchical (SOF7)",
    0xCB: "arithmetic-coded lossless (SOF11)",
    0xCD: "hierarchical arithmetic-coded (SOF13)",
    0xCE: "hierarchical arithmetic-coded (SOF14)",
    0xCF: "hierarchical arithmetic-coded (SOF15)"}

# jstdhuff.c: the tables libjpeg-turbo's sequential decoder assumes for
# slots 0 and 1 that no DHT defined by the first scan (Motion-JPEG files
# omit them)
_STD_DC_BITS = ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0),
                (0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0))
_STD_DC_VALS = tuple(range(12))
_STD_AC_BITS = ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d),
                (0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77))
_STD_AC_VALS = (bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f024"
    "33627282090a161718191a25262728292a3435363738393a434445464748494a"
    "535455565758595a636465666768696a737475767778797a838485868788898a"
    "92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6"
    "c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9"
    "fa"), bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
    "f9fa"))


@dataclass
class Jpeg:
    """One JPEG file laid out for loader.cpp."""

    path: str
    width: int
    height: int
    data: np.ndarray      # uint8: the file's bytes, then 0xFF 0xD9
    desc: np.ndarray      # int32: frame and scans (the D_* layout)
    qt: np.ndarray        # int16 [components, 64]: latched, natural order
    huff: np.ndarray      # int32 [tables, 16 + 256]: counts, then symbols


def _huff_table(path: str, bits, vals, dc: bool) -> np.ndarray:
    """One Huffman table as loader.cpp takes it, after the checks of
    jdhuff.c::jpeg_make_d_derived_tbl: no code of a length runs out of
    that length's codes, and DC symbols are at most 15."""
    code = 0
    for length, n in enumerate(bits, 1):
        code += n
        if code >= (1 << length):
            raise IOError(f"{path}: bad Huffman table")
        code <<= 1
    count = sum(bits)
    if dc and any(v > 15 for v in vals[:count]):
        raise IOError(f"{path}: bad Huffman table (DC symbol above 15)")
    row = np.zeros(16 + 256, np.int32)
    row[:16] = bits
    row[16:16 + count] = list(vals[:count])
    return row


class _Markers:
    """jdmarker.c::next_marker over a file's bytes: the next marker at or
    after a position, a marker being a run of 0xFF then a byte other than
    0x00 (a stuffed 0xFF data byte) and 0xFF. Where a marker does not
    follow at once (after entropy-coded data), every marker position of
    the file is found once, vectorized."""

    def __init__(self, buf: bytes):
        self.buf, self.where = buf, None

    def next(self, pos: int):
        """(marker code, the position after it), or None past the end."""
        buf = self.buf
        if pos + 1 < len(buf) and buf[pos] == 0xFF \
                and buf[pos + 1] not in (0x00, 0xFF):
            return buf[pos + 1], pos + 2
        if self.where is None:
            a = np.frombuffer(buf, np.uint8)
            self.where = np.flatnonzero((a[:-1] == 0xFF) & (a[1:] != 0x00)
                                        & (a[1:] != 0xFF))
        k = int(np.searchsorted(self.where, pos))
        if k == len(self.where):
            return None
        i = int(self.where[k])
        return buf[i + 1], i + 2


def _frame(path, seg):
    """(height, width, [(id, h, v, tq)]) of an 8-bit SOF segment
    (jdmarker.c::get_sof, jdinput.c::initial_setup)."""
    if len(seg) < 6:
        raise IOError(f"{path}: bad SOF marker length")
    prec, h, w, n = struct.unpack(">BHHB", seg[:6])
    if h <= 0 or w <= 0 or n <= 0:
        raise IOError(f"{path}: empty JPEG image (DNL not supported)")
    if len(seg) != 6 + 3 * n:
        raise IOError(f"{path}: bad SOF marker length")
    if prec != 8:
        raise NotImplementedError(
            f"{path}: {prec}-bit JPEG samples; only 8-bit JPEGs are read, "
            f"as libjpeg-turbo's 8-bit decoder reads")
    if h > MAX_DIMENSION or w > MAX_DIMENSION:
        raise IOError(f"{path}: image too large ({w}x{h})")
    comps = []
    for i in range(n):
        cid, hv, tq = seg[6 + 3 * i:9 + 3 * i]
        hs, vs = hv >> 4, hv & 15
        if not (1 <= hs <= MAX_SAMP and 1 <= vs <= MAX_SAMP):
            raise IOError(f"{path}: bad sampling factors {hs}x{vs}")
        comps.append((cid, hs, vs, tq))
    return h, w, comps


def read_jpeg(path: str, raw: bytes) -> Jpeg:
    """Parse the JPEG file `path`, whose bytes are `raw`: IOError when it
    is not a readable JPEG, NotImplementedError (naming the reason) for
    the kinds of JPEG listed in the module docstring as refused."""
    if raw[:2] != b"\xff\xd8":
        raise IOError(f"{path} is not a JPEG file")
    # the stdio source of libjpeg ends a file cut short with a fake EOI
    buf = raw + b"\xff\xd9"
    markers = _Markers(buf)
    pos, frame, progressive, arith = 2, None, False, False
    qtabs, slots, tables = {}, {}, []
    # jdmarker.c::get_soi: the arithmetic conditioning's defaults
    dc_l, dc_u = [0] * NUM_ARITH_TBLS, [1] * NUM_ARITH_TBLS
    ac_k = [5] * NUM_ARITH_TBLS
    restart, jfif, adobe, transform = 0, False, False, None
    latched, scans, coef_bits, prev_bits = {}, [], None, None
    in_data = False     # between a scan's header and the marker ending it
    while True:
        found = markers.next(pos)
        if found is None:
            raise IOError(f"{path}: no EOI marker")
        marker, pos = found
        if marker == 0xD9:                                    # EOI
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:          # RSTn, TEM
            continue
        if marker < 0xC0 and in_data:
            # A marker libjpeg refuses, inside a scan's entropy-coded data:
            # the scan's resynchronization at a restart boundary may skip
            # it, which only the decoder knows. loader.cpp refuses the file
            # unless it did (jdmarker.c: read_restart_marker,
            # jpeg_resync_to_restart).
            scans[-1][S_LOW] = 1
            continue
        in_data = False
        if marker == 0xD8:
            raise IOError(f"{path}: duplicate SOI marker")
        skipped = 0xE0 <= marker <= 0xEF or marker in (0xFE, 0xDC)
        # past the end of a file cut short the stdio source reads fake EOIs
        # (0xFF 0xD9 again and again): a length or a segment cut short
        # reads them, and the file then ends at the next one
        (length,) = struct.unpack(">H", buf[pos:pos + 2])
        if pos + length > len(raw):
            if skipped:
                break       # skipped into the fake EOIs
            buf += b"\xff\xd9" * ((pos + length - len(buf)) // 2 + 2)
            markers = _Markers(buf)
        if length < 2 and not skipped:
            raise IOError(f"{path}: bad marker length {length}")
        seg, pos = buf[pos + 2:pos + length], pos + max(length, 2)
        if marker in SOF_READ:
            if frame is not None:
                raise IOError(f"{path}: duplicate SOF marker")
            frame = _frame(path, seg)
            progressive, arith = SOF_READ[marker]
        elif marker in SOF_NAMES:
            raise NotImplementedError(
                f"{path}: {SOF_NAMES[marker]} JPEG; only baseline, "
                f"extended sequential and progressive JPEGs (Huffman or "
                f"arithmetic-coded) are read")
        elif marker == 0xCC:                                  # DAC
            # jdmarker.c::get_dac (the pairs of a segment that runs past
            # the end read the fake EOI's bytes, whose index is refused)
            if len(seg) % 2:
                raise IOError(f"{path}: bad DAC marker length")
            for index, val in zip(seg[::2], seg[1::2]):
                if index >= 2 * NUM_ARITH_TBLS:
                    raise IOError(f"{path}: bad DAC index {index}")
                if index >= NUM_ARITH_TBLS:
                    ac_k[index - NUM_ARITH_TBLS] = val
                else:
                    dc_l[index], dc_u[index] = val & 15, val >> 4
                    if dc_l[index] > dc_u[index]:
                        raise IOError(f"{path}: bad DAC value {val:#x}")
        elif marker == 0xC4:                                  # DHT
            p = 0
            while len(seg) - p > 16:
                index, bits = seg[p], tuple(seg[p + 1:p + 17])
                count, p = sum(bits), p + 17
                if count > 256 or count > len(seg) - p:
                    raise IOError(f"{path}: bad Huffman table")
                cls, tid = index >> 4, index & 15
                if cls > 1 or tid > 3:
                    raise IOError(f"{path}: bad DHT index {index:#x}")
                slots[(cls, tid)] = (bits, seg[p:p + count])
                p += count
            if p != len(seg):
                raise IOError(f"{path}: bad DHT marker length")
        elif marker == 0xDB:                                  # DQT
            p = 0
            while p < len(seg):
                prec, tid = seg[p] >> 4, seg[p] & 15
                if tid > 3:
                    raise IOError(f"{path}: bad DQT index {tid}")
                size = 128 if prec else 64
                body = seg[p + 1:p + 1 + size]
                if len(body) < size:
                    raise IOError(f"{path}: bad DQT marker length")
                vals = np.frombuffer(body, ">u2" if prec else np.uint8)
                table = np.zeros(64, np.uint16)
                table[NATURAL] = vals
                qtabs[tid] = table
                p += 1 + size
        elif marker == 0xDD:                                  # DRI
            if len(seg) != 2:
                raise IOError(f"{path}: bad DRI marker length")
            (restart,) = struct.unpack(">H", seg)
        elif skipped:           # APPn, COM, DAC, DNL; the color space is
            if scans:           # guessed from APP0 / APP14 before a scan
                continue
            if marker == 0xE0 and len(seg) >= 14 and seg[:5] == b"JFIF\x00":
                jfif = True
            elif marker == 0xEE and len(seg) >= 12 and seg[:5] == b"Adobe":
                adobe, transform = True, seg[11]
        elif marker == 0xDA:                                  # SOS
            if frame is None:
                raise IOError(f"{path}: SOS before SOF")
            comps = frame[2]
            if not scans:
                if len(comps) not in (1, 3):
                    raise NotImplementedError(
                        f"{path}: {len(comps)}-component JPEG (CMYK / "
                        f"YCCK or other); libjpeg gives RGB only for 1 or "
                        f"3 components")
                # jdhuff.c (sequential Huffman files only): jstdhuff.c's
                # tables for slots 0 and 1 that no DHT defined
                for t in (0, 1) if not progressive and not arith else ():
                    slots.setdefault((0, t), (_STD_DC_BITS[t],
                                              _STD_DC_VALS))
                    slots.setdefault((1, t), (_STD_AC_BITS[t],
                                              _STD_AC_VALS[t]))
                # jdphuff.c / jdarith.c: the progression status, and
                # before each component's last scan
                coef_bits = np.full((len(comps), 64), -1, np.int64)
                prev_bits = np.zeros((len(comps), 64), np.int64)
            elif not progressive and scans[0][0] == len(comps):
                raise IOError(f"{path}: a second scan after a single "
                              f"interleaved one (EOI expected)")
            n = seg[0] if seg else 0
            if len(seg) != 4 + 2 * n or not 1 <= n <= 4:
                raise IOError(f"{path}: bad SOS marker length")
            ss, se, ahl = seg[1 + 2 * n:4 + 2 * n]
            ah, al = ahl >> 4, ahl & 15
            if progressive:
                bad = (se != 0 if ss == 0 else (ss > se or se > 63 or n != 1))
                if bad or (ah and al != ah - 1) or al > 13:
                    raise IOError(f"{path}: invalid progressive parameters "
                                  f"Ss={ss} Se={se} Ah={ah} Al={al}")
                need = (ss == 0 and ah == 0, ss > 0)     # DC, AC table
            else:
                ss, se, ah, al = 0, 63, 0, 0
                need = (True, True)
            if arith:                       # no Huffman tables
                need = (False, False)
            scan = np.zeros(SCAN_WORDS, np.int32)
            scan[S_N] = n
            scan[S_SS:S_START + 1] = (ss, se, ah, al, restart, pos)
            scan[S_DC:S_AC + 4] = -1
            scan[S_ARITH] = arith
            ids = [c[0] for c in comps]
            for i in range(n):
                cid, td = seg[1 + 2 * i], seg[2 + 2 * i]
                ci = next((k for k, c in enumerate(ids)
                           if c == cid and k not in scan[S_COMPS:S_COMPS + i]),
                          None)
                if ci is None:
                    raise IOError(f"{path}: bad component ID {cid} in SOS")
                scan[S_COMPS + i] = ci
                # the arithmetic conditioning, as the scan's start takes
                # it from the DAC markers read so far (jdarith.c)
                dct, act = td >> 4, td & 15
                o = S_COND + COND_WORDS * i
                scan[o:o + COND_WORDS] = (dct, act, dc_l[dct], dc_u[dct],
                                          ac_k[act])
                for cls, tid in ((0, dct), (1, act)):
                    if not need[cls]:
                        continue
                    if (cls, tid) not in slots:
                        raise IOError(f"{path}: Huffman table {tid} not "
                                      f"defined")
                    bits, vals = slots[(cls, tid)]
                    tables.append(_huff_table(path, bits, vals, cls == 0))
                    scan[(S_DC, S_AC)[cls] + i] = len(tables) - 1
                if ci not in latched:                 # latch_quant_tables
                    tq = comps[ci][3]
                    if tq not in qtabs:
                        raise IOError(f"{path}: quantization table {tq} "
                                      f"not defined")
                    latched[ci] = qtabs[tq].copy()
                if progressive:
                    lo, hi = min(ss, 1), max(se, 9) + 1
                    prev_bits[ci, lo:hi] = coef_bits[ci, lo:hi] \
                        if scans else 0
                    coef_bits[ci, ss:se + 1] = al
            blocks = sum(comps[ci][1] * comps[ci][2]
                         for ci in scan[S_COMPS:S_COMPS + n])
            if n > 1 and blocks > MAX_BLOCKS_IN_MCU:
                raise IOError(f"{path}: sampling factors too large for an "
                              f"interleaved MCU")
            scans.append(scan)
            in_data = True
            # the entropy-coded data runs to the next marker that is not a
            # restart marker, where the marker loop goes on
        else:
            raise IOError(f"{path}: unsupported JPEG marker {marker:#04x}")
    if frame is None or not scans:
        raise IOError(f"{path}: no image in the JPEG file")
    h, w, comps = frame
    hmax = max(c[1] for c in comps)
    vmax = max(c[2] for c in comps)
    for _, hs, vs, _ in comps:
        if hmax % hs or vmax % vs:
            raise NotImplementedError(
                f"{path}: fractional sampling ratio ({hmax}x{vmax} over "
                f"{hs}x{vs}); libjpeg does not upsample it")
    if len(comps) == 1:
        color = COLOR_GRAY
    elif jfif:
        color = COLOR_YCC
    elif adobe:
        color = COLOR_RGB if transform == 0 else COLOR_YCC
    else:
        color = COLOR_RGB if [c[0] for c in comps] == [82, 71, 66] \
            else COLOR_YCC
    desc = np.zeros(D_SCANS + SCAN_WORDS * len(scans), np.int32)
    desc[:D_PROGRESSIVE + 1] = (w, h, len(comps), color, len(scans), hmax,
                                vmax, progressive)
    for i, (_, hs, vs, _) in enumerate(comps):
        desc[D_COMPS + 2 * i:D_COMPS + 2 * i + 2] = (hs, vs)
    if progressive and _smoothing(latched, coef_bits, len(comps)):
        # smoothing_ok's latches: the prior ones read -1 after one scan
        desc[D_SMOOTH] = 1
        for ci in range(len(comps)):
            o = D_LATCH + LATCH_WORDS * ci
            desc[o:o + 10] = coef_bits[ci, :10]
            desc[o + 10:o + 20] = prev_bits[ci, :10] if len(scans) > 1 \
                else -1
    desc[D_SCANS:] = np.concatenate(scans)
    qt = np.zeros((len(comps), 64), np.int16)     # 0: a component no scan
    for ci, table in latched.items():             # carried (gray output)
        qt[ci] = table.view(np.int16)             # ISLOW_MULT_TYPE is short
    huff = np.stack(tables) if tables else np.zeros((1, 16 + 256), np.int32)
    return Jpeg(path, w, h, np.frombuffer(buf, np.uint8), desc, qt, huff)


def _smoothing(latched, coef_bits, n_comps) -> bool:
    """Whether libjpeg-turbo would decode the progressive file with block
    smoothing (jdcoefct.c::smoothing_ok): every component latched, with
    nonzero quantizers where smoothing divides and its DC known, and some
    of AC coefficients 1-9 of some component not fully refined."""
    useful = False
    for ci in range(n_comps):
        if ci not in latched or not latched[ci][list(SMOOTH_Q)].all():
            return False
        if coef_bits[ci, 0] < 0:
            return False
        useful = useful or bool((coef_bits[ci, 1:10] != 0).any())
    return useful


def decode_into(jpegs: List[Jpeg], dst: List[np.ndarray],
                n_threads: int) -> None:
    """Decode `jpegs` (loader.cpp, one image per thread) into the float32
    [H, W, C] arrays `dst` (C 3, or 4 with an alpha of 1)."""
    from . import get_lib

    ptrs = ctypes.c_void_p * len(jpegs)
    channels = dst[0].shape[-1]
    rc = get_lib().fsnerf_jpeg_decode(
        len(jpegs), ptrs(*[j.data.ctypes.data for j in jpegs]),
        (ctypes.c_int64 * len(jpegs))(*[j.data.size for j in jpegs]),
        ptrs(*[j.desc.ctypes.data for j in jpegs]),
        ptrs(*[j.qt.ctypes.data for j in jpegs]),
        ptrs(*[j.huff.ctypes.data for j in jpegs]),
        ptrs(*[d.ctypes.data for d in dst]), channels, n_threads)
    if rc:
        raise IOError(f"{jpegs[rc - 1].path}: corrupt JPEG data")
