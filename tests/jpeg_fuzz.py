"""Corrupt JPEGs through both decoders: fsnerf_tpu's libjpeg-turbo one and
the port's.

    python tests/jpeg_fuzz.py [N] [--anywhere]
    JSIMD_FORCENONE=1 python tests/jpeg_fuzz.py [N] [--anywhere]

Writes N small PIL JPEGs (random sizes, qualities, subsampling,
progressive or not, restart intervals; seeded) with 1-3 bytes overwritten
at random in the entropy-coded data (--anywhere: after the SOI marker),
decodes each with both and prints the counts: pixels equal, pixels
different, both refusing, only the JAX decoder reading, only the port
reading. With JSIMD_FORCENONE=1 libjpeg-turbo runs its C IDCT, which the
port mirrors; its SIMD IDCT treats the overflowing coefficients of corrupt
data otherwise.
"""

import argparse
import io
import os
import sys
import tempfile

import numpy as np
from PIL import Image

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from fsnerf_tpu.native import decode_images as jax_decode  # noqa: E402
from fsnerf_tpu_torch.native import decode_images  # noqa: E402


def corrupt_jpegs(n, anywhere=False):
    """n seeded corrupt JPEGs (bytes): small PIL JPEGs (random sizes,
    qualities, subsampling, progressive or not, restart intervals) with
    1-3 bytes overwritten at random in the entropy-coded data (anywhere:
    after the SOI marker)."""
    rng = np.random.default_rng(0)
    for _ in range(n):
        h, w = rng.integers(8, 60, 2)
        buf = io.BytesIO()
        prog = bool(rng.integers(0, 2))
        Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8)).save(
            buf, "JPEG", quality=int(rng.integers(30, 96)),
            subsampling=int(rng.integers(0, 3)), progressive=prog,
            restart_marker_blocks=int(rng.integers(0, 3)))
        raw = bytearray(buf.getvalue())
        sos = raw.find(b"\xff\xda") if prog else raw.rfind(b"\xff\xda")
        lo = 2 if anywhere else sos + 14
        for _ in range(int(rng.integers(1, 4))):
            raw[int(rng.integers(lo, len(raw) - 2))] = int(
                rng.integers(0, 256))
        yield bytes(raw)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("n", type=int, nargs="?", default=300)
    ap.add_argument("--anywhere", action="store_true")
    args = ap.parse_args()
    counts = dict(equal=0, different=0, both_refuse=0, jax_only=0,
                  port_only=0)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "c.jpg")
        for raw in corrupt_jpegs(args.n, args.anywhere):
            with open(path, "wb") as fh:
                fh.write(raw)
            try:
                want = jax_decode([path])
            except IOError:
                want = None
            try:
                got = decode_images([path])
            except (IOError, NotImplementedError):
                got = None
            if want is None:
                counts["both_refuse" if got is None else "port_only"] += 1
            elif got is None:
                counts["jax_only"] += 1
            else:
                counts["equal" if np.array_equal(got, want)
                       else "different"] += 1
    print(counts)


if __name__ == "__main__":
    main()
