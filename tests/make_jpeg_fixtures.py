"""Write the JPEG fixtures of tests/data/jpeg/ and their pixels.

    python tests/make_jpeg_fixtures.py

Each fixture is a small JPEG of one mode the port's decoder reads
(progressive, 4:2:0 with restart markers, gray, 4:2:2, 4:4:0 from
tests/torch_jpeg_writer.py, an RGB JPEG), most with a width and a height
that no MCU divides. pixels.npz holds, under each file's name, the uint8
pixels fsnerf_tpu's libjpeg decoder gives: the port must decode each file
to exactly those values times 1/255 in float32 (tests/test_torch_jpeg.py
on the CPU, tests/test_torch_cuda.py and chip_smoke.py on the card's
machine, which has no libjpeg).
"""

import os
import sys

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

from fsnerf_tpu.native import decode_images  # noqa: E402
from torch_jpeg_writer import write_jpeg  # noqa: E402

OUT = os.path.join(HERE, "data", "jpeg")


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
    pixels = {}
    for name in sorted(os.listdir(OUT)):
        if name.endswith(".jpg"):
            f = decode_images([os.path.join(OUT, name)])[0]
            pixels[name] = np.round(f * 255).astype(np.uint8)
    np.savez_compressed(os.path.join(OUT, "pixels.npz"), **pixels)
    print({k: v.shape for k, v in pixels.items()})


if __name__ == "__main__":
    main()
