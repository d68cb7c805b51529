"""Time the streamed kernels at a width with one persistent CTA per SM (what
ops/kernels/render.py::stream_scratch launches) against the CTA count
that keeps the streamed trunk's scratch (64 rows x 2 W bf16 a CTA) at
width 1024's size on the card (SMs x 1024 / W CTAs, 34.6 MB on 132 SMs),
in turns (all, capped, capped, all), on the card:
  kernel 1 (the NeRF march) on 16,384 rays x K 192 (every chunk step
    executed), kernel 3 at 393,216 rows, kernel 4 at 131,072, kernel 5
    with and without its saved activations at 196,608, kernel 7 with and
    without them at 196,608 and kernel 2 (the SIREN march) on kernel 1's
    inputs, seeded 8-layer NeRF (skip 4, n_freqs 10/4) and SiNeRF weights.

    python -m tools.stream_ctas [--widths 1536,2048]

Prints one JSON line per width and CTA count (CUDA-event ms of each
kernel, the card's name and power limit) and a line of the capped runs'
mean over the full ones' per kernel. The capped count is set by replacing
stream_scratch in the wrapper modules for those runs (the kernels launch
min(row tiles, the scratch's slots) CTAs). Refuses to run without CUDA.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys

import torch


def _ms(fn, reps: int) -> float:
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _scratch_with(ctas_of):
    """A stream_scratch that gives a streamed width ctas_of(width) slots."""
    from fsnerf_tpu_torch.ops.kernels import render as kr

    def scratch(width, device):
        if not kr.stream_width(width):
            return None, 0
        ctas = ctas_of(width)
        return torch.empty((ctas * kr.STREAM_ROWS, 2 * width),
                           dtype=torch.bfloat16, device=device), ctas

    return scratch


def measure(width: int, dev) -> dict:
    """{"all" | "capped": [{kernel: ms}, ...]} at `width`, in turns."""
    from fsnerf_tpu_torch.config import Config
    from fsnerf_tpu_torch.core.encoding import positional_encoding
    from fsnerf_tpu_torch.core.models import make_model
    from fsnerf_tpu_torch.ops.kernels import mlp as km
    from fsnerf_tpu_torch.ops.kernels import mlp_train as mt
    from fsnerf_tpu_torch.ops.kernels import render as kr
    from fsnerf_tpu_torch.ops.kernels import siren as ks

    cfg = Config()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, d_filter=width))
    scfg = cfg.replace(model=dataclasses.replace(cfg.model, model="sinerf"))
    model = make_model(cfg, torch.bfloat16,
                       torch.Generator().manual_seed(7), dev)
    smodel = make_model(scfg, torch.bfloat16,
                        torch.Generator().manual_seed(9), dev)
    sd = model.state_dict()
    g = torch.Generator(device=dev).manual_seed(5)
    R, K = 16_384, 192
    o = torch.nn.functional.normalize(
        torch.randn((R, 3), generator=g, device=dev), dim=-1) * 4.0
    rd = torch.nn.functional.normalize(
        -o + 0.3 * torch.randn((R, 3), generator=g, device=dev), dim=-1)
    t = torch.linspace(2.0, 6.0, K, device=dev).expand(R, K).contiguous()
    x = (o[:, None, :] + t[..., None] * rd[:, None, :]).contiguous()
    padded, bR, cs = kr.pad_for_march(
        x, rd, t, torch.full((R, K), 4.0 / K, device=dev),
        torch.ones((R, K), device=dev))
    n = 196_608
    xs = torch.rand((n, 3), generator=g, device=dev) * 3.0 - 1.5
    ds = torch.nn.functional.normalize(
        torch.randn((n, 3), generator=g, device=dev), dim=-1)
    rp = kr.prep_params(sd, 8, (4,), 10, 4, device=dev)
    p = km.prep_params(sd, 8, (4,), dev)
    xm = torch.rand((393_216, 3), generator=g, device=dev) * 3.0 - 1.5
    dm = torch.nn.functional.normalize(
        torch.randn((393_216, 3), generator=g, device=dev), dim=-1)
    ex = km.pad_features(positional_encoding(xm, 10, True), p.d_enc_pad)
    ed = km.pad_features(positional_encoding(dm, 4, True), p.d_dir_pad)
    exd = ex[:131_072].contiguous()
    lay = mt.TrainLayout.from_config(cfg)
    tp = mt.pack_train_params(sd, lay, kr.enc_table(10, 4, device=dev))
    sp = ks.prep_siren_params(smodel.state_dict(), 8, device=dev)
    xp, dp = ks.pad_inputs(xs), ks.pad_inputs(ds)
    kernels = {
        "march": (lambda: kr.ray_march(*padded, rp, bR, cs), 2),
        "mlp": (lambda: km.nerf_mlp(ex, ed, p), 3),
        "density": (lambda: km.nerf_density(exd, p), 3),
        "train_fwd": (lambda: mt.mlp_train_fwd(xs, ds, tp, True), 3),
        "train_fwd_noacts": (lambda: mt.mlp_train_fwd(xs, ds, tp), 3),
        "siren_fwd": (lambda: ks.siren_mlp_fwd(xp, dp, sp, True), 3),
        "siren_fwd_noacts": (lambda: ks.siren_mlp_fwd(xp, dp, sp), 3),
        "siren_march": (lambda: kr.siren_ray_march(*padded, sp, bR, cs), 1)}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    counts = {"all": lambda w: sms,
              "capped": lambda w: max(1, sms * 1024 // w)}
    modules = (kr, km, mt, ks)
    original = kr.stream_scratch
    res = {"all": [], "capped": []}
    try:
        for turn in ("all", "capped", "capped", "all"):
            for m in modules:
                m.stream_scratch = _scratch_with(counts[turn])
            res[turn].append({k: _ms(fn, reps)
                              for k, (fn, reps) in kernels.items()})
    finally:
        for m in modules:
            m.stream_scratch = original
    res["ctas"] = {k: f(width) for k, f in counts.items()}
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--widths", default="1536,2048")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("stream_ctas: needs CUDA (it times the card's kernels)",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from fsnerf_tpu_torch.ops.kernels import build

    build.load_library()
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    for w in (int(v) for v in args.widths.split(",")):
        res = measure(w, dev)
        for turn in ("all", "capped"):
            print(json.dumps({"width": w, "ctas": res["ctas"][turn],
                              "card": card, "runs": res[turn]}), flush=True)
        mean = {t: {k: sum(r[k] for r in res[t]) / len(res[t])
                    for k in res[t][0]} for t in ("all", "capped")}
        print(json.dumps({"width": w, "card": card, "capped_over_all": {
            k: mean["capped"][k] / mean["all"][k] for k in mean["all"]}}),
            flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
