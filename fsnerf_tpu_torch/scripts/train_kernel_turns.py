"""Time the NeRF MLP kernels of two source trees in turns on one card,
NeRF 8x256 with seeded weights:
  train: kernel 5 (the train forward, with and without its saved
    activations, and the wrapper's host time per call) and kernel 6 (the
    backward, saved and recompute mode) at the main path's 196,608 rows
    (1,024 rays x K 192), as `chip_smoke.py` phase 5 builds them;
  density: kernel 4 (the density pass) at one `og.update` chunk of
    262,144 rows and at all 2,097,152 cells of a res-128 grid, its host
    time per call, and one all-cell and one quarter grid refresh through
    it, as `chip_smoke.py` phase 14 runs them;
  march: kernel 1 (the NeRF ray march) at 16,384 rays x K 192 (block 16 x
    chunk 8; prefix masks with sorted valid counts, as after the
    depth-coherence sort), normal and with a saturating sigma bias (+5000:
    blocks exit early), and its host time per call.

    python -m fsnerf_tpu_torch.scripts.train_kernel_turns \\
        --trees build/parent,. [--blocks 3] [--rows 196608] \\
        [--groups train,density,march]

Each measurement is a process of its own that imports `fsnerf_tpu_torch`
from one tree (its kernels built there), in the order A, B, B, A per
block, so two versions are compared on one card in one call. Prints one
JSON line per run (CUDA-event ms, host ms, the card's name and power
limit), then the mean of each tree over its runs. Refuses to run without
CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

_KEYS = {"train": ("fwd_ms", "fwd_nosave_ms", "fwd_host_ms", "bwd_ms",
                   "bwd_recompute_ms"),
         "density": ("density_ms", "density_all_ms", "density_host_ms",
                     "refresh_all_ms", "refresh_quarter_ms"),
         "march": ("march_ms", "march_exit_ms", "march_host_ms")}


def _ms(fn, reps: int) -> float:
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _host_ms(fn, reps: int) -> float:
    """Host ms per call, from the first call's start to the last one's
    return, before the card is waited for."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return host


def measure(groups, rows: int, reps: int) -> dict:
    """The numbers of one run, from the `fsnerf_tpu_torch` on sys.path."""
    from fsnerf_tpu_torch.ops.kernels import build

    build.load_library()
    res = {}
    for group in groups:
        res.update({"train": measure_train, "density": measure_density,
                    "march": measure_march}[group](rows, reps))
    return res


def measure_train(rows: int, reps: int) -> dict:
    import torch

    from fsnerf_tpu_torch.config import Config
    from fsnerf_tpu_torch.core.models import make_model
    from fsnerf_tpu_torch.ops.kernels import mlp_train as mt
    from fsnerf_tpu_torch.ops.kernels import render as kr

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = Config()
    lay = mt.TrainLayout.from_config(cfg)
    model = make_model(cfg, torch.bfloat16,
                       torch.Generator().manual_seed(3), dev)
    params = mt.pack_train_params(
        model.state_dict(), lay,
        kr.enc_table(lay.n_freqs, lay.n_freqs_views, device=dev))
    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.rand((rows, 3), generator=g, device=dev) * 3.0 - 1.5
    d = torch.nn.functional.normalize(
        torch.randn((rows, 3), generator=g, device=dev), dim=-1)
    out, acts = mt.mlp_train_fwd(x, d, params, True)
    ref, _ = mt.mlp_train_fwd_reference(x, d, params)
    target = torch.rand((rows, 4), generator=g, device=dev)
    dout = (2.0 * (ref - target) / ref.numel()).contiguous()
    res = {"rgb_err": float((out[:, :3] - ref[:, :3]).abs().max()),
           "sigma_err": float((out[:, 3] - ref[:, 3]).abs().max())}
    res["fwd_ms"] = _ms(lambda: mt.mlp_train_fwd(x, d, params, True), reps)
    res["fwd_nosave_ms"] = _ms(lambda: mt.mlp_train_fwd(x, d, params),
                               reps)
    res["fwd_host_ms"] = _host_ms(lambda: mt.mlp_train_fwd(x, d, params,
                                                           True), reps)
    res["bwd_ms"] = _ms(lambda: mt.mlp_train_bwd(x, d, dout, params, acts),
                        reps)
    res["bwd_recompute_ms"] = _ms(
        lambda: mt.mlp_train_bwd(x, d, dout, params, None), reps)
    return res


def measure_density(rows: int, reps: int) -> dict:
    import numpy as np
    import torch

    from fsnerf_tpu_torch.config import Config
    from fsnerf_tpu_torch.core.encoding import freq_mask, positional_encoding
    from fsnerf_tpu_torch.core.models import make_model
    from fsnerf_tpu_torch.ops import occgrid as og
    from fsnerf_tpu_torch.ops.kernels import mlp as km
    from fsnerf_tpu_torch.train.step import make_density_fn

    dev = torch.device("cuda")
    cfg = Config()
    s = cfg.sampling
    model = make_model(cfg, torch.bfloat16,
                       torch.Generator().manual_seed(6), dev)
    grid = og.create(np.array([-1.5] * 3 + [1.5] * 3, np.float32),
                     s.grid_resolution, device=dev)
    n, k = grid.n_cells, grid.n_cells // s.update_parts
    pm = freq_mask(cfg.encoder.n_freqs, 400, 750, dev)   # mid-anneal
    g = torch.Generator(device=dev).manual_seed(7)
    x = og._cell_positions(torch.arange(n, device=dev), grid.base_aabb,
                           grid.resolution)
    params = km.prep_params(model.state_dict(), cfg.model.n_layers,
                            cfg.model.skip)
    with torch.no_grad():
        encx = km.pad_features(positional_encoding(x, cfg.encoder.n_freqs,
                                                   True, pm),
                               params.d_enc_pad)
    chunk = encx[:og._EVAL_CHUNK]
    got = km.nerf_density(encx, params)
    ref = km.nerf_density_reference(encx, params)
    res = {"density_rows": chunk.shape[0],
           "density_err": float((got - ref).abs().max()),
           "density_ms": _ms(lambda: km.nerf_density(chunk, params), reps),
           "density_all_ms": _ms(lambda: km.nerf_density(encx, params),
                                 max(reps // 5, 3)),
           "density_host_ms": _host_ms(
               lambda: km.nerf_density(chunk, params), reps)}
    jit_all = [torch.rand((n, 3), generator=g, device=dev)]
    jit_part = [torch.rand((k, 3), generator=g, device=dev)]
    with torch.no_grad():
        for kind, step, jit in (("all", 0, jit_all),
                                ("quarter", s.warmup_steps, jit_part)):
            def refresh():
                return og.update(
                    grid, make_density_fn(model, cfg, pm, dev), step,
                    render_step_size=s.render_step_size,
                    occ_thre=s.occ_thre, ema_decay=s.ema_decay,
                    warmup_steps=s.warmup_steps,
                    update_parts=s.update_parts,
                    update_interval=s.update_interval, jitter=jit)

            res[f"refresh_{kind}_ms"] = _ms(refresh, 5)
    return res


def measure_march(rows: int, reps: int) -> dict:
    import math

    import torch

    from fsnerf_tpu_torch.config import Config
    from fsnerf_tpu_torch.core.models import make_model
    from fsnerf_tpu_torch.ops.kernels import render as kr

    dev = torch.device("cuda")
    cfg = Config()
    R, K, bR, cs = 16_384, 192, 16, 8
    model = make_model(cfg, torch.bfloat16,
                       torch.Generator().manual_seed(0), dev)
    g = torch.Generator(device=dev).manual_seed(8)
    x = torch.rand((R, K, 3), generator=g, device=dev) * 3.0 - 1.5
    dirs = torch.nn.functional.normalize(
        torch.randn((R, 3), generator=g, device=dev), dim=-1)
    t = torch.sort(torch.rand((R, K), generator=g, device=dev) * 4.0 + 2.0,
                   dim=-1).values
    deltas = torch.full((R, K), 5e-3 * math.sqrt(3.0), device=dev)
    n_valid = torch.sort(torch.randint(0, K + 1, (R,), generator=g,
                                       device=dev)).values
    mask = (torch.arange(K, device=dev)[None, :]
            < n_valid[:, None]).to(torch.float32)
    sd = model.state_dict()
    arch = dict(n_layers=cfg.model.n_layers, skip=cfg.model.skip,
                n_freqs=cfg.encoder.n_freqs,
                n_freqs_views=cfg.encoder.n_freqs_views, device=dev)
    res = {}
    for key, bias in (("march", 0.0), ("march_exit", 5000.0)):
        params = kr.prep_params(
            dict(sd, **{"sigma.bias": sd["sigma.bias"] + bias}), **arch)

        def march():
            return kr.ray_march(x, dirs, t, deltas, mask, params, bR, cs)

        stats, steps = march()
        sl = slice(R // 2, R // 2 + 256)      # mid-length rays
        ref, _ = kr.ray_march_reference(x[sl], dirs[sl], t[sl], deltas[sl],
                                        mask[sl], params, bR, cs)
        res[f"{key}_err"] = float((stats[sl, :5] - ref[:, :5]).abs().max())
        res[f"{key}_steps"] = int(steps.sum())
        res[f"{key}_ms"] = _ms(march, max(reps // 5, 3))
        if key == "march":
            res["march_host_ms"] = _host_ms(march, max(reps // 5, 3))
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", default="build/parent,.",
                    help="two source trees A,B (roots holding "
                         "fsnerf_tpu_torch/)")
    ap.add_argument("--blocks", type=int, default=3)
    ap.add_argument("--rows", type=int, default=1024 * 192)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--groups", default="train,density,march",
                    help="which kernels to time: any of train, density, "
                         "march")
    ap.add_argument("--worker", action="store_true",
                    help="measure the tree on PYTHONPATH once (internal)")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("train_kernel_turns needs an NVIDIA GPU")
    groups = args.groups.split(",")
    if any(g not in _KEYS for g in groups):
        raise SystemExit(f"--groups takes {', '.join(_KEYS)}")
    if args.worker:
        print(json.dumps(measure(groups, args.rows, args.reps)))
        return
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    trees = [os.path.abspath(t) for t in args.trees.split(",")]
    if len(trees) != 2:
        raise SystemExit("--trees wants two trees A,B")
    runs = {t: [] for t in trees}
    for block in range(args.blocks):
        for tree in (trees[0], trees[1], trees[1], trees[0]):
            env = dict(os.environ, PYTHONPATH=tree)
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--worker",
                 "--rows", str(args.rows), "--reps", str(args.reps),
                 "--groups", args.groups],
                env=env, capture_output=True, text=True, cwd=tree)
            if proc.returncode:
                raise SystemExit(f"worker in {tree} failed:\n{proc.stdout}"
                                 f"\n{proc.stderr}")
            res = json.loads(proc.stdout.strip().splitlines()[-1])
            runs[tree].append(res)
            print(json.dumps(dict(tree=tree, block=block, card=card,
                                  rows=args.rows, **res)), flush=True)
    for tree, rs in runs.items():
        print(json.dumps(dict(tree=tree, card=card, runs=len(rs), **{
            f"mean_{k}": sum(r[k] for r in rs) / len(rs)
            for g in groups for k in _KEYS[g]})))


if __name__ == "__main__":
    main()
