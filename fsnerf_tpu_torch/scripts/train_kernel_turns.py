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
    blocks exit early), and its host time per call;
  mlp: kernel 3 (the forward MLP on encoded rows) at 1,048,576 rows (the
    hierarchical eval's coarse pass, `chip_smoke.py` phase 7) and at
    393,216 (one validation chunk: 2,048 rays x K 192), and its host time
    per call;
  siren: kernel 7 (the SiNeRF forward, with and without its saved
    activations, and the wrapper's host time per call; its rgb and its
    acts stream's h_i and factors against the plain version's, the largest
    difference and the share of elements that differ) and kernel 8 (the
    SiNeRF backward) at the main path's 196,608 rows, kernel 8 in saved
    mode whole and split into its three launches (row pass, dW pass,
    reduce; from a torch.profiler trace), its host time per call, and
    recompute mode;
  siren_march: kernel 2 (the SIREN ray march) on kernel 1's inputs, SiNeRF
    8x256, normal and with a saturating sigma bias, and its host time per
    call;
  eval: seconds per 800x800 validation view (`cli.render_val_view`:
    seeded weights, a res-128 grid rebuilt from them, chunks of 2,048 rays,
    the eval model_fn) for NeRF 8x256 (kernel 3 once per chunk, 313
    launches) and SiNeRF 8x256 (kernel 7 without acts, 313 launches), and
    the host time per call of both wrappers at one chunk's 393,216 rows.

    python -m fsnerf_tpu_torch.scripts.train_kernel_turns \\
        --trees build/parent,. [--blocks 3] [--rows 196608] \\
        [--groups train,density,march,mlp,siren,siren_march,eval]

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
         "march": ("march_ms", "march_exit_ms", "march_host_ms"),
         "mlp": ("mlp_ms", "mlp_chunk_ms", "mlp_host_ms"),
         "siren": ("siren_fwd_ms", "siren_fwd_nosave_ms",
                   "siren_fwd_host_ms", "siren_bwd_ms", "siren_rows_ms",
                   "siren_dw_ms", "siren_reduce_ms", "siren_bwd_host_ms",
                   "siren_bwd_recompute_ms"),
         "siren_march": ("siren_march_ms", "siren_march_exit_ms",
                         "siren_march_host_ms"),
         "eval": ("val_view_s", "siren_val_view_s", "mlp_chunk_host_ms",
                  "siren_nosave_host_ms")}


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
                    "march": measure_march, "mlp": measure_mlp,
                    "siren": measure_siren,
                    "siren_march": measure_siren_march,
                    "eval": measure_eval}[group](rows, reps))
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


def _march_inputs(dev):
    """16,384 rays x K 192 (block 16 x chunk 8): points in the scene box,
    sorted t, prefix masks with sorted valid counts."""
    import math

    import torch

    R, K = 16_384, 192
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
    return x, dirs, t, deltas, mask


def _time_march(prefix, march, reference, inputs, params_of, reps):
    """A march's numbers under the keys prefix_*: normal and with a
    saturating sigma bias (+5000), errors against the plain version on 256
    mid-length rays, executed steps, CUDA-event and host ms."""
    bR, cs = 16, 8
    R = inputs[0].shape[0]
    res = {}
    for key, bias in ((prefix, 0.0), (f"{prefix}_exit", 5000.0)):
        params = params_of(bias)

        def run():
            return march(*inputs, params, bR, cs)

        stats, steps = run()
        sl = slice(R // 2, R // 2 + 256)      # mid-length rays
        ref, _ = reference(*(a[sl] for a in inputs), params, bR, cs)
        res[f"{key}_err"] = float((stats[sl, :5] - ref[:, :5]).abs().max())
        res[f"{key}_steps"] = int(steps.sum())
        res[f"{key}_ms"] = _ms(run, max(reps // 5, 3))
        if key == prefix:
            res[f"{prefix}_host_ms"] = _host_ms(run, max(reps // 5, 3))
    return res


def measure_march(rows: int, reps: int) -> dict:
    import torch

    from fsnerf_tpu_torch.config import Config
    from fsnerf_tpu_torch.core.models import make_model
    from fsnerf_tpu_torch.ops.kernels import render as kr

    dev = torch.device("cuda")
    cfg = Config()
    model = make_model(cfg, torch.bfloat16,
                       torch.Generator().manual_seed(0), dev)
    sd = model.state_dict()
    arch = dict(n_layers=cfg.model.n_layers, skip=cfg.model.skip,
                n_freqs=cfg.encoder.n_freqs,
                n_freqs_views=cfg.encoder.n_freqs_views, device=dev)
    return _time_march(
        "march", kr.ray_march, kr.ray_march_reference, _march_inputs(dev),
        lambda bias: kr.prep_params(
            dict(sd, **{"sigma.bias": sd["sigma.bias"] + bias}), **arch),
        reps)


def measure_siren_march(rows: int, reps: int) -> dict:
    import dataclasses

    import torch

    from fsnerf_tpu_torch.config import Config
    from fsnerf_tpu_torch.core.models import make_model
    from fsnerf_tpu_torch.ops.kernels import render as kr
    from fsnerf_tpu_torch.ops.kernels import siren as ks

    dev = torch.device("cuda")
    cfg = Config()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, model="sinerf"))
    model = make_model(cfg, torch.bfloat16,
                       torch.Generator().manual_seed(0), dev)
    sd = model.state_dict()
    key = "sigma_layers.1.bias"
    return _time_march(
        "siren_march", kr.siren_ray_march, kr.siren_ray_march_reference,
        _march_inputs(dev),
        lambda bias: ks.prep_siren_params(dict(sd, **{key: sd[key] + bias}),
                                          cfg.model.n_layers, device=dev),
        reps)


def measure_mlp(rows: int, reps: int) -> dict:
    import torch

    from fsnerf_tpu_torch.config import Config
    from fsnerf_tpu_torch.core.encoding import positional_encoding
    from fsnerf_tpu_torch.core.models import make_model
    from fsnerf_tpu_torch.ops.kernels import mlp as km

    dev = torch.device("cuda")
    cfg = Config()
    model = make_model(cfg, torch.bfloat16,
                       torch.Generator().manual_seed(5), dev)
    params = km.prep_params(model.state_dict(), cfg.model.n_layers,
                            cfg.model.skip, dev)
    n = 1 << 20
    g = torch.Generator(device=dev).manual_seed(9)
    x = torch.rand((n, 3), generator=g, device=dev) * 3.0 - 1.5
    d = torch.nn.functional.normalize(
        torch.randn((n, 3), generator=g, device=dev), dim=-1)
    with torch.no_grad():
        encx = km.pad_features(positional_encoding(x, cfg.encoder.n_freqs),
                               params.d_enc_pad)
        encd = km.pad_features(
            positional_encoding(d, cfg.encoder.n_freqs_views),
            params.d_dir_pad)
    chunk = 2048 * 192
    ex, ed = encx[:chunk], encd[:chunk]
    got = km.nerf_mlp(ex, ed, params)
    ref = km.nerf_mlp_reference(ex, ed, params)
    return {"mlp_rgb_err": float((got[:, :3] - ref[:, :3]).abs().max()),
            "mlp_sigma_err": float((got[:, 3] - ref[:, 3]).abs().max()),
            "mlp_ms": _ms(lambda: km.nerf_mlp(encx, encd, params),
                          max(reps // 5, 3)),
            "mlp_chunk_ms": _ms(lambda: km.nerf_mlp(ex, ed, params), reps),
            "mlp_host_ms": _host_ms(lambda: km.nerf_mlp(ex, ed, params),
                                    reps)}


def measure_eval(rows: int, reps: int) -> dict:
    """Seconds per 800x800 validation view through each model's eval
    model_fn, and the two forward wrappers' host ms per call."""
    import dataclasses

    import torch

    from fsnerf_tpu_torch import cli
    from fsnerf_tpu_torch.config import Config
    from fsnerf_tpu_torch.core.models import make_model
    from fsnerf_tpu_torch.ops.kernels import mlp as km
    from fsnerf_tpu_torch.ops.kernels import siren as ks

    dev = torch.device("cuda")
    split = cli.build_split("sphere", 1, 800, True, seed=1)
    res = {}
    for name in ("nerf", "sinerf"):
        cfg = Config()
        cfg = cfg.replace(model=dataclasses.replace(cfg.model, model=name))
        model = make_model(cfg, torch.bfloat16,
                           torch.Generator().manual_seed(5), dev)
        grid = cli.rebuild_grid(model, cfg, split.aabb, dev)

        def view():
            return cli.render_val_view(model, cfg, grid, split, 0, dev)

        view()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            view()
        torch.cuda.synchronize()
        key = "val_view_s" if name == "nerf" else "siren_val_view_s"
        res[key] = (time.perf_counter() - t0) / 3
    model = make_model(Config(), torch.bfloat16,
                       torch.Generator().manual_seed(5), dev)
    params = km.prep_params(model.state_dict(), 8, (4,), dev)
    n = 2048 * 192
    ex = torch.zeros((n, params.d_enc_pad), dtype=torch.bfloat16, device=dev)
    ed = torch.zeros((n, params.d_dir_pad), dtype=torch.bfloat16, device=dev)
    res["mlp_chunk_host_ms"] = _host_ms(lambda: km.nerf_mlp(ex, ed, params),
                                        reps)
    scfg = Config()
    scfg = scfg.replace(model=dataclasses.replace(scfg.model,
                                                  model="sinerf"))
    smodel = make_model(scfg, torch.bfloat16,
                        torch.Generator().manual_seed(5), dev)
    sparams = ks.prep_siren_params(smodel.state_dict(), 8, device=dev)
    x = torch.zeros((n, ks.D_IN_PAD), dtype=torch.bfloat16, device=dev)
    res["siren_nosave_host_ms"] = _host_ms(
        lambda: ks.siren_mlp_fwd(x, x, sparams), reps)
    return res


def _split_ms(fn, names, calls: int) -> dict:
    """Device ms per call of fn in each of the kernels whose name starts
    with one of `names` (each launched once per call): the mean of the
    kernel events of a torch.profiler trace over `calls` calls."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    durs = {name: [] for name in names}
    for e in events:
        if e.get("cat") != "kernel" or "dur" not in e:
            continue
        for name in names:
            if name in e["name"]:
                durs[name].append(e["dur"] / 1e3)
                break
    return {name: sum(d) / len(d) if d else float("nan")
            for name, d in durs.items()}


def measure_siren(rows: int, reps: int) -> dict:
    import dataclasses

    import torch

    from fsnerf_tpu_torch.config import Config
    from fsnerf_tpu_torch.core.models import make_model
    from fsnerf_tpu_torch.ops.kernels import siren as ks

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = Config()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, model="sinerf"))
    model = make_model(cfg, torch.bfloat16,
                       torch.Generator().manual_seed(10), dev)
    params = ks.prep_siren_params(model.state_dict(), cfg.model.n_layers,
                                  with_transposed=True, device=dev)
    g = torch.Generator(device=dev).manual_seed(11)
    x = ks.pad_inputs(torch.rand((rows, 3), generator=g, device=dev) * 3.0
                      - 1.5)
    d = ks.pad_inputs(torch.nn.functional.normalize(
        torch.randn((rows, 3), generator=g, device=dev), dim=-1))
    out, acts = ks.siren_mlp_fwd(x, d, params, save_acts=True)
    ref, ref_acts = ks.siren_mlp_fwd_reference(x, d, params, True)
    LW = cfg.model.n_layers * cfg.model.d_filter
    diff = (acts[:rows].float() - ref_acts.float()).abs()
    errs = {"siren_fwd_rgb_err": float((out[:, :3] - ref[:, :3]).abs().max()),
            "siren_acts_h_err": float(diff[:, :LW].max()),
            "siren_acts_h_differ": float((diff[:, :LW] > 0).float().mean()),
            "siren_acts_fac_err": float(diff[:, LW:].max()),
            "siren_acts_fac_differ": float((diff[:, LW:] > 0).float().mean())}
    del ref_acts, diff
    target = torch.rand((rows, 4), generator=g, device=dev)
    dout = (2.0 * (out - target) / out.numel()).contiguous()

    def saved():
        return ks.siren_mlp_bwd(x, d, dout, params, acts)

    split = _split_ms(saved, ("siren_bwd_rows", "dw_gemm_kernel",
                              "dw_reduce_kernel"), 5)
    return {**errs,
            "siren_fwd_ms": _ms(lambda: ks.siren_mlp_fwd(x, d, params, True),
                                reps),
            "siren_fwd_nosave_ms": _ms(lambda: ks.siren_mlp_fwd(x, d, params),
                                       reps),
            "siren_fwd_host_ms": _host_ms(
                lambda: ks.siren_mlp_fwd(x, d, params, True), reps),
            "siren_bwd_ms": _ms(saved, reps),
            "siren_rows_ms": split["siren_bwd_rows"],
            "siren_dw_ms": split["dw_gemm_kernel"],
            "siren_reduce_ms": split["dw_reduce_kernel"],
            "siren_bwd_host_ms": _host_ms(saved, reps),
            "siren_bwd_recompute_ms": _ms(
                lambda: ks.siren_mlp_bwd(x, d, dout, params, None),
                max(reps // 5, 3))}


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
                         "march, mlp, siren, siren_march, eval")
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
