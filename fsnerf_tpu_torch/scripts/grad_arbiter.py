"""Hold a train backward kernel's gradients and its plain version's against
a float64 arbiter, on the card: kernel 6 (NeRF, ops/kernels/mlp_train.py::
mlp_train_bwd) or kernel 8 (SiNeRF, ops/kernels/siren.py::siren_mlp_bwd),
saved mode, at packed widths 256, 512, 768, 1024, 1280 and 2048 (and at
W_max, the widest whose packed weights int32 offsets address: 15872 for
the NeRF, 15360 for the SiNeRF, at 8 layers), on --rows rows over
--seeds seeds of weights (the port's init, 8 layers) and inputs (points in
the scene box, unit directions, the cotangent of an MSE loss against a
seeded target).

The arbiter is the plain version's walk in float64 from the same saved
activations (the kernel forward's bf16 stream), rounding to bf16 at the
same points as the kernel: the saved activations (given), feat and br
(NeRF) or s_s, feat and s_r (SiNeRF), and every cotangent that enters a
product. Its gradients are not rounded to bf16 (each is summed in float64
and kept in float32, which moves it by ~6e-8 of itself, so that the
arbiter of a model of ~2^31 weights fits on the card beside the kernel's
and the plain version's). The kernel and the plain version
(float32, on the card) each differ from it by their own f32 sums, which
flip some bf16 roundings (and ReLU masks) of their intermediates; a kernel
whose error against the arbiter stays within a small factor of the plain
version's is as right as the plain version, whatever the two read against
each other.

    python -m fsnerf_tpu_torch.scripts.grad_arbiter --kernel 6 \\
        [--widths 256,512,768,1024,1280,2048,max] [--rows 3000] \\
        [--seeds 10] \\
        [--out out/grad_arbiter_k6.jsonl]

Prints one JSON line per width and seed: each gradient tensor's error
(max |g - g_arbiter| / max |g_arbiter|, the module's parameter names) of
the kernel and of the plain version against the arbiter, the kernel
against the plain version (the card tests' measure), and the share of the
row pass's bf16 intermediates (from its xs scratch) and of the ReLU masks
of br (NeRF) or the sigma gate (SiNeRF) that differ from the arbiter's,
for the kernel and for the plain version (for the intermediates also the
share of the differing values whose magnitude is below the arbiter's),
and the forward kernel's (5 or 7) saved stream and outputs against a
float64 forward (`fwd`: each layer recomputed from the stream's own
previous layer, the share of its bf16 values that differ, the flips each
layer adds; the outputs of a float64 walk from the inputs, rgb's max abs
error and sigma's of its max, for the kernel and for the plain version);
then one line per width with the worst of each over the seeds and the
largest ratio of the kernel's worst error to the plain version's. The
card's name and power limit are in every line. Refuses to run without
CUDA.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys

import torch


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(0)


def _bf(t: torch.Tensor) -> torch.Tensor:
    """bf16 rounding, kept in t's dtype."""
    return t.to(torch.bfloat16).to(t.dtype)


def _errs(names, got, want) -> dict:
    return {n: float((g - w).abs().max() / (w.abs().max() + 1e-30))
            for n, g, w in zip(names, got, want)}


def _share(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a != b).float().mean())


def _flips(got: torch.Tensor, want: torch.Tensor) -> list:
    """[share of the bf16 values that differ, share of those whose
    magnitude is below the arbiter's]: f32 sums rounded toward zero
    (tensor cores add their products so) flip roundings downward more
    often than upward."""
    differ = got != want
    n = int(differ.sum())
    down = int((got.abs() < want.abs())[differ].sum()) if n else 0
    return [n / got.numel(), down / n if n else None]


def _inputs(n: int, seed: int, dev):
    g = torch.Generator(device=dev).manual_seed(1000 + seed)
    x = torch.rand((n, 3), generator=g, device=dev) * 3.0 - 1.5
    d = torch.nn.functional.normalize(
        torch.randn((n, 3), generator=g, device=dev), dim=-1)
    target = torch.cat([torch.rand((n, 3), generator=g, device=dev),
                        torch.zeros((n, 1), device=dev)], dim=-1)
    return x, d, target


def _nerf_heads(h, ed, hd):
    """(feat, br, rgb, sigma) in float64 from the last trunk activation, as
    render.py::heads_forward and sigma_head (raw)."""
    feat = _bf(h @ hd["conn"] + hd["b_conn"])
    br = _bf(torch.relu(feat @ hd["branch_h"] + ed @ hd["branch_d"]
                        + hd["b_branch"]))
    rgb = torch.sigmoid(br @ hd["rgb"] + hd["b_rgb"])
    return feat, br, rgb, h @ hd["sigma"] + hd["b_sigma"]


def _fwd_report(out, ref, arb, flips) -> dict:
    """The forward's numbers: {"kernel" | "plain": [rgb max abs error,
    sigma's max abs error over its max, share of the stream's bf16 values
    a layer flipped (NeRF: h; SiNeRF: h, factors)]}."""
    def errs(o):
        o = o.to(arb.dtype)
        return [float((o[:, :3] - arb[:, :3]).abs().max()),
                float((o[:, 3] - arb[:, 3]).abs().max()
                      / (arb[:, 3].abs().max() + 1e-30))]

    return {"kernel": errs(out) + flips[0], "plain": errs(ref) + flips[1]}


def nerf_fwd_arbiter(x, d, params, streams):
    """Kernel 5's forward in float64 (mlp_train_fwd_reference's walk, its
    bf16 roundings): (out [N, 4] rgb and raw sigma from the inputs, and
    for each saved stream [N, L W] of `streams` [the share of its values
    that differ from the layer recomputed in float64 from the stream's
    own previous layer])."""
    from fsnerf_tpu_torch.ops.kernels import mlp_train as mt
    from fsnerf_tpu_torch.ops.kernels.render import unpack

    f64 = torch.float64
    lay, W = params.layout, params.layout.width
    ex, ed = (e.to(f64) for e in mt._encodings(x, d, params))
    trunk, b_trunk, hd = unpack(params.wpack, params.bpack, lay.n_layers,
                                lay.skip, W, lay.de, lay.dd)
    hd = {k: v.to(f64) for k, v in hd.items()}

    def layer(i, h):
        ws = trunk[i]
        y = (ex if i == 0 else h) @ ws[0].to(f64)
        if i > 0 and len(ws) == 2:
            y = y + ex @ ws[1].to(f64)
        return _bf(torch.relu(y + b_trunk[i].to(f64)))

    h = None
    for i in range(lay.n_layers):
        h = layer(i, h)
    _, _, rgb, sigma = _nerf_heads(h, ed, hd)
    flips = []
    for s in streams:
        n = 0
        for i in range(lay.n_layers):
            prev = None if i == 0 else s[:, (i - 1) * W:i * W].to(f64)
            n += int((s[:, i * W:(i + 1) * W].to(f64) != layer(i, prev))
                     .sum())
        flips.append([n / s.numel()])
    return torch.cat([rgb, sigma], dim=-1), flips


def siren_fwd_arbiter(x, d, params, streams):
    """Kernel 7's forward in float64 (siren_mlp_fwd_reference's walk, its
    bf16 roundings, the polynomial sin / cos of fastmath.py): (out [N, 4]
    rgb and relu(sigma) from the inputs, and for each saved stream [N, 2
    L W] of `streams` [the share of its h values, the share of its factor
    values that differ from the layer recomputed in float64 from the
    stream's own previous h])."""
    from fsnerf_tpu_torch.ops.kernels import siren as ks
    from fsnerf_tpu_torch.ops.kernels.fastmath import sincos_fast

    f64 = torch.float64
    lay = params.layout
    L, W = lay.n_layers, lay.width
    u = ks.unpack(params.wpack, params.bpack, lay)   # bf16 views
    u = {k: (v if isinstance(v, list) else v.to(f64)) for k, v in u.items()}
    xf, df = x.to(f64), d.to(f64)

    def layer(i, h):
        y = (xf if i == 0 else h) @ u["t"][i].to(f64) + u["b"][i].to(f64)
        a = lay.alphas[i]
        s, c = sincos_fast(a * y, True, True)
        return _bf(s), _bf(a * c)

    h = None
    for i in range(L):
        h = layer(i, h)[0]
    hd = _siren_heads(h, df, u)
    out = torch.cat([hd["rgb"], torch.relu(hd["sigma_pre"])], dim=-1)
    flips = []
    for s in streams:
        nh = nc = 0
        for i in range(L):
            prev = None if i == 0 else s[:, (i - 1) * W:i * W].to(f64)
            h_i, c_i = layer(i, prev)
            nh += int((s[:, i * W:(i + 1) * W].to(f64) != h_i).sum())
            nc += int((s[:, (L + i) * W:(L + i + 1) * W].to(f64) != c_i)
                      .sum())
        half = s.numel() / 2
        flips.append([nh / half, nc / half])
    return out, flips


def nerf_arbiter(x, d, dout, params, acts):
    """Kernel 6's gradients in float64 from the saved activations acts [N,
    L W] (mlp_train.py::_bwd_terms' walk, its bf16 roundings): (dw, db)
    packed as wpack / bpack, and the intermediates feat, br."""
    from fsnerf_tpu_torch.ops.kernels import mlp_train as mt
    from fsnerf_tpu_torch.ops.kernels.render import unpack

    f64 = torch.float64
    lay, W = params.layout, params.layout.width
    ex, ed = (e.to(f64) for e in mt._encodings(x, d, params))
    # bf16 views of the packed weights, each taken to float64 where used
    trunk, b_trunk, hd = unpack(params.wpack, params.bpack, lay.n_layers,
                                lay.skip, W, lay.de, lay.dd)
    hd = {k: v.to(f64) for k, v in hd.items()}
    hs = [acts[:, i * W:(i + 1) * W].to(f64) for i in range(lay.n_layers)]
    h = hs[-1]
    dout = dout.to(f64)
    feat, br, rgb, _ = _nerf_heads(h, ed, hd)
    drgb = dout[:, :3] * rgb * (1.0 - rgb)
    drgb_b = _bf(drgb)
    dbr = torch.where(br > 0, drgb_b @ hd["rgb"].t(), 0.0)
    dbr_b = _bf(dbr)
    dfeat = dbr_b @ hd["branch_h"].t()
    dfeat_b = _bf(dfeat)
    dsig = dout[:, 3:4]
    dsig_b = _bf(dsig)
    dh = dfeat_b @ hd["conn"].t() + dsig_b @ hd["sigma"].t()
    g_trunk, b_grads = [None] * lay.n_layers, [None] * lay.n_layers
    for i in range(lay.n_layers - 1, -1, -1):
        dh = torch.where(hs[i] > 0, dh, 0.0)
        dh_b = _bf(dh)
        b_grads[i] = dh.sum(0).float()
        if i == 0:
            g_trunk[i] = [(ex.t() @ dh_b).float()]
        else:
            g_trunk[i] = [(hs[i - 1].t() @ dh_b).float()]
            if len(trunk[i]) == 2:
                g_trunk[i].append((ex.t() @ dh_b).float())
            dh = dh_b @ trunk[i][0].to(f64).t()
    heads_w = [h.t() @ dsig_b, h.t() @ dfeat_b, feat.t() @ dbr_b,
               ed.t() @ dbr_b, br.t() @ drgb_b]
    heads_b = [dsig.sum(0), dfeat.sum(0), dbr.sum(0), drgb.sum(0)]
    dw = torch.cat([g.reshape(-1) for gs in g_trunk for g in gs]
                   + [g.float().reshape(-1) for g in heads_w])
    db = torch.cat(b_grads + [b.float() for b in heads_b])
    return dw, db, {"feat": feat, "br": br}


def _siren_heads(h, df, u):
    """siren.py::_heads in float64 (every intermediate the backward
    reads)."""
    from fsnerf_tpu_torch.ops.kernels.fastmath import sincos_fast

    ys = h @ u["ws0"] + u["bs0"]
    s_s = _bf(sincos_fast(ys)[0])
    sigma_pre = s_s @ u["ws1"] + u["bs1"]
    feat = _bf(h @ u["wf"] + u["bf"])
    yr = feat @ u["wr0f"] + df @ u["wr0d"] + u["br0"]
    s_r = _bf(sincos_fast(yr)[0])
    rgb = torch.sigmoid(s_r @ u["wr1"] + u["br1"])
    return dict(ys=ys, s_s=s_s, sigma_pre=sigma_pre, feat=feat, yr=yr,
                s_r=s_r, rgb=rgb)


def siren_arbiter(x, d, dout, params, acts):
    """Kernel 8's gradients in float64 from the saved stream acts [N, 2 L
    W] (siren.py::siren_mlp_bwd_reference's walk, its bf16 roundings, the
    polynomial sin / cos of fastmath.py): (dw, db) packed as wpack /
    bpack, and the intermediates s_s, feat, s_r, sigma_pre."""
    from fsnerf_tpu_torch.ops.kernels import siren as ks
    from fsnerf_tpu_torch.ops.kernels.fastmath import sincos_fast

    f64 = torch.float64
    lay = params.layout
    L, W = lay.n_layers, lay.width
    u = ks.unpack(params.wpack, params.bpack, lay)   # bf16 views
    u = {k: (v if isinstance(v, list) else v.to(f64)) for k, v in u.items()}
    xf, df = x.to(f64), d.to(f64)
    a = acts.to(f64)
    hs = [a[:, i * W:(i + 1) * W] for i in range(L)]
    cs = [a[:, (L + i) * W:(L + i + 1) * W] for i in range(L)]
    h = hs[-1]
    dout = dout.to(f64)
    hd = _siren_heads(h, df, u)
    ys, s_s, sigma_pre = hd["ys"], hd["s_s"], hd["sigma_pre"]
    feat, yr, s_r, rgb = hd["feat"], hd["yr"], hd["s_r"], hd["rgb"]
    drgb = dout[:, :3] * rgb * (1.0 - rgb)
    drgb_b = _bf(drgb)
    dyr = (drgb_b @ u["wr1"].t()) * sincos_fast(yr, False, True)[1]
    dsig = torch.where(sigma_pre > 0.0, dout[:, 3:4], 0.0)
    dsig_b = _bf(dsig)
    dys = (dsig_b @ u["ws1"].t()) * sincos_fast(ys, False, True)[1]
    dyr_b, dys_b = _bf(dyr), _bf(dys)
    dfeat = dyr_b @ u["wr0f"].t()
    dfeat_b = _bf(dfeat)
    heads_w = [h.t() @ dys_b, s_s.t() @ dsig_b, h.t() @ dfeat_b,
               feat.t() @ dyr_b, df.t() @ dyr_b, s_r.t() @ drgb_b]
    heads_b = [dys.sum(0), dsig.sum(0), dfeat.sum(0), dyr.sum(0),
               drgb.sum(0)]
    dh = dfeat_b @ u["wf"].t() + dys_b @ u["ws0"].t()
    g_trunk, b_trunk = [None] * L, [None] * L
    for i in range(L - 1, -1, -1):
        dy = dh * cs[i]
        dy_b = _bf(dy)
        b_trunk[i] = dy.sum(0).float()
        g_trunk[i] = ((xf if i == 0 else hs[i - 1]).t() @ dy_b).float()
        if i > 0:
            dh = dy_b @ u["t"][i].to(f64).t()
    dw = torch.cat([g.reshape(-1) for g in g_trunk]
                   + [g.float().reshape(-1) for g in heads_w])
    db = torch.cat(b_trunk + [b.float() for b in heads_b])
    return dw, db, {"s_s": s_s, "feat": feat, "s_r": s_r,
                    "sigma_pre": sigma_pre}


def nerf_case(W: int, n: int, seed: int, dev) -> dict:
    from fsnerf_tpu_torch.config import Config
    from fsnerf_tpu_torch.core.models import make_model
    from fsnerf_tpu_torch.ops.kernels import mlp_train as mt
    from fsnerf_tpu_torch.ops.kernels import render as kr

    cfg = Config()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, d_filter=W))
    lay = mt.TrainLayout.from_config(cfg)
    model = make_model(cfg, torch.bfloat16,
                       torch.Generator().manual_seed(seed), dev)
    params = mt.pack_train_params(
        model.state_dict(), lay,
        kr.enc_table(lay.n_freqs, lay.n_freqs_views, device=dev))
    del model                         # ~2^31 weights at W_max
    x, d, target = _inputs(n, seed, dev)
    out, acts = mt.mlp_train_fwd(x, d, params, save_acts=True)
    ref, racts = mt.mlp_train_fwd_reference(x, d, params, save_acts=True)
    arb_out, fwd_flips = nerf_fwd_arbiter(x, d, params, (acts[:n], racts))
    fwd = _fwd_report(out[:n], ref, arb_out, fwd_flips)
    del racts, arb_out
    dout = (2.0 * (ref - target) / ref.numel()).contiguous()
    ops = {}
    kern = mt.mlp_train_bwd(x, d, dout, params, acts, operands=ops)
    plain = mt.mlp_train_bwd_reference(x, d, dout, params, acts[:n])
    terms = mt._bwd_terms(x, d, dout, params, acts[:n])
    dw, db, arb = nerf_arbiter(x, d, dout, params, acts[:n])
    de, dd = lay.de, lay.dd
    xs = ops["xs"][:n].float()
    k_feat, k_br = xs[:, de + dd:de + dd + W], xs[:, de + dd + W:]
    flips = {"feat": (_flips(k_feat, arb["feat"].float()),
                      _flips(terms["feat"], arb["feat"].float())),
             "br": (_flips(k_br, arb["br"].float()),
                    _flips(terms["br"], arb["br"].float())),
             "br_mask": (_share(k_br > 0, arb["br"] > 0),
                         _share(terms["br"] > 0, arb["br"] > 0))}
    return dict(_report(lay, kern, plain, (dw, db), flips), fwd=fwd)


def siren_case(W: int, n: int, seed: int, dev) -> dict:
    from fsnerf_tpu_torch.config import Config
    from fsnerf_tpu_torch.core.models import make_model
    from fsnerf_tpu_torch.ops.kernels import siren as ks

    cfg = Config()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, model="sinerf",
                                                d_filter=W))
    model = make_model(cfg, torch.bfloat16,
                       torch.Generator().manual_seed(seed), dev)
    params = ks.prep_siren_params(model.state_dict(), cfg.model.n_layers,
                                  with_transposed=True, device=dev)
    del model                         # ~2^31 weights at W_max
    lay = params.layout
    x, d, target = _inputs(n, seed, dev)
    xp, dp = ks.pad_inputs(x), ks.pad_inputs(d)
    out, acts = ks.siren_mlp_fwd(xp, dp, params, save_acts=True)
    ref, racts = ks.siren_mlp_fwd_reference(xp, dp, params, save_acts=True)
    arb_out, fwd_flips = siren_fwd_arbiter(xp, dp, params,
                                           (acts[:n], racts))
    fwd = _fwd_report(out[:n], ref, arb_out, fwd_flips)
    del racts, arb_out
    dout = (2.0 * (ref - target) / ref.numel()).contiguous()
    ops = {}
    kern = ks.siren_mlp_bwd(xp, dp, dout, params, acts, operands=ops)
    plain = ks.siren_mlp_bwd_reference(xp, dp, dout, params, acts[:n])
    u = ks._unpacked(params)
    hd = ks._heads(acts[:n, (lay.n_layers - 1) * W:lay.n_layers * W].float(),
                   dp.float(), u)
    dw, db, arb = siren_arbiter(xp, dp, dout, params, acts[:n])
    Wh, P = W // 2, ks.D_IN_PAD
    xs = ops["xs"][:n].float()
    cols = {"s_s": xs[:, 2 * P:2 * P + Wh],
            "feat": xs[:, 2 * P + Wh:2 * P + Wh + W],
            "s_r": xs[:, 2 * P + Wh + W:]}
    flips = {k: (_flips(v, arb[k].float()), _flips(hd[k], arb[k].float()))
             for k, v in cols.items()}
    flips["sigma_gate"] = (
        None, _share(hd["sigma_pre"] > 0, arb["sigma_pre"] > 0))
    return dict(_report(lay, kern, plain, (dw, db), flips), fwd=fwd)


# seeds at W_max, whose models hold ~2^31 weights each (init on the host)
MAX_SEEDS = 3


def w_max(kernel: int) -> int:
    """W_max of the default 8-layer model of kernel 6 (NeRF) or 8
    (SiNeRF)."""
    from fsnerf_tpu_torch.config import Config
    from fsnerf_tpu_torch.ops.kernels import mlp_train as mt
    from fsnerf_tpu_torch.ops.kernels import render as kr
    from fsnerf_tpu_torch.ops.kernels import siren as ks

    if kernel == 8:
        return ks.siren_max_width(Config().model.n_layers)
    return kr.widest_stream_width(lambda W: mt.TrainLayout.of_module(
        8, (4,), W, 10, 4).n_w)


def _report(lay, kern, plain, arb, flips) -> dict:
    names = lay.param_names

    def errs(got, want):     # two sets of module-shaped copies at a time
        return _errs(names, lay.grads_from_packed(*got),
                     lay.grads_from_packed(*want))

    ek, ep, ekp = errs(kern, arb), errs(plain, arb), errs(kern, plain)
    wk, wp = max(ek, key=ek.get), max(ep, key=ep.get)
    return {"tensors": {nm: [ek[nm], ep[nm], ekp[nm]] for nm in names},
            "worst_kernel": [wk, ek[wk]], "worst_plain": [wp, ep[wp]],
            "worst_kernel_vs_plain": max(ekp.values()),
            "ratio": ek[wk] / max(ep[wp], 1e-30), "flips": flips}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", type=int, choices=(6, 8), default=6)
    ap.add_argument("--widths", default="256,512,768,1024,1280,2048,max",
                    help="packed widths; max: W_max of the kernel's model")
    ap.add_argument("--rows", type=int, default=3000)
    ap.add_argument("--seeds", type=int, default=10)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("grad_arbiter: needs CUDA (it measures the card's kernels)",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    who = card()
    case = nerf_case if args.kernel == 6 else siren_case
    out = open(args.out, "w") if args.out else None
    for w in args.widths.split(","):
        W = w_max(args.kernel) if w == "max" else int(w)
        rows = []
        for seed in range(min(args.seeds, MAX_SEEDS) if w == "max"
                          else args.seeds):
            r = case(W, args.rows, seed, dev)
            r.update(kernel=args.kernel, width=W, seed=seed, rows=args.rows,
                     card=who)
            rows.append(r)
            line = json.dumps(r)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
        summary = {
            "kernel": args.kernel, "width": W, "seeds": len(rows),
            "rows": args.rows, "card": who,
            "worst_kernel": max(r["worst_kernel"][1] for r in rows),
            "worst_plain": max(r["worst_plain"][1] for r in rows),
            "worst_kernel_vs_plain": max(r["worst_kernel_vs_plain"]
                                         for r in rows),
            "max_ratio": max(r["ratio"] for r in rows),
            "mean_ratio": sum(r["ratio"] for r in rows) / len(rows),
            # the forward: the worst of each number over the seeds, and
            # the largest ratio of the kernel's to the plain version's
            "fwd_kernel": [max(v) for v in zip(
                *(r["fwd"]["kernel"] for r in rows))],
            "fwd_plain": [max(v) for v in zip(
                *(r["fwd"]["plain"] for r in rows))],
            "fwd_ratio": [max(r["fwd"]["kernel"][j]
                              / max(r["fwd"]["plain"][j], 1e-30)
                              for r in rows)
                          for j in range(len(rows[0]["fwd"]["kernel"]))]}
        line = json.dumps({"summary": summary})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
