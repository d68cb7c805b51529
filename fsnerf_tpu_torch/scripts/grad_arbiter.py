"""Hold a train backward kernel's gradients and its plain version's against
a float64 arbiter, on the card: kernel 6 (NeRF, ops/kernels/mlp_train.py::
mlp_train_bwd) or kernel 8 (SiNeRF, ops/kernels/siren.py::siren_mlp_bwd),
saved mode, at packed widths 256, 512, 768 and 1024, on --rows rows over
--seeds seeds of weights (the port's init, 8 layers) and inputs (points in
the scene box, unit directions, the cotangent of an MSE loss against a
seeded target).

The arbiter is the plain version's walk in float64 from the same saved
activations (the kernel forward's bf16 stream), rounding to bf16 at the
same points as the kernel: the saved activations (given), feat and br
(NeRF) or s_s, feat and s_r (SiNeRF), and every cotangent that enters a
product. Its gradients are not rounded. The kernel and the plain version
(float32, on the card) each differ from it by their own f32 sums, which
flip some bf16 roundings (and ReLU masks) of their intermediates; a kernel
whose error against the arbiter stays within a small factor of the plain
version's is as right as the plain version, whatever the two read against
each other.

    python -m fsnerf_tpu_torch.scripts.grad_arbiter --kernel 6 \\
        [--widths 256,512,768,1024] [--rows 3000] [--seeds 10] \\
        [--out out/grad_arbiter_k6.jsonl]

Prints one JSON line per width and seed: each gradient tensor's error
(max |g - g_arbiter| / max |g_arbiter|, the module's parameter names) of
the kernel and of the plain version against the arbiter, the kernel
against the plain version (the card tests' measure), and the share of the
row pass's bf16 intermediates (from its xs scratch) and of the ReLU masks
of br (NeRF) or the sigma gate (SiNeRF) that differ from the arbiter's,
for the kernel and for the plain version (for the intermediates also the
share of the differing values whose magnitude is below the arbiter's);
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


def nerf_arbiter(x, d, dout, params, acts):
    """Kernel 6's gradients in float64 from the saved activations acts [N,
    L W] (mlp_train.py::_bwd_terms' walk, its bf16 roundings): (dw, db)
    packed as wpack / bpack, and the intermediates feat, br."""
    from fsnerf_tpu_torch.ops.kernels import mlp_train as mt

    f64 = torch.float64
    lay, W = params.layout, params.layout.width
    ex, ed = (e.to(f64) for e in mt._encodings(x, d, params))
    trunk, b_trunk, hd = mt._unpacked(params)
    trunk = [[w.to(f64) for w in ws] for ws in trunk]
    hd = {k: v.to(f64) for k, v in hd.items()}
    hs = [acts[:, i * W:(i + 1) * W].to(f64) for i in range(lay.n_layers)]
    h = hs[-1]
    dout = dout.to(f64)
    feat = _bf(h @ hd["conn"] + hd["b_conn"])
    br = _bf(torch.relu(feat @ hd["branch_h"] + ed @ hd["branch_d"]
                        + hd["b_branch"]))
    rgb = torch.sigmoid(br @ hd["rgb"] + hd["b_rgb"])
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
        b_grads[i] = dh.sum(0)
        if i == 0:
            g_trunk[i] = [ex.t() @ dh_b]
        else:
            g_trunk[i] = [hs[i - 1].t() @ dh_b]
            if len(trunk[i]) == 2:
                g_trunk[i].append(ex.t() @ dh_b)
            dh = dh_b @ trunk[i][0].t()
    heads_w = [h.t() @ dsig_b, h.t() @ dfeat_b, feat.t() @ dbr_b,
               ed.t() @ dbr_b, br.t() @ drgb_b]
    heads_b = [dsig.sum(0), dfeat.sum(0), dbr.sum(0), drgb.sum(0)]
    dw = torch.cat([g.reshape(-1) for gs in g_trunk for g in gs]
                   + [g.reshape(-1) for g in heads_w])
    db = torch.cat(b_grads + heads_b)
    return dw, db, {"feat": feat, "br": br}


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
    u = ks._unpacked(params)
    u = {k: ([t.to(f64) for t in v] if isinstance(v, list) else v.to(f64))
         for k, v in u.items()}
    xf, df = x.to(f64), d.to(f64)
    a = acts.to(f64)
    hs = [a[:, i * W:(i + 1) * W] for i in range(L)]
    cs = [a[:, (L + i) * W:(L + i + 1) * W] for i in range(L)]
    h = hs[-1]
    dout = dout.to(f64)
    ys = h @ u["ws0"] + u["bs0"]
    s_s = _bf(sincos_fast(ys)[0])
    sigma_pre = s_s @ u["ws1"] + u["bs1"]
    feat = _bf(h @ u["wf"] + u["bf"])
    yr = feat @ u["wr0f"] + df @ u["wr0d"] + u["br0"]
    s_r = _bf(sincos_fast(yr)[0])
    rgb = torch.sigmoid(s_r @ u["wr1"] + u["br1"])
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
        b_trunk[i] = dy.sum(0)
        g_trunk[i] = (xf if i == 0 else hs[i - 1]).t() @ dy_b
        if i > 0:
            dh = dy_b @ u["t"][i].t()
    dw = torch.cat([g.reshape(-1) for g in g_trunk + heads_w])
    db = torch.cat(b_trunk + heads_b)
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
    x, d, target = _inputs(n, seed, dev)
    _, acts = mt.mlp_train_fwd(x, d, params, save_acts=True)
    ref, _ = mt.mlp_train_fwd_reference(x, d, params)
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
    return _report(lay, kern, plain, (dw, db), flips)


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
    lay = params.layout
    x, d, target = _inputs(n, seed, dev)
    xp, dp = ks.pad_inputs(x), ks.pad_inputs(d)
    _, acts = ks.siren_mlp_fwd(xp, dp, params, save_acts=True)
    ref, _ = ks.siren_mlp_fwd_reference(xp, dp, params)
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
    return _report(lay, kern, plain, (dw, db), flips)


def _report(lay, kern, plain, arb, flips) -> dict:
    names = lay.param_names
    k = lay.grads_from_packed(*kern)
    p = lay.grads_from_packed(*plain)
    a = lay.grads_from_packed(*arb)
    ek, ep, ekp = _errs(names, k, a), _errs(names, p, a), _errs(names, k, p)
    wk, wp = max(ek, key=ek.get), max(ep, key=ep.get)
    return {"tensors": {nm: [ek[nm], ep[nm], ekp[nm]] for nm in names},
            "worst_kernel": [wk, ek[wk]], "worst_plain": [wp, ep[wp]],
            "worst_kernel_vs_plain": max(ekp.values()),
            "ratio": ek[wk] / max(ep[wp], 1e-30), "flips": flips}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", type=int, choices=(6, 8), default=6)
    ap.add_argument("--widths", default="256,512,768,1024")
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
    for W in (int(w) for w in args.widths.split(",")):
        rows = []
        for seed in range(args.seeds):
            r = case(W, args.rows, seed, dev)
            r.update(kernel=args.kernel, width=W, seed=seed, rows=args.rows,
                     card=who)
            rows.append(r)
            line = json.dumps(r)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
        summary = {
            "kernel": args.kernel, "width": W, "seeds": args.seeds,
            "rows": args.rows, "card": who,
            "worst_kernel": max(r["worst_kernel"][1] for r in rows),
            "worst_plain": max(r["worst_plain"][1] for r in rows),
            "worst_kernel_vs_plain": max(r["worst_kernel_vs_plain"]
                                         for r in rows),
            "max_ratio": max(r["ratio"] for r in rows),
            "mean_ratio": sum(r["ratio"] for r in rows) / len(rows)}
        line = json.dumps({"summary": summary})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
