"""fsnerf_tpu_torch's configuration against fsnerf_tpu's: the YAML text
of Config.save_yaml byte for byte against PyYAML's (the port writes and
reads it without PyYAML), load_yaml of the JAX package's files, every
command-line flag through config_from_args (with and without --config),
and the command line's run directory on the CPU."""

import dataclasses
import json
import os

import numpy as np
import pytest
import yaml

from fsnerf_tpu import config as jconfig
from fsnerf_tpu_torch import cli
from fsnerf_tpu_torch import config as tconfig

_SECTIONS = ("encoder", "model", "data", "sampling", "train", "parallel",
             "log")


def _both(**sections):
    """The same Config in both packages from {section: {field: value}}."""
    out = []
    for mod in (jconfig, tconfig):
        base = mod.Config()
        out.append(base.replace(**{
            k: dataclasses.replace(getattr(base, k), **v)
            for k, v in sections.items()}))
    return out


VARIED = {
    "default": {},
    "llff_nulls": dict(
        data=dict(dataset="llff", scene="fern", factor=4, data_root="/d/x"),
        sampling=dict(grid_levels=4, query_dilation=None, n_compact=0),
        model=dict(fused_kernel=None, skip=()),
        train=dict(ao=None, beta=None, import_torch_ckpt=None)),
    "small_floats_lists": dict(
        encoder=dict(freq_reg_end=7200, log_space=False),
        model=dict(skip=(1, 3, 5), fused_kernel=True, d_filter=128),
        sampling=dict(early_stop_eps=1e-6, render_step_size=1e-3,
                      occ_thre=5e-5, compact_margin=1.25, ema_decay=0.9),
        train=dict(ao=1e-6, occ_a=0.003, occ_b=2.0, beta=1.0, lro=1e-4,
                   Td=100000, async_ladder=False, reg="l2")),
    "strings_and_big": dict(
        data=dict(scene="yes", data_root="~/data sets/2001-12-14",
                  bd_factor=1e16, val_ratio=0.1),
        log=dict(out_dir="../out/", export_render="", use_wandb=True,
                 debug=True),
        parallel=dict(n_devices=8, distributed=True),
        train=dict(import_torch_ckpt="runs/nn.pt", seed=2 ** 40,
                   n_iters=20 ** 3)),
}


@pytest.mark.parametrize("name", sorted(VARIED))
def test_save_yaml_is_pyyaml_byte_for_byte(name, tmp_path):
    """save_yaml's text equals the JAX package's (yaml.safe_dump), and each
    package's load_yaml reads the other's file back to the same config."""
    j, t = _both(**VARIED[name])
    j.save_yaml(str(tmp_path / "j.yaml"))
    t.save_yaml(str(tmp_path / "t.yaml"))
    text = (tmp_path / "j.yaml").read_text()
    assert (tmp_path / "t.yaml").read_text() == text
    assert dataclasses.asdict(tconfig.Config.load_yaml(
        str(tmp_path / "j.yaml"))) == dataclasses.asdict(t)
    assert dataclasses.asdict(jconfig.Config.load_yaml(
        str(tmp_path / "t.yaml"))) == dataclasses.asdict(j)
    assert tconfig.Config.from_dict(t.to_dict()) == t


AWKWARD = ["", "yes", "No", "on", "null", "~", "True", "1.0", "1e5", "12",
           "0x1f", "0o7", "07", "1_000", ".inf", ".5", "1:20", "2001-12-14",
           "y", "a: b", "a:b", "a:", "#x", "a#b", "a #b", "-", "-a", "- a",
           "?a", "? a", " x", "x ", "a  b", "<<", "=", "@a", "%a", "*a",
           "&a", "!a", "|a", ">a", "`a", "a`", "'a", '"a', "it's", "[a",
           "{a", "a,b", "---a", "...", "C:\\data", "\u00e9t\u00e9", "a\tb",
           "a\x7fb", "\U0001F600", "x" * 100, "a b " * 30, "it's " * 30,
           "path/with space/" + "y" * 90, "x" * 75 + " y z"]


@pytest.mark.parametrize("i", range(len(AWKWARD)))
def test_yaml_strings_match_pyyaml(i):
    """A string value PyYAML would quote, escape or fold is written as it
    writes it, and read back."""
    d = {"data": {"scene": AWKWARD[i], "data_root": AWKWARD[i]}}
    text = tconfig._dump_yaml(d)
    assert text == yaml.safe_dump(d, sort_keys=False)
    assert tconfig._load_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("v", [0.0, -0.0, 1.0, 0.1, 5e-3, 1e-4, 1e-6,
                               -1e-5, 1e-10, 3e-320, 250000.0, 1e15, 1e16,
                               1.5e300, float("inf"), -float("inf"), 0, -3,
                               2 ** 70, True, False, None])
def test_yaml_numbers_match_pyyaml(v):
    d = {"train": {"lro": v}}
    text = tconfig._dump_yaml(d)
    assert text == yaml.safe_dump(d, sort_keys=False)
    assert tconfig._load_yaml(text) == yaml.safe_load(text)


def test_from_dict_refuses_unknown_keys_and_reads_comments():
    with pytest.raises(ValueError, match="ModelConfig.widht"):
        tconfig.Config.from_dict({"model": {"widht": 3}})
    cfg = tconfig.Config.from_dict(tconfig._load_yaml(
        "# a hand-written file\nmodel:\n  skip: [2, 5]  # two skips\n"
        "  d_filter: 128\ntrain:\n  lro: 1.0e-3\n  ao:\n"))
    assert cfg.model.skip == (2, 5) and cfg.model.d_filter == 128
    assert cfg.train.lro == 1e-3 and cfg.train.ao is None


def test_parser_flags_match_jax():
    """Every flag of fsnerf_tpu's parser, with its destination, default,
    type, choices and action; the port adds --hw and --device."""
    jp, tp = jconfig.config_parser(), tconfig.config_parser()
    tact = {tuple(a.option_strings): a for a in tp._actions}
    for a in jp._actions:
        b = tact.pop(tuple(a.option_strings))
        assert (a.dest, a.default, a.type, a.choices, a.nargs, a.const,
                type(a)) == (b.dest, b.default, b.type, b.choices, b.nargs,
                             b.const, type(b)), a.option_strings
    assert sorted(tact) == [("--device",), ("--hw",)]
    assert tconfig._FLAG_MAP == jconfig._FLAG_MAP


ARGVS = [
    [],
    ["--d_input", "3", "--n_freqs", "6", "--linear_freqs", "--no_dirs",
     "--n_freqs_views", "3", "--freq_reg_end", "100"],
    ["--model", "sinerf", "--d_filter", "128", "--n_layers", "6", "--skip",
     "1,3", "--density_activation", "relu", "--fused_kernel",
     "--no_fused_save_acts", "--no_fused_encode", "--no_fused_render"],
    ["--no_fused_kernel", "--skip", ""],
    ["--dataset", "llff", "--scene", "fern", "--n_imgs", "3",
     "--white_bkgd", "--factor", "4", "--bd_factor", "0.5", "--no_recenter",
     "--data_root", "/data", "--downsample", "2"],
    ["--strategy", "hierarchical", "--n_samples", "64", "--n_fine", "32",
     "--render_step_size", "0.01", "--grid_resolution", "64", "--occ_thre",
     "0.02", "--n_compact", "96", "--compact_margin", "1.25",
     "--no_adapt_compact", "--no_async_ladder", "--early_stop_eps", "1e-3",
     "--query_stride", "2", "--query_dilation", "1", "--query_max_stride",
     "4", "--update_interval", "8", "--update_interval_late", "32",
     "--update_interval_late_start", "512", "--grid_hold_steps", "100"],
    ["--n_iters", "300", "--batch_size", "512", "--lro", "1e-3",
     "--decay_rate", "0.5", "--Td", "1000", "--scheduler", "const",
     "--seed", "3", "--dtype", "float32", "--halt_on_divergence"],
    ["--n_devices", "4", "--distributed", "--val", "--val_rate", "50",
     "--val_ratio", "0.2", "--test_ratio", "0.1"],
    ["--ao", "1e-6", "--reg_ratio", "0.4", "--reg", "l2", "--a", "0.003",
     "--b", "2", "--func", "exp", "--beta", "1"],
    ["--out_dir", "runs", "--use_wandb", "--ckpt_every", "100", "--resume",
     "--import_torch_ckpt", "nn.pt", "--export_render", "art", "--debug",
     "--render_only"],
    ["--n_iters=7", "--skip=2"],
]


@pytest.mark.parametrize("i", range(len(ARGVS)))
def test_config_from_args_matches_jax(i):
    argv = ARGVS[i]
    assert dataclasses.asdict(tconfig.config_from_args(argv)) == \
        dataclasses.asdict(jconfig.config_from_args(argv))


def test_argv_table_covers_every_jax_flag():
    flags = {o for a in jconfig.config_parser()._actions
             for o in a.option_strings if o not in ("-h", "--help")}
    used = {tok.split("=")[0] for argv in ARGVS + CONFIG_ARGVS
            for tok in argv if tok.startswith("--")}
    assert flags <= used, sorted(flags - used)


CONFIG_ARGVS = [
    ["--config", "{yaml}"],
    ["--config", "{yaml}", "--n_iters", "50", "--dataset", "synthetic"],
    ["--config", "{yaml}", "--no_fused_kernel", "--skip", "3",
     "--linear_freqs", "--no_adapt_compact", "--no_fused_render"],
    ["--config", "{pinned}", "--dataset", "synthetic"],
    ["--config", "{pinned}", "--strategy", "hierarchical"],
]


@pytest.mark.parametrize("i", range(len(CONFIG_ARGVS)))
def test_config_file_merges_as_jax(i, tmp_path):
    """--config FILE: only the flags given override it; grid_levels follows
    the dataset unless the file pins it (the pinned file sets 2)."""
    j, _ = _both(data=dict(dataset="llff", n_imgs=5),
                 model=dict(skip=(1,), fused_kernel=True),
                 sampling=dict(ema_decay=0.8, warmup_steps=10),
                 train=dict(lro=2e-4))
    j.save_yaml(str(tmp_path / "c.yaml"))
    d = yaml.safe_load((tmp_path / "c.yaml").read_text())
    d["sampling"]["grid_levels"] = 2
    (tmp_path / "p.yaml").write_text(yaml.safe_dump(d, sort_keys=False))
    argv = [a.format(yaml=tmp_path / "c.yaml", pinned=tmp_path / "p.yaml")
            for a in CONFIG_ARGVS[i]]
    got = tconfig.config_from_args(argv)
    assert dataclasses.asdict(got) == \
        dataclasses.asdict(jconfig.config_from_args(argv))
    assert got.sampling.ema_decay == 0.8


TINY = ["--dataset", "sphere", "--device", "cpu", "--hw", "8", "--n_imgs",
        "2", "--n_layers", "2", "--d_filter", "32", "--skip", "0",
        "--n_freqs", "2", "--n_freqs_views", "2", "--grid_resolution", "8",
        "--n_samples", "16", "--n_compact", "16", "--render_step_size",
        "0.3", "--n_iters", "4", "--batch_size", "16", "--fused_kernel"]


def test_cli_run_directory(tmp_path, capsys):
    """cli.main writes config.yaml, metrics.jsonl, final_metrics.json, the
    checkpoint and the path's frames under <out_dir>/<model>/<dataset>/
    <scene>/n_imgs_<n>; --render_only restores from there (the same
    step); --config of that config.yaml is the run's config; --debug and
    --export_render write nothing (--debug renders no path: nothing would
    receive it)."""
    out = tmp_path / "runs"
    assert cli.main(TINY + ["--out_dir", str(out)]) == 0
    first = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    run = out / "nerf" / "sphere" / "lego" / "n_imgs_2"
    assert cli.run_dir(tconfig.config_from_args(
        TINY + ["--out_dir", str(out)])) == os.path.normpath(run)
    assert sorted(os.listdir(run)) == ["ckpt", "config.yaml",
                                       "final_metrics.json", "metrics.jsonl",
                                       "video"]
    saved = tconfig.Config.load_yaml(str(run / "config.yaml"))
    assert saved == tconfig.config_from_args(TINY + ["--out_dir", str(out)])
    assert dataclasses.asdict(tconfig.config_from_args(
        ["--config", str(run / "config.yaml")])) == dataclasses.asdict(saved)
    assert first["steps"] == 4 and first["lpips"] is None
    assert cli.main(TINY + ["--out_dir", str(out), "--render_only"]) == 0
    again = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert again["restored_step"] == 4
    assert again["psnr"] == first["psnr"]

    quiet = tmp_path / "quiet"
    assert cli.main(TINY + ["--out_dir", str(quiet), "--debug"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(line["psnr"]) and "path_frames" not in line
    assert not quiet.exists()
    assert cli.main(TINY + ["--out_dir", str(quiet), "--export_render",
                            str(tmp_path / "art")]) == 2
    assert "not ported" in capsys.readouterr().err
    assert not quiet.exists() and not (tmp_path / "art").exists()
    assert cli.main(TINY + ["--debug", "--resume"]) == 2
