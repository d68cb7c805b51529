"""Configuration: typed dataclasses, their YAML files and the command-line
parser (port of fsnerf_tpu/config.py).

Same sections, field names, field order and defaults as the JAX package
(EncoderConfig, ModelConfig, DataConfig, SamplingConfig, TrainConfig,
ParallelConfig, LogConfig), the same flags with the same destinations and
the same `--config` merge rules, so one command line or config.yaml serves
both packages. Fields that only the TPU kernels or unported features read
are kept so a config built for one package names the same things in the
other; each says so where it is declared.

YAML. The card's machine has no PyYAML, so `save_yaml` writes and
`load_yaml` reads the file with code of its own (`_dump_yaml`,
`_load_yaml`): a two-level mapping of null, bool, int, float and str
values and block lists, byte-equal to what `yaml.safe_dump(cfg.to_dict(),
sort_keys=False)` writes (PyYAML's float forms, its quoting of strings that
would read back as another type, its line folding at 80 columns).
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import re
import sys
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class EncoderConfig:
    """Positional-encoding options."""

    d_input: int = 3
    n_freqs: int = 10
    n_freqs_views: int = 4
    log_space: bool = True          # reference default: log-spaced frequencies
    no_dirs: bool = False
    # FreeNeRF annealed frequency masking: steps over which the visible band
    # grows linearly. 0 disables (identity mask).
    freq_reg_end: int = 0


@dataclass(frozen=True)
class ModelConfig:
    """Model options."""

    model: str = "nerf"             # nerf | sinerf
    d_filter: int = 256
    n_layers: int = 8
    skip: Tuple[int, ...] = (4,)
    density_activation: str = "none"  # none | relu | trunc_exp
    # Train through the fused MLP kernels (ops/kernels/mlp_train.py for
    # NeRF, ops/kernels/siren.py for SiNeRF); None = auto: on for CUDA
    # devices (train/step.py::resolve_fused_kernel).
    fused_kernel: Optional[bool] = None
    # The NeRF train forward streams the trunk activations to device memory
    # and the backward reads them (True), or the backward recomputes the
    # trunk (False); the gradients are bitwise equal either way.
    fused_save_acts: bool = True
    # TPU tuning knobs of the JAX package's train kernels, carried but
    # unread: the port always encodes inside its kernels and fixes its own
    # tiles (fused_encode, which --no_fused_encode sets, block rows, VMEM
    # limit, acts stride, interleave).
    fused_encode: bool = True
    fused_block_rows: Optional[int] = None
    fused_fwd_block_rows: Optional[int] = None
    fused_vmem_limit_mb: Optional[int] = None
    fused_acts_stride: Optional[int] = None
    fused_interleave: Optional[int] = None
    # SiNeRF's train forward streams the sine activations and their
    # premultiplied derivatives a cos(a y) to device memory as bf16 and the
    # backward reads them (True), or the backward recomputes the trunk and
    # holds the derivatives in float32 (False); the gradients of the two
    # modes differ by that rounding (ops/kernels/siren.py).
    siren_save_acts: bool = True
    # Render through the fused ray-march kernel (ops/kernels/render.py).
    fused_render: bool = True


@dataclass(frozen=True)
class DataConfig:
    """Dataset options."""

    dataset: str = "synthetic"      # the port renders sphere | lattice
    scene: str = "lego"
    n_imgs: int = 100
    white_bkgd: bool = False
    factor: int = 8
    bd_factor: float = 0.75
    no_recenter: bool = False
    data_root: str = "../datasets"
    val_ratio: float = 0.15
    test_ratio: float = 0.15
    downsample: int = 1


@dataclass(frozen=True)
class SamplingConfig:
    """Ray sampling and occupancy grid."""

    strategy: str = "occgrid"       # occgrid | hierarchical
    n_samples: int = 512            # occgrid lattice, or hierarchical coarse
    n_fine: int = 128               # hierarchical inverse-CDF samples
    # compact each ray's valid samples to this many before the MLP runs;
    # the ceiling of the adaptive ladder (derive_eval_n_compact)
    n_compact: int = 192
    adapt_compact: bool = True
    compact_margin: float = 1.0
    early_stop_eps: float = 1e-4
    query_stride: int = 0           # 0 = auto (ops/occgrid.py::resolve_query_plan)
    query_dilation: Optional[int] = None
    query_max_stride: int = 0
    render_step_size: float = 5e-3
    grid_resolution: int = 128
    grid_levels: int = 1
    occ_thre: float = 1e-2
    ema_decay: float = 0.95
    update_interval: int = 16
    update_interval_late: int = 64
    update_interval_late_start: int = 1024
    warmup_steps: int = 256
    grid_hold_steps: int = -1
    update_parts: int = 4
    perturb: bool = True


@dataclass(frozen=True)
class TrainConfig:
    """Training options."""

    n_iters: int = 8000
    batch_size: int = 1024
    lro: float = 5e-4
    decay_rate: float = 0.1
    Td: int = 250000                # weight-reg schedule only (T = n_iters)
    scheduler: str = "exp"          # const | exp
    seed: int = 42
    # weight regularization (alpha, active while step < reg_ratio * Td)
    ao: Optional[float] = None
    reg_ratio: float = 0.5
    reg: str = "l1"                 # l1 | l2
    # occlusion regularization; beta gates it (it does not scale it)
    occ_a: Optional[float] = None
    occ_b: Optional[float] = None
    occ_func: str = "linear"        # linear | exp
    beta: Optional[float] = None
    # compute dtype of the NeRF module (the path that does not use the fused
    # kernels, and a SiNeRF's grid refresh): float32 | bfloat16
    dtype: str = "bfloat16"
    # in-loop validation (train/loop.py): val_fn every val_rate steps
    val: bool = False
    val_rate: int = 500
    # full-state checkpoints (utils/checkpoint.py) every ckpt_every steps
    # (0 = only the final one), and continuing from the latest one
    ckpt_every: int = 0
    resume: bool = False
    # initialize the weights from a reference nn.pt state dict
    # (utils/interop.py); with render_only they are rendered directly, the
    # occupancy grid rebuilt from their densities
    import_torch_ckpt: Optional[str] = None
    # hides XLA compile time in the JAX package; the port captures a new
    # K's CUDA graphs synchronously (train/loop.py), so it is carried but
    # unread (--no_async_ladder sets it)
    async_ladder: Optional[bool] = None
    # a train-PSNR collapse halts training (a non-finite loss always does)
    halt_on_divergence: bool = False


@dataclass(frozen=True)
class ParallelConfig:
    """Data-parallel options (parallel/mesh.py)."""

    # the JAX mesh axis's name; the port's group has the one batch axis
    data_axis: str = "data"
    n_devices: int = 0              # 0 = every rank of the process group
    # join the process group torchrun describes (parallel/mesh.py::
    # distributed_init) before any CUDA call
    distributed: bool = False


@dataclass(frozen=True)
class LogConfig:
    """Run directory and logging (cli.py)."""

    out_dir: str = "../out/"
    debug: bool = False             # write nothing
    render_only: bool = False
    use_wandb: bool = False         # wandb optional; JSON lines always written
    # the JAX package's StableHLO serving artifact; not ported, so the
    # command line refuses a non-empty value
    export_render: str = ""


@dataclass(frozen=True)
class Config:
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    sampling: SamplingConfig = field(default_factory=SamplingConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    log: LogConfig = field(default_factory=LogConfig)

    def replace(self, **sections) -> "Config":
        return dataclasses.replace(self, **sections)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "Config":
        """The config of a to_dict-shaped mapping; sections it lacks keep
        their defaults, a key no section field names raises ValueError."""
        sections = {}
        for name, cls in _SECTION_TYPES.items():
            if name not in d:
                continue
            names = {f.name for f in dataclasses.fields(cls)}
            kwargs = {}
            for k, v in (d[name] or {}).items():
                if k not in names:
                    raise ValueError(
                        f"Unknown config key: {cls.__name__}.{k}")
                if k == "skip" and isinstance(v, (list, tuple)):
                    v = tuple(int(s) for s in v)
                kwargs[k] = v
            sections[name] = cls(**kwargs)
        return Config(**sections)

    def save_yaml(self, path: str) -> None:
        with open(path, "w") as fh:
            fh.write(_dump_yaml(self.to_dict()))

    @staticmethod
    def load_yaml(path: str) -> "Config":
        with open(path) as fh:
            return Config.from_dict(_load_yaml(fh.read()))


_SECTION_TYPES = {
    "encoder": EncoderConfig,
    "model": ModelConfig,
    "data": DataConfig,
    "sampling": SamplingConfig,
    "train": TrainConfig,
    "parallel": ParallelConfig,
    "log": LogConfig,
}

# --- YAML: PyYAML's safe_dump forms for a two-level mapping ---------------

_WIDTH = 80                     # PyYAML's best_width: plain and quoted
                                # scalars fold at a single space past it
_VALUE_INDENT = 4               # a folded line of a section's value
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False"
                   r"|FALSE|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                  r"|[-+]?0x[0-9a-fA-F_]+|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$")
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(
    r"^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]"
    r"|[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?(?:[Tt]|[ \t]+)"
    r"[0-9][0-9]?:[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?"
    r"(?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$")
_OTHER_TYPE = (_BOOL, _FLOAT, _INT, _NULL, _TIMESTAMP,
               re.compile(r"^(?:<<|=)$"))
_ESCAPES = {"\0": "0", "\x07": "a", "\x08": "b", "\t": "t", "\n": "n",
            "\x0b": "v", "\x0c": "f", "\r": "r", "\x1b": "e", '"': '"',
            "\\": "\\", "\x85": "N", "\xa0": "_", "\u2028": "L",
            "\u2029": "P"}
_SPACE = "\0 \t\r\n\x85\u2028\u2029"


def _float_text(v: float) -> str:
    if v != v:
        return ".nan"
    if math.isinf(v):
        return ".inf" if v > 0 else "-.inf"
    text = repr(v).lower()
    # '1e-06' does not read back as a float in YAML 1.1
    if "." not in text and "e" in text:
        text = text.replace("e", ".0e", 1)
    return text


def _string_style(s: str) -> str:
    """'plain', 'single' or 'double': the style safe_dump picks for a
    string value of a block mapping."""
    if not s:
        return "single"
    if any(not (" " <= ch <= "~") for ch in s):
        return "double"         # controls, tabs and (allow_unicode off)
    if any(p.match(s) for p in _OTHER_TYPE):   # non-ASCII are escaped
        return "single"
    plain = not (s[0] == " " or s[-1] == " " or s.startswith("---")
                 or s.startswith("..."))
    for i, ch in enumerate(s):
        after = i + 1 == len(s) or s[i + 1] in _SPACE
        if i == 0:
            bad = (ch in "#,[]{}&*!|>'\"%@`"
                   or (ch in "?:-" and after))
        else:
            bad = ((ch == ":" and after)
                   or (ch == "#" and s[i - 1] in _SPACE))
        plain = plain and not bad
    return "plain" if plain else "single"


def _fold(pieces, column: int) -> str:
    """Join text pieces split at single spaces (None marks each), breaking
    the line at such a space once the column passes _WIDTH, as PyYAML's
    write_plain / write_single_quoted do."""
    out = []
    for piece in pieces:
        if piece is None:
            if column > _WIDTH:
                out.append("\n" + " " * _VALUE_INDENT)
                column = _VALUE_INDENT
            else:
                out.append(" ")
                column += 1
        else:
            out.append(piece)
            column += len(piece)
    return "".join(out)


def _split_spaces(s: str, quoted: bool):
    """s as pieces with None at each single space that may fold: runs of
    spaces stay text, and a quoted scalar folds at neither end."""
    pieces, i = [], 0
    for m in re.finditer(r" +", s):
        a, b = m.span()
        pieces.append(s[i:a])
        fold = b - a == 1 and not (quoted and (a == 0 or b == len(s)))
        pieces.append(None if fold else s[a:b])
        i = b
    pieces.append(s[i:])
    return [p for p in pieces if p != ""]


def _scalar_text(v, column: int) -> str:
    """The text of a scalar value starting at `column`."""
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        return _float_text(v)
    if not isinstance(v, str):
        raise TypeError(f"cannot write {type(v).__name__} to a config file")
    if any(ch in "\n\r\x85\u2028\u2029" for ch in v):
        raise ValueError("config strings hold no line breaks")
    style = _string_style(v)
    if style == "plain":
        return _fold(_split_spaces(v, False), column)
    if style == "single":
        return "'" + _fold(_split_spaces(v.replace("'", "''"), True),
                           column + 1) + "'"
    body = []
    for ch in v:
        if ch in _ESCAPES:
            body.append("\\" + _ESCAPES[ch])
        elif " " <= ch <= "~":
            body.append(ch)
        elif ch <= "\xff":
            body.append(f"\\x{ord(ch):02X}")
        elif ch <= "\uffff":
            body.append(f"\\u{ord(ch):04X}")
        else:
            body.append(f"\\U{ord(ch):08X}")
    text = '"' + "".join(body) + '"'
    if column + len(text) > _WIDTH and " " in v:
        raise ValueError("a double-quoted config string this long would "
                         "fold")
    return text


def _dump_yaml(d: dict) -> str:
    """yaml.safe_dump(d, sort_keys=False) for a mapping of sections, each a
    mapping of scalars and lists (tuples) of scalars."""
    lines = []
    for name, section in d.items():
        if not section:
            lines.append(f"{name}: {{}}")
            continue
        lines.append(f"{name}:")
        for k, v in section.items():
            if isinstance(v, (list, tuple)):
                if not v:
                    lines.append(f"  {k}: []")
                    continue
                lines.append(f"  {k}:")
                lines += [f"  - {_scalar_text(x, 4)}" for x in v]
            else:
                lines.append(f"  {k}: {_scalar_text(v, len(k) + 4)}")
    return "\n".join(lines) + "\n"


def _resolve_plain(s: str):
    """A plain scalar's value, by YAML 1.1's implicit types."""
    if _NULL.match(s):
        return None
    if _BOOL.match(s):
        return s.lower() in ("yes", "true", "on")
    if _INT.match(s):
        t = s.replace("_", "")
        sign = -1 if t[0] == "-" else 1
        t = t.lstrip("+-")
        if t == "0":
            return 0
        if t.startswith("0b"):
            return sign * int(t[2:], 2)
        if t.startswith("0x"):
            return sign * int(t[2:], 16)
        if t[0] == "0":
            return sign * int(t, 8)
        if ":" in t:
            return sign * sum(int(p) * 60 ** i for i, p in
                              enumerate(reversed(t.split(":"))))
        return sign * int(t)
    if _FLOAT.match(s):
        t = s.replace("_", "").lower()
        sign = -1.0 if t[0] == "-" else 1.0
        t = t.lstrip("+-")
        if t == ".inf":
            return sign * math.inf
        if t == ".nan":
            return math.nan
        if ":" in t:
            return sign * sum(float(p) * 60 ** i for i, p in
                              enumerate(reversed(t.split(":"))))
        return sign * float(t)
    return s


def _unquote_double(body: str) -> str:
    named = {v: k for k, v in _ESCAPES.items()}
    out, i = [], 0
    while i < len(body):
        ch = body[i]
        if ch != "\\":
            out.append(ch)
            i += 1
            continue
        code = body[i + 1]
        width = {"x": 2, "u": 4, "U": 8}.get(code)
        if width:
            out.append(chr(int(body[i + 2:i + 2 + width], 16)))
            i += 2 + width
        else:
            out.append(named[code])
            i += 2
    return "".join(out)


def _scalar_value(text: str):
    """The value of one scalar's text (comments already stripped)."""
    text = text.strip()
    if len(text) >= 2 and text[0] == text[-1] == "'":
        return text[1:-1].replace("''", "'")
    if len(text) >= 2 and text[0] == text[-1] == '"':
        return _unquote_double(text[1:-1])
    if text.startswith("[") and text.endswith("]"):
        inner = text[1:-1].strip()
        return [_scalar_value(x) for x in inner.split(",")] if inner else []
    if text == "{}":
        return {}
    return _resolve_plain(text)


def _strip_comment(line: str) -> str:
    """line without a trailing '# ...' comment (a '#' after whitespace,
    outside quotes)."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and (i == 0 or line[i - 1] in " [,:"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _load_yaml(text: str) -> dict:
    """The mapping of a config file in the form _dump_yaml writes (also
    flow lists, comments and folded lines): {section: {key: value}}; a
    'key:' with nothing after it is null unless '- item' lines follow."""
    out: dict = {}
    section = None
    pending = None              # [section dict, key, text, indent] of a
                                # scalar, which folded lines extend
    listed = None               # (section dict, key) a '- item' extends

    def flush():
        nonlocal pending
        if pending is not None:
            target, k, raw, _ = pending
            target[k] = _scalar_value(raw)
            pending = None

    for raw_line in text.splitlines():
        line = _strip_comment(raw_line)
        body = line.strip()
        if not body or body in ("---", "..."):
            continue
        if not line.startswith(" "):
            flush()
            name, _, rest = body.partition(":")
            section, listed = name.strip(), None
            out[section] = _scalar_value(rest) if rest.strip() else {}
            continue
        indent = len(line) - len(line.lstrip())
        if body.startswith("- ") or body == "-":
            flush()
            if listed is None:
                raise ValueError(f"a list item under no key: {raw_line!r}")
            target, k = listed
            if target[k] is None:
                target[k] = []
            target[k].append(_scalar_value(body[1:]))
            continue
        m = re.match(r"^([A-Za-z_][A-Za-z0-9_]*):(?:\s(.*))?$", body)
        if m and (pending is None or indent <= pending[3]):
            flush()
            key, rest = m.group(1), (m.group(2) or "").strip()
            if rest:
                pending = [out[section], key, rest, indent]
                listed = None
            else:
                out[section][key] = None
                listed = (out[section], key)
            continue
        if pending is None:
            raise ValueError(f"cannot read config line {raw_line!r}")
        pending[2] += " " + body                # a folded line
    flush()
    return out


# --- command line ---------------------------------------------------------

def config_parser() -> argparse.ArgumentParser:
    """The JAX package's flags (fsnerf_tpu/config.py::config_parser: same
    names, defaults and destinations), and the port's own --hw and
    --device.

    allow_abbrev=False: a prefix abbreviation (`--n_iter` for `--n_iters`)
    would be parsed but missed by _explicit_flags's exact scan, so with
    --config it would silently fail to override the file."""
    p = argparse.ArgumentParser(
        description="Train a NeRF or SiNeRF on a scene's K-means training "
                    "views and render its val and test views and camera "
                    "path, or render them from a checkpoint or given "
                    "weights (PyTorch + CUDA port).", allow_abbrev=False)
    g = p.add_argument_group("encoder")
    g.add_argument("--d_input", default=3, type=int)
    g.add_argument("--n_freqs", default=10, type=int)
    g.add_argument("--linear_freqs", action="store_true",
                   help="Use linearly spaced frequencies (default: "
                        "log-spaced)")
    g.add_argument("--no_dirs", action="store_true")
    g.add_argument("--n_freqs_views", default=4, type=int)
    g.add_argument("--freq_reg_end", default=0, type=int,
                   help="FreeNeRF: steps over which the frequency masks "
                        "anneal (0 = off)")

    g = p.add_argument_group("model")
    g.add_argument("--model", choices=["nerf", "sinerf"], default="nerf")
    g.add_argument("--d_filter", default=256, type=int)
    g.add_argument("--n_layers", default=8, type=int)
    g.add_argument("--skip", default="4", type=str,
                   help="Comma-separated skip-connection layer indices")
    g.add_argument("--density_activation",
                   choices=["none", "relu", "trunc_exp"], default="none")
    g.add_argument("--fused_kernel", action="store_true", default=None,
                   help="train and render through the fused MLP kernels "
                        "(their plain versions on the CPU; default: on for "
                        "CUDA devices only)")
    g.add_argument("--no_fused_kernel", action="store_true",
                   help="train and render through the module")
    g.add_argument("--no_fused_save_acts", action="store_false",
                   dest="fused_save_acts", default=True,
                   help="the NeRF train backward recomputes the trunk "
                        "instead of reading the saved activations (bitwise "
                        "equal gradients)")
    g.add_argument("--no_fused_encode", action="store_false",
                   dest="fused_encode", default=True,
                   help="carried for the JAX package; the port always "
                        "encodes inside its kernels")
    g.add_argument("--no_fused_render", action="store_true",
                   help="render without the fused ray-march kernel")

    g = p.add_argument_group("data")
    g.add_argument("--dataset",
                   choices=["synthetic", "llff", "sphere", "lattice"],
                   default="synthetic",
                   help="a Blender scene, an LLFF scene (NDC rays, 4 grid "
                        "levels) or a procedural scene")
    g.add_argument("--scene", default="lego", type=str,
                   help="scene directory under <data_root>/synthetic or "
                        "<data_root>/llff")
    g.add_argument("--n_imgs", default=100, type=int, help="training views")
    g.add_argument("--white_bkgd", action="store_true")
    g.add_argument("--factor", default=8, type=int,
                   help="LLFF: read images_<factor>/, focal / factor")
    g.add_argument("--bd_factor", default=0.75, type=float,
                   help="LLFF: scale the scene so the nearest bound sits at "
                        "1 / bd_factor")
    g.add_argument("--no_recenter", action="store_true",
                   help="LLFF: keep the poses' own frame")
    g.add_argument("--data_root", default="../datasets", type=str)
    g.add_argument("--downsample", default=1, type=int,
                   help="Blender: box-filter the images by this factor")
    g.add_argument("--hw", type=int, default=64,
                   help="image side of the procedural scenes (the port's)")

    g = p.add_argument_group("sampling")
    g.add_argument("--strategy", choices=["occgrid", "hierarchical"],
                   default="occgrid")
    g.add_argument("--n_samples", default=512, type=int,
                   help="occgrid lattice samples, or hierarchical coarse "
                        "samples")
    g.add_argument("--n_fine", default=128, type=int,
                   help="hierarchical inverse-CDF samples")
    g.add_argument("--render_step_size", default=5e-3, type=float)
    g.add_argument("--grid_resolution", default=128, type=int)
    g.add_argument("--occ_thre", default=1e-2, type=float)
    g.add_argument("--n_compact", default=192, type=int)
    g.add_argument("--compact_margin", default=1.0, type=float)
    g.add_argument("--no_adapt_compact", action="store_true",
                   help="Disable the adaptive compaction-K ladder")
    g.add_argument("--no_async_ladder", action="store_false",
                   dest="async_ladder", default=None,
                   help="carried for the JAX package; the port captures a "
                        "new K's graphs synchronously")
    g.add_argument("--early_stop_eps", default=1e-4, type=float)
    g.add_argument("--query_stride", default=0, type=int,
                   help="Occupancy-query sample stride (0 = auto)")
    g.add_argument("--query_dilation", default=None, type=int,
                   help="Query-table dilation radius (default: auto)")
    g.add_argument("--query_max_stride", default=0, type=int,
                   help="Cap for the auto query stride (0 = 8)")
    g.add_argument("--update_interval", default=16, type=int,
                   help="Occupancy-grid refresh interval")
    g.add_argument("--update_interval_late", default=64, type=int,
                   help="Refresh interval after the grid converges "
                        "(0 = keep update_interval for the whole run)")
    g.add_argument("--update_interval_late_start", default=1024, type=int)
    g.add_argument("--grid_hold_steps", default=-1, type=int,
                   help="keep every grid cell occupied until this step; "
                        "-1 = auto (freq_reg_end when annealing)")

    g = p.add_argument_group("training")
    g.add_argument("--n_iters", default=20**3, type=int)
    g.add_argument("--batch_size", default=1024, type=int)
    g.add_argument("--lro", default=5e-4, type=float)
    g.add_argument("--decay_rate", default=0.1, type=float)
    g.add_argument("--Td", default=250000, type=int)
    g.add_argument("--scheduler", choices=["const", "exp"], default="exp")
    g.add_argument("--seed", default=42, type=int)
    g.add_argument("--dtype", choices=["float32", "bfloat16"],
                   default="bfloat16", help="the module's compute dtype")
    g.add_argument("--halt_on_divergence", action="store_true",
                   help="Stop training when the divergence guard trips on a "
                        "train-PSNR collapse (a non-finite loss always "
                        "halts)")
    g.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu, where the kernels' "
                        "plain versions run (the port's)")

    g = p.add_argument_group("parallel")
    g.add_argument("--n_devices", default=0, type=int,
                   help="Data-parallel ranks (0 = the whole process group; "
                        "it must equal the group's size)")
    g.add_argument("--distributed", action="store_true",
                   help="Join the process group torchrun describes "
                        "(one process per GPU) before any CUDA call")

    g = p.add_argument_group("validation")
    g.add_argument("--val", action="store_true",
                   help="render the first held-out view every --val_rate "
                        "steps and log its PSNR/SSIM")
    g.add_argument("--val_rate", default=500, type=int)
    g.add_argument("--val_ratio", default=0.15, type=float,
                   help="Fraction of views K-means-selected for validation")
    g.add_argument("--test_ratio", default=0.15, type=float,
                   help="Fraction of views K-means-selected for the test "
                        "split (selected before val)")

    g = p.add_argument_group("regularizers")
    g.add_argument("--ao", default=None, type=float,
                   help="weight regularizer's alpha (off when not given)")
    g.add_argument("--reg_ratio", default=0.5, type=float,
                   help="the weight regularizer runs while step < "
                        "reg_ratio * Td")
    g.add_argument("--reg", choices=["l1", "l2"], default="l1")
    g.add_argument("--a", default=None, type=float,
                   help="occlusion regularizer's amplitude")
    g.add_argument("--b", default=None, type=float,
                   help="occlusion regularizer's decay")
    g.add_argument("--func", choices=["linear", "exp"], default="linear",
                   help="occlusion regularizer's weighting")
    g.add_argument("--beta", default=None, type=float,
                   help="turns the occlusion regularizer on (it gates the "
                        "term and does not scale it)")

    g = p.add_argument_group("logging")
    g.add_argument("--out_dir", default="../out/", type=str,
                   help="runs write under <out_dir>/<model>/<dataset>/"
                        "<scene>/n_imgs_<n>")
    g.add_argument("--use_wandb", action="store_true")
    g.add_argument("--ckpt_every", default=0, type=int,
                   help="checkpoint every this many steps (0 = only at the "
                        "end)")
    g.add_argument("--resume", action="store_true",
                   help="continue from the run directory's latest "
                        "checkpoint")
    g.add_argument("--import_torch_ckpt", default=None, type=str,
                   help="reference nn.pt state dict to initialize/render "
                        "from")
    g.add_argument("--export_render", default="", type=str,
                   help="the JAX package's serving artifact: not ported, "
                        "refused")

    g = p.add_argument_group("debugging")
    g.add_argument("--debug", action="store_true",
                   help="write nothing (no run directory)")
    g.add_argument("--render_only", action="store_true",
                   help="skip training: render from the run directory's "
                        "latest checkpoint, else from --import_torch_ckpt "
                        "weights (or the seeded init)")

    g = p.add_argument_group("config-file")
    g.add_argument("--config", default=None, type=str,
                   help="YAML config file (flags given override it)")
    return p


# argparse dest -> (config section, field). Flags not listed here need
# special handling (skip, linear_freqs, no_adapt_compact, no_fused_render,
# no_fused_kernel) or are not config fields (--config, --hw, --device).
_FLAG_MAP = {
    "d_input": ("encoder", "d_input"),
    "n_freqs": ("encoder", "n_freqs"),
    "n_freqs_views": ("encoder", "n_freqs_views"),
    "no_dirs": ("encoder", "no_dirs"),
    "freq_reg_end": ("encoder", "freq_reg_end"),
    "model": ("model", "model"),
    "d_filter": ("model", "d_filter"),
    "n_layers": ("model", "n_layers"),
    "density_activation": ("model", "density_activation"),
    "fused_kernel": ("model", "fused_kernel"),
    "fused_save_acts": ("model", "fused_save_acts"),
    "fused_encode": ("model", "fused_encode"),
    "dataset": ("data", "dataset"),
    "scene": ("data", "scene"),
    "n_imgs": ("data", "n_imgs"),
    "white_bkgd": ("data", "white_bkgd"),
    "factor": ("data", "factor"),
    "bd_factor": ("data", "bd_factor"),
    "no_recenter": ("data", "no_recenter"),
    "data_root": ("data", "data_root"),
    "downsample": ("data", "downsample"),
    "strategy": ("sampling", "strategy"),
    "n_samples": ("sampling", "n_samples"),
    "n_fine": ("sampling", "n_fine"),
    "render_step_size": ("sampling", "render_step_size"),
    "grid_resolution": ("sampling", "grid_resolution"),
    "occ_thre": ("sampling", "occ_thre"),
    "n_compact": ("sampling", "n_compact"),
    "compact_margin": ("sampling", "compact_margin"),
    "early_stop_eps": ("sampling", "early_stop_eps"),
    "query_stride": ("sampling", "query_stride"),
    "query_dilation": ("sampling", "query_dilation"),
    "query_max_stride": ("sampling", "query_max_stride"),
    "update_interval": ("sampling", "update_interval"),
    "update_interval_late": ("sampling", "update_interval_late"),
    "update_interval_late_start": ("sampling", "update_interval_late_start"),
    "grid_hold_steps": ("sampling", "grid_hold_steps"),
    "n_iters": ("train", "n_iters"),
    "batch_size": ("train", "batch_size"),
    "lro": ("train", "lro"),
    "decay_rate": ("train", "decay_rate"),
    "Td": ("train", "Td"),
    "scheduler": ("train", "scheduler"),
    "seed": ("train", "seed"),
    "dtype": ("train", "dtype"),
    "ao": ("train", "ao"),
    "reg_ratio": ("train", "reg_ratio"),
    "reg": ("train", "reg"),
    "a": ("train", "occ_a"),
    "b": ("train", "occ_b"),
    "func": ("train", "occ_func"),
    "beta": ("train", "beta"),
    "val": ("train", "val"),
    "val_rate": ("train", "val_rate"),
    "val_ratio": ("data", "val_ratio"),
    "test_ratio": ("data", "test_ratio"),
    "ckpt_every": ("train", "ckpt_every"),
    "resume": ("train", "resume"),
    "import_torch_ckpt": ("train", "import_torch_ckpt"),
    "async_ladder": ("train", "async_ladder"),
    "halt_on_divergence": ("train", "halt_on_divergence"),
    "n_devices": ("parallel", "n_devices"),
    "distributed": ("parallel", "distributed"),
    "out_dir": ("log", "out_dir"),
    "debug": ("log", "debug"),
    "render_only": ("log", "render_only"),
    "use_wandb": ("log", "use_wandb"),
    "export_render": ("log", "export_render"),
}


def config_from_args(argv=None) -> Config:
    """Command line (+ --config YAML) -> Config, by the JAX package's rules.

    The flags' values are merged into the base config section by section,
    so fields without a flag (ema_decay, warmup_steps, ...) survive a
    --config round trip. With a config file only the flags present on the
    command line override it; without one every parser value applies (they
    equal the dataclass defaults). grid_levels, which has no flag, comes
    from the dataset (4 for LLFF, else 1) unless the file pins it."""
    parser = config_parser()
    args = parser.parse_args(argv)
    raw = None
    if args.config:
        with open(args.config) as fh:
            raw = _load_yaml(fh.read()) or {}
    base = Config.from_dict(raw) if raw is not None else Config()
    explicit = _explicit_flags(parser, argv)
    use_all = args.config is None

    overrides: dict = {}
    for dest, (section, fname) in _FLAG_MAP.items():
        if use_all or dest in explicit:
            overrides.setdefault(section, {})[fname] = getattr(args, dest)
    if use_all or "linear_freqs" in explicit:
        overrides.setdefault("encoder", {})["log_space"] = \
            not args.linear_freqs
    if use_all or "skip" in explicit:
        overrides.setdefault("model", {})["skip"] = tuple(
            int(s) for s in str(args.skip).split(",") if s != "")
    if use_all or "no_adapt_compact" in explicit:
        overrides.setdefault("sampling", {})["adapt_compact"] = \
            not args.no_adapt_compact
    if use_all or "no_fused_render" in explicit:
        overrides.setdefault("model", {})["fused_render"] = \
            not args.no_fused_render
    if args.no_fused_kernel:
        overrides.setdefault("model", {})["fused_kernel"] = False

    pinned = bool(raw and "grid_levels" in (raw.get("sampling") or {}))
    if not pinned:
        ds = overrides.get("data", {}).get("dataset", base.data.dataset)
        overrides.setdefault("sampling", {})["grid_levels"] = \
            4 if ds == "llff" else 1

    return base.replace(**{
        name: dataclasses.replace(getattr(base, name), **ov)
        for name, ov in overrides.items()})


def _explicit_flags(parser, argv) -> set:
    """Destinations of the flags present on the command line."""
    tokens = list(sys.argv[1:] if argv is None else argv)
    names = set()
    for action in parser._actions:
        for opt in action.option_strings:
            if any(t == opt or t.startswith(opt + "=") for t in tokens):
                names.add(action.dest)
    return names
