"""Configuration system.

Counterpart of `ht3dgs.utils.config`, field for field: the three parameter
groups `ModelParams` / `PipelineParams` / `OptimizationParams` with YAML
overrides, CLI flags over YAML, the same defaults. Equal configurations
give equal field reprs, so a breadcrumb's config fingerprint is the same in
both packages. The YAML files are read by `load_yaml`, a parser of the
subset that config files use, so no YAML library is needed.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import re
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class ModelConfig:
    sh_degree: int = 3
    source_path: str = ""
    model_path: str = ""
    pose_path: str = ""
    images: str = "images"
    resolution: int = -1
    white_background: bool = False
    eval: bool = True
    view_dependent: bool = True
    depth_model_type: str = "dpt"
    mode: str = "train"
    traj_opt: str = "bspline"
    # FoV for images_only data (arguments/full/Tanks/*.yml)
    FovX: Optional[float] = None
    FovY: Optional[float] = None
    data_path_train: str = ""
    data_type_train: str = "images_only"
    data_path_eval: str = ""
    data_type_eval: str = "colmap"
    expname: str = "default"
    category: str = ""
    seq_name: str = ""
    data_type: str = "images_only"   # resolved from mode at load time
    test_sample_rate: Optional[int] = None
    #   train/test split stride. None = reference quirk: 2 if "Family"
    #   appears in the data path else 8 (dataset_readers.py:424-427) —
    #   set explicitly for any directory that happens to contain "Family"


@dataclass
class PipelineConfig:
    convert_SHs_python: bool = False
    compute_cov3D_python: bool = False
    debug: bool = False
    init_mode: str = "rand"
    use_mono: bool = True
    use_mask: bool = False
    load_pose: Optional[str] = None
    train_mode: str = "hierarchical_training"
    train_level: int = 2
    partition_strategy: str = "v1"
    train_pose_mode: Optional[str] = "vfi"
    multi_source_supervision: str = "base+vfi"
    prune_ratio: float = 0.5
    # --- framework knobs (no reference counterpart) ---
    render_mode: str = "auto"          # oracle | tiled | pallas | auto
    depth_provider: str = "constant"   # constant | precomputed | dpt | zoe
    depth_dir: Optional[str] = None
    vfi_provider: str = "blend"        # none | blend | precomputed | ifrnet
    vfi_dir: Optional[str] = None
    vfi_checkpoint: Optional[str] = None
    mesh_segments: int = 1             # data-parallel segment axis size
    mesh_tiles: int = 1                # tile-sharding axis size
    tile_compact_frac: Optional[float] = None
    #   when tile-sharded (mesh_tiles > 1): per-chip block cull-compaction
    #   capacity as a fraction of state capacity per tile shard, e.g. 2.0
    #   -> compact_n = 2*cap/n_tiles (raster.tiled compact_n; makes the
    #   per-chip binning cost divide; auto-grows on drops)
    distributed: bool = False          # torch.distributed init (run.py)
    capacity_presize: float = 4.0      # parallel leaves: init-pcd capacity
    #                                    headroom (avoids mid-run recompiles)
    trace_dir: Optional[str] = None    # profiler trace capture dir
    init_max_points: int = 0           # cap per-frame init pcd size (0 = off)
    phase_a_batch: int = 8             # >0: vmap-batch relative-pose pairs
    pose_c2f: bool = False             # coarse-to-fine Phase A pose fits
                                       # (ht3dgs improvement; off =
                                       # reference parity)
    tile_max_per_tile: int = 0         # preset binning K (0 = renderer
    tile_dup_factor: int = 0           # default); avoids auto-grow
    #                                    recompiles on known-dense scenes
    eval_nvs_exec_chunk: int = 0       # iters per device execution in the
    #   eval_nvs test-time pose fit (0 = phase_a.EXEC_CHUNK); lower it for
    #   big models on the remote service (execution-length kill threshold)
    eval_nvs_batch: int = 16           # frames per batched test-time
    #                                    pose-fit chunk (device-memory bound)


@dataclass
class OptimizationConfig:
    iterations: int = 30_000
    single_step: int = 300
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    # Phase A pose-fit LR; None = rotation_lr (reference parity,
    # gaussian_model_ht.py:321-342 uses rotation_lr for the SE3 tangent)
    pose_lr: Optional[float] = None
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    lambda_depth: float = 0.0
    depth_loss_type: str = "invariant"
    densification_interval: int = 100
    densification_interval_leaf: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    reset_until_iter: int = 15_000
    densify_grad_threshold: float = 0.0002
    num_iterations_per_frame_each_level: List[int] = field(
        default_factory=lambda: [300, 300, 300])
    mss_phase1_iteration_per_frame: int = 50
    mss_phase1_densification_interval: Optional[int] = 100
    mss_phase1_densify_until_iter_ratio: Optional[float] = None
    mss_phase1_ratio: float = 0.5
    mss_phase2_densification_interval: int = 100
    mss_phase2_densify_until_iter_ratio: Optional[float] = None
    mss_phase2_ratio: float = 0.5
    # iteration budgets the reference hardcodes (1000/300/1000/500 at
    # ht3dgs_trainer.py:359,369,203,529) — exposed so tests and fast runs
    # can scale them down
    phase_a_fit_iters: int = 1000
    phase_a_pose_iters: int = 300
    leaf_init_iters: int = 1000
    reset_recovery_iters: int = 500
    eval_nvs_epochs: int = 200
    # Toy-scale schedule correction (None = reference parity). The reference
    # derives opacity_reset_interval = num_iterations//10
    # (ht3dgs_trainer.py:678), which at T&T scale (seq_len ~300,
    # single_step 300 -> interval 9000) means a leaf (~6000 iters) never
    # resets and a merged model resets ~once per phase-2 budget with
    # thousands of recovery iters. At benchmark scale (seq_len 10-16) the
    # same formula fires resets every ~single_step iters — every model
    # spends its whole life inside the reset/recovery thrash, a regime no
    # reference configuration ever enters. Setting this override restores
    # the reference's reset-to-budget *structure* on small runs.
    opacity_reset_interval_override: Optional[int] = None


_SECTION_TO_CLS = {
    "ModelParams": ModelConfig,
    "PipelineParams": PipelineConfig,
    "OptimizationParams": OptimizationConfig,
}


def load_configs(yaml_path: Optional[str] = None, overrides=None):
    """Returns (model_cfg, pipe_cfg, optim_cfg)."""
    model, pipe, optim = ModelConfig(), PipelineConfig(), OptimizationConfig()
    groups = {"ModelParams": model, "PipelineParams": pipe,
              "OptimizationParams": optim}
    if yaml_path:
        with open(yaml_path) as f:
            doc = load_yaml(f.read()) or {}
        for section, values in doc.items():
            tgt = groups.get(section)
            if tgt is None or not isinstance(values, dict):
                continue
            for k, v in values.items():
                if hasattr(tgt, k):
                    setattr(tgt, k, v)
                # unknown keys ignored (reference setattr's everything; we
                # stay strict to catch typos in *our* configs but tolerate
                # reference-era vestigial knobs)
    for k, v in (overrides or {}).items():
        for tgt in groups.values():
            if hasattr(tgt, k):
                setattr(tgt, k, v)
    return model, pipe, optim


def resolve_mode_paths(model: ModelConfig, mode: str) -> str:
    """Train vs eval data selection (run.py:35-41)."""
    model.mode = mode
    if mode == "train" or not model.data_path_eval:
        model.source_path = model.data_path_train or model.source_path
        model.data_type = model.data_type_train
    else:
        model.source_path = model.data_path_eval or model.source_path
        model.data_type = model.data_type_eval
    return model.source_path


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="ht3dgs_torch — SfM-free "
                                "hierarchical 3DGS on one NVIDIA GPU")
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--mode", type=str, default="train",
                   choices=["train", "eval_pose", "eval_nvs", "render",
                            "pose_only"])
    for cls in (ModelConfig, PipelineConfig, OptimizationConfig):
        for f in dataclasses.fields(cls):
            name = "--" + f.name
            if any(a.dest == f.name for a in p._actions):
                continue
            if f.type == bool or isinstance(f.default, bool):
                # BooleanOptionalAction gives --flag / --no-flag pairs so
                # default-True fields (eval, view_dependent, ...) can be
                # disabled from the CLI
                p.add_argument(name, default=None,
                               action=argparse.BooleanOptionalAction)
            else:
                p.add_argument(name, default=None, type=str)
    return p


def configs_from_cli(argv=None):
    p = build_argparser()
    args = p.parse_args(argv)
    overrides = {}
    for k, v in vars(args).items():
        if k in ("config", "mode") or v is None:
            continue
        overrides[k] = _coerce(k, v)
    model, pipe, optim = load_configs(args.config, overrides)
    resolve_mode_paths(model, args.mode)
    return model, pipe, optim, args


def _coerce(key: str, value):
    for cls in (ModelConfig, PipelineConfig, OptimizationConfig):
        for f in dataclasses.fields(cls):
            if f.name == key and isinstance(value, str):
                # `from __future__ import annotations` makes f.type a
                # string; match Optional[...] variants too (e.g. FovX)
                t = str(f.type)
                if t.startswith("List"):
                    # a flow sequence, as in a config file: "[25, 25, 25]"
                    # (the JAX package keeps the string, which its trainer
                    # cannot index)
                    parsed = load_yaml(f"v: {value}\n")["v"]
                    if not isinstance(parsed, list):
                        raise ValueError(f"--{key} takes a list such as "
                                         f"[300, 300, 300], got {value!r}")
                    return parsed
                if "float" in t or isinstance(f.default, float):
                    return float(value)
                if "int" in t or (isinstance(f.default, int)
                                  and not isinstance(f.default, bool)):
                    return int(value)
    return value


# ---------------------------------------------------------------------------
# YAML subset
# ---------------------------------------------------------------------------
#
# `load_yaml` reads what config files use: comments; block mappings nested
# by indentation; block sequences (`- x`) and flow sequences (`[1, 2, 3]`);
# plain, single-quoted and double-quoted scalars on one line. Plain scalars
# resolve as PyYAML's `safe_load` resolves them (YAML 1.1): `1e-4` stays a
# string (a float needs a dot, and an exponent needs a sign), yes/No/on/OFF
# are bools, `~`/null/empty are None, 0x1F, 017 and sexagesimal 1:30 are
# ints, .inf and .nan are floats. Anything else (anchors, aliases, tags,
# block scalars, flow mappings, complex keys, merge keys, dates and
# timestamps, binary ints, base-60 floats, escapes other than \\ and \"
# in double quotes, several documents) raises ValueError with its line
# number rather than being read some other way.

_BOOL = {"yes": True, "true": True, "on": True,
         "no": False, "false": False, "off": False}
_RESOLVERS = (   # (first characters, regex, kind), tried in PyYAML's order
    ("yYnNtTfFoO", re.compile(
        r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
        r"|on|On|ON|off|Off|OFF)$"), "bool"),
    ("-+0123456789.", re.compile(
        r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
        r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
        r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
        r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$"), "float"),
    ("-+0123456789", re.compile(
        r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
        r"|[-+]?0x[0-9a-fA-F_]+|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$"),
     "int"),
    ("<", re.compile(r"^(?:<<)$"), "merge"),
    ("~nN", re.compile(r"^(?:~|null|Null|NULL)$"), "null"),
    ("0123456789", re.compile(r"^[0-9]{4}-[0-9]{2}-[0-9]{2}$"), "timestamp"),
    ("0123456789", re.compile(
        r"^[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}(?:[Tt]|[ \t]+)[0-9]{1,2}"
        r":[0-9]{2}:[0-9]{2}(?:\.[0-9]*)?"
        r"(?:[ \t]*(?:Z|[-+][0-9]{1,2}(?::[0-9]{2})?))?$"), "timestamp"),
    ("=", re.compile(r"^(?:=)$"), "value"),
)


class _YamlError(ValueError):
    def __init__(self, lineno: int, msg: str):
        super().__init__(f"YAML line {lineno}: {msg}")


def _resolve(text: str, lineno: int):
    """A plain scalar's value, as PyYAML's SafeLoader gives it."""
    for first, rx, kind in _RESOLVERS:
        if text[:1] not in first or not rx.match(text):
            continue
        if kind == "bool":
            return _BOOL[text.lower()]
        if kind == "null":
            return None
        if kind in ("merge", "value", "timestamp") \
                or (kind == "float" and ":" in text) \
                or (kind == "int" and "0b" in text):
            raise _YamlError(lineno, f"{kind} scalar {text!r} is not "
                             "supported")
        v = text.replace("_", "")
        sign = -1 if v[:1] == "-" else 1
        if v[:1] in "+-":
            v = v[1:]
        if kind == "float":
            low = v.lower()
            if low == ".inf":
                return sign * math.inf
            if low == ".nan":
                return math.nan
            return sign * float(v)
        if v == "0":
            return 0
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if v[0] == "0":
            return sign * int(v, 8)
        if ":" in v:    # base 60
            return sign * sum(int(part) * 60 ** i for i, part
                              in enumerate(reversed(v.split(":"))))
        return sign * int(v)
    return text


def _quoted(text: str, i: int, lineno: int):
    """The quoted scalar that starts at text[i]: (value, index past it)."""
    q, out, j = text[i], [], i + 1
    while j < len(text):
        c = text[j]
        if q == "'":
            if c == "'":
                if text[j + 1:j + 2] == "'":
                    out.append("'")
                    j += 2
                    continue
                return "".join(out), j + 1
        elif c == '"':
            return "".join(out), j + 1
        elif c == "\\":
            e = text[j + 1:j + 2]
            if e not in ('"', "\\"):
                raise _YamlError(lineno, f"escape \\{e} in a double-quoted "
                                 "scalar is not supported")
            out.append(e)
            j += 2
            continue
        out.append(c)
        j += 1
    raise _YamlError(lineno, "a quoted scalar must end on its line")


_INDICATORS = {"&": "anchors", "*": "aliases", "!": "tags",
               "|": "block scalars", ">": "block scalars",
               "{": "flow mappings", "%": "directives",
               "@": "reserved indicators", "`": "reserved indicators"}


def _refuse_indicator(text: str, lineno: int) -> None:
    c = text[:1]
    if c in _INDICATORS:
        raise _YamlError(lineno, f"{_INDICATORS[c]} are not supported")
    if c == "?" and text[1:2] in ("", " "):
        raise _YamlError(lineno, "complex keys are not supported")


def _flow_sequence(text: str, i: int, lineno: int):
    """The flow sequence that starts at text[i] == '[': (list, index past
    its ']')."""
    items, j, expect_item = [], i + 1, True
    while True:
        while j < len(text) and text[j] == " ":
            j += 1
        if j >= len(text):
            raise _YamlError(lineno, "a flow sequence must end on its line")
        c = text[j]
        if c == "]":
            return items, j + 1
        if c == ",":
            if expect_item:
                raise _YamlError(lineno, "empty entry in a flow sequence")
            expect_item = True
            j += 1
            continue
        if not expect_item:
            raise _YamlError(lineno, "',' expected in a flow sequence")
        if c == "[":
            value, j = _flow_sequence(text, j, lineno)
        elif c in "'\"":
            value, j = _quoted(text, j, lineno)
        else:
            _refuse_indicator(text[j:], lineno)
            m = re.compile(r"[^,\[\]{}]*").match(text, j)
            raw = m.group(0).rstrip()
            if ": " in raw or raw.endswith(":"):
                raise _YamlError(lineno, "flow mappings are not supported")
            value, j = _resolve(raw, lineno), j + len(raw)
        items.append(value)
        expect_item = False


def _inline(text: str, lineno: int):
    """A value written on the line of its key or '-': a scalar or a flow
    sequence."""
    _refuse_indicator(text, lineno)
    if text[0] == "[":
        value, end = _flow_sequence(text, 0, lineno)
    elif text[0] in "'\"":
        value, end = _quoted(text, 0, lineno)
    else:
        if ": " in text or text.endswith(":"):
            raise _YamlError(lineno, "a mapping value is not allowed here")
        if text[:2] == "- " or text == "-":
            raise _YamlError(lineno, "a sequence is not allowed here")
        return _resolve(text, lineno)
    if text[end:].strip():
        raise _YamlError(lineno, f"unexpected text after the value: "
                         f"{text[end:].strip()!r}")
    return value


def _strip_comment(line: str) -> str:
    """The line without its comment: '#' at its start or after a blank,
    outside quotes."""
    quote = None
    for j, c in enumerate(line):
        if quote:
            if c == quote:
                quote = None
        elif c in "'\"" and (j == 0 or line[j - 1] in " [,:-"):
            quote = c
        elif c == "#" and (j == 0 or line[j - 1] in " \t"):
            return line[:j]
    return line


def _split_key(text: str, lineno: int):
    """(key, rest) of a mapping entry 'key: rest', or None if the text is
    not one."""
    if text[0] in "'\"":
        key, j = _quoted(text, 0, lineno)
        rest = text[j:]
        if not rest.startswith(":") or rest[1:2] not in ("", " "):
            return None
        return key, rest[1:].strip()
    m = re.search(r":(?: |$)", text)
    if m is None:
        return None
    raw = text[:m.start()].rstrip()
    _refuse_indicator(raw, lineno)
    if raw[:1] in "[":
        raise _YamlError(lineno, "flow collections as keys are not "
                         "supported")
    return _resolve(raw, lineno), text[m.end():].strip()


def _is_seq_entry(text: str) -> bool:
    return text == "-" or text.startswith("- ")


def load_yaml(text: str):
    """The document of a config file, as `yaml.safe_load` reads it, for the
    subset described above."""
    lines = []   # (line number, indentation, content)
    for lineno, line in enumerate(text.splitlines(), 1):
        body = _strip_comment(line).rstrip()
        if not body.strip():
            continue
        content = body.lstrip(" ")
        if content[0] == "\t":
            raise _YamlError(lineno, "tabs may not indent")
        indent = len(body) - len(content)
        if indent == 0 and content in ("---", "...") or \
                content.startswith("--- "):
            if lines or content != "---":
                raise _YamlError(lineno, "only one document is supported")
            continue
        lines.append((lineno, indent, content))
    if not lines:
        return None
    pos = 0

    def block(indent: int):
        nonlocal pos
        lineno, ind, content = lines[pos]
        _refuse_indicator(content, lineno)
        if _is_seq_entry(content):
            return sequence(ind)
        if _split_key(content, lineno) is not None:
            return mapping(ind)
        pos += 1
        if pos < len(lines):
            raise _YamlError(lines[pos][0], "a scalar must stand alone on "
                             "one line")
        return _inline(content, lineno)

    def nested(parent: int, lineno: int, allow_seq_at_parent: bool):
        """The value of an entry whose line ends after its key or '-'."""
        if pos >= len(lines):
            return None
        _, ind, content = lines[pos]
        if ind > parent:
            return block(ind)
        if ind == parent and allow_seq_at_parent and _is_seq_entry(content):
            return sequence(ind)
        return None

    def mapping(indent: int):
        nonlocal pos
        out = {}
        while pos < len(lines) and lines[pos][1] >= indent:
            lineno, ind, content = lines[pos]
            if ind != indent:
                raise _YamlError(lineno, "bad indentation")
            kv = _split_key(content, lineno)
            if kv is None:
                raise _YamlError(lineno, f"expected 'key: value', got "
                                 f"{content!r}")
            key, rest = kv
            pos += 1
            out[key] = (_inline(rest, lineno) if rest
                        else nested(indent, lineno, True))
        return out

    def sequence(indent: int):
        nonlocal pos
        out = []
        while pos < len(lines) and lines[pos][1] >= indent:
            lineno, ind, content = lines[pos]
            if ind != indent or not _is_seq_entry(content):
                raise _YamlError(lineno, "bad indentation or a sequence "
                                 "entry expected")
            rest = content[1:].strip()
            pos += 1
            if not rest:
                out.append(nested(indent, lineno, False))
            elif _is_seq_entry(rest) or _split_key(rest, lineno):
                raise _YamlError(lineno, "a collection on the line of its "
                                 "'-' is not supported")
            else:
                out.append(_inline(rest, lineno))
        return out

    doc = block(lines[0][1])
    if pos < len(lines):
        raise _YamlError(lines[pos][0], "bad indentation")
    return doc
