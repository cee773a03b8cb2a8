"""Experiment-config YAML serialization (port of witw_tpu/configs/serialize.py).

``config_to_dict`` / ``config_from_dict`` / ``save_config`` / ``load_config``
over the port's copy of the config tree. The port does not depend on
PyYAML: it writes and reads the YAML subset that
``yaml.safe_dump(tree, sort_keys=False)`` produces for such a tree (block
mappings, block lists, and one-line str, int, float, bool and null
scalars), so a file that either package writes loads in the other as the
same config. For the presets the text is the same as PyYAML's, byte for
byte.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
from typing import Any, List, Tuple

from witw_tpu_torch.configs.base import (
    BaselineModelConfig,
    DataConfig,
    DatasetConfig,
    EvalConfig,
    ExperimentConfig,
    FovDsmModelConfig,
    MatchConfig,
    MeshConfig,
    OptimConfig,
    SafaModelConfig,
    TrainConfig,
)

_MODEL_KINDS = {"baseline": BaselineModelConfig, "fov_dsm": FovDsmModelConfig,
                "vgg_safa": SafaModelConfig}


def _to_plain(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj):
        return {f.name: _to_plain(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, tuple):
        return [_to_plain(v) for v in obj]
    return obj


def config_to_dict(cfg: ExperimentConfig) -> dict:
    return _to_plain(cfg)


def config_from_dict(data: dict) -> ExperimentConfig:
    def tup(x):
        return tuple(x) if isinstance(x, list) else x

    ds_d = dict(data["data"]["dataset"])
    for k in ("path_columns", "path_names"):
        ds_d[k] = tup(ds_d.get(k))
    dataset = DatasetConfig(**ds_d)

    data_d = dict(data["data"], dataset=dataset)
    for k in ("img_mean", "img_std"):
        data_d[k] = tup(data_d.get(k))
    data_cfg = DataConfig(**data_d)

    model_d = dict(data["model"])
    model_cls = _MODEL_KINDS[model_d.get("kind", "fov_dsm")]
    if "head_channels" in model_d:
        model_d["head_channels"] = tup(model_d["head_channels"])
    model_cfg = model_cls(**model_d)

    train_d = dict(data["train"])
    train_d["optim"] = OptimConfig(**train_d["optim"])
    train_cfg = TrainConfig(**train_d)

    eval_d = dict(data["eval"])
    eval_d["topk"] = tup(eval_d.get("topk"))
    return ExperimentConfig(
        data=data_cfg,
        model=model_cfg,
        match=MatchConfig(**data["match"]),
        train=train_cfg,
        eval=EvalConfig(**eval_d),
        mesh=MeshConfig(**data["mesh"]),
    )


def save_config(cfg: ExperimentConfig, path: str) -> None:
    with open(path, "w") as f:
        f.write(dump_yaml(config_to_dict(cfg)))


def load_config(path: str) -> ExperimentConfig:
    with open(path) as f:
        return config_from_dict(load_yaml(f.read()))


# ---------------------------------------------------------------------------
# The YAML subset: block mappings with identifier keys, lists of scalars, and
# one-line scalars. A plain scalar is null, a bool, an int, a float or a
# string as PyYAML's SafeLoader (YAML 1.1) reads it; the plain forms YAML
# 1.1 reads in other ways (yes/on/off, 0x1F, 017, 1_000, 1:30, ...) are
# refused, so no file reads differently here than in witw_tpu. The writer
# quotes every string that would not read back as itself.
# ---------------------------------------------------------------------------

_KEY = re.compile(r"([A-Za-z_][A-Za-z0-9_]*):(?: +(.*))?")
_NULL = ("", "~", "null", "Null", "NULL")
_BOOL = {"true": True, "True": True, "TRUE": True, "false": False, "False": False, "FALSE": False}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9]*)")
_FLOAT = re.compile(r"[-+]?[0-9]+\.[0-9]*(?:[eE][-+][0-9]+)?|\.[0-9]+(?:[eE][-+][0-9]+)?")
_INF_NAN = {f"{sign}.{word}": sign_v * math.inf for sign, sign_v in (("", 1), ("+", 1), ("-", -1))
            for word in ("inf", "Inf", "INF")}
_INF_NAN.update({f".{word}": math.nan for word in ("nan", "NaN", "NAN")})
# What else PyYAML's SafeLoader resolves a plain scalar to: YAML 1.1's other
# bools, ints and floats (binary, octal, hex, underscores, base 60),
# timestamps, and the merge and value keys.
_REFUSED = re.compile(
    r"yes|Yes|YES|no|No|NO|on|On|ON|off|Off|OFF"
    r"|[-+]?(?:0b[0-1_]+|0[0-7_]+|[1-9][0-9_]*(?::[0-5]?[0-9])*|0x[0-9a-fA-F_]+)"
    r"|[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
    r"|[0-9]{4}-[0-9]{2}-[0-9]{2}|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}(?:[Tt]|[ \t]+)[0-9]{1,2}:[0-9]{2}"
    r":[0-9]{2}(?:\.[0-9]*)?(?:[ \t]*(?:Z|[-+][0-9]{1,2}(?::[0-9]{2})?))?|<<|=")
# Strings the writer leaves plain: no indicator first, no ': ' or ' #'.
_PLAIN_STR = re.compile(r"[A-Za-z0-9_./~][A-Za-z0-9_./~+=@()'\",-]*(?: [A-Za-z0-9_./~+=@()'\",-]+)*")
# The escapes of PyYAML's double-quoted scalars (what yaml.safe_dump writes
# for a string that is not printable ASCII).
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "n": "\n", "v": "\v", "f": "\f",
            "r": "\r", "e": "\x1b", '"': '"', "\\": "\\", "N": "\x85", "_": "\xa0",
            "L": "\u2028", "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}
_SINGLE = re.compile(r"'((?:[^']|'')*)'(?: +#.*)?")
_DOUBLE = re.compile(r'"((?:[^"\\]|\\.)*)"(?: +#.*)?')


def _resolve_plain(s: str) -> Any:
    if s in _NULL:
        return None
    if s in _BOOL:
        return _BOOL[s]
    if _INT.fullmatch(s):
        return int(s)
    if _FLOAT.fullmatch(s):
        return float(s)
    if s in _INF_NAN:
        return _INF_NAN[s]
    if _REFUSED.fullmatch(s):
        raise ValueError(f"{s!r}: YAML 1.1 reads this plain scalar as another type or value "
                         f"than this reader does; quote it, or write a plain int or float")
    return s


def _reads_as_itself(s: str) -> bool:
    try:
        return _resolve_plain(s) == s
    except ValueError:
        return False


def _scalar_text(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if v != v:
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v).lower()
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)
        return text
    if isinstance(v, str):
        if _PLAIN_STR.fullmatch(v) and _reads_as_itself(v):
            return v
        if v.isprintable():
            return "'" + v.replace("'", "''") + "'"
        return json.dumps(v)  # its escapes are YAML's double-quoted ones
    raise TypeError(f"cannot write {type(v).__name__} {v!r} as a YAML scalar")


def dump_yaml(tree: dict) -> str:
    """``tree`` (str keys; values dicts, lists of scalars or scalars, as in
    a config tree) as block YAML, laid out as
    ``yaml.safe_dump(tree, sort_keys=False)`` lays it out."""
    if not isinstance(tree, dict):
        raise TypeError(f"expected a dict, got {type(tree).__name__}")
    return "\n".join(_block_lines(tree, 0)) + "\n"


def _block_lines(v: Any, indent: int) -> List[str]:
    pad = " " * indent
    lines: List[str] = []
    if isinstance(v, dict):
        for k, child in v.items():
            if not (isinstance(k, str) and _KEY.fullmatch(k + ":")):
                raise TypeError(f"mapping keys must be identifiers, got {k!r}")
            if isinstance(child, (dict, list, tuple)) and not child:
                lines.append(f"{pad}{k}: {'{}' if isinstance(child, dict) else '[]'}")
            elif isinstance(child, (dict, list, tuple)):
                lines.append(f"{pad}{k}:")
                # a mapping's list sits at the key's indent
                lines += _block_lines(child, indent + 2 * isinstance(child, dict))
            else:
                lines.append(f"{pad}{k}: {_scalar_text(child)}")
        return lines
    for child in v:
        if isinstance(child, (dict, list, tuple)):
            raise TypeError(f"only lists of scalars are written, got an item {child!r}")
        lines.append(f"{pad}- {_scalar_text(child)}")
    return lines


def _unescape(body: str) -> str:
    out, i = [], 0
    while i < len(body):
        c = body[i]
        if c != "\\":
            out.append(c)
            i += 1
            continue
        e = body[i + 1]
        n = _HEX_ESCAPES.get(e, 0)
        if n:
            out.append(chr(int(body[i + 2:i + 2 + n], 16)))
        elif e in _ESCAPES:
            out.append(_ESCAPES[e])
        else:
            raise ValueError(f"unknown escape \\{e} in {body!r}")
        i += 2 + n
    return "".join(out)


_FLOW_QUOTED = re.compile(r"'(?:[^']|'')*'|\"(?:[^\"\\]|\\.)*\"")
_FLOW_PLAIN = re.compile(r"[^,\[\]{}#]*")


def _flow_sequence(text: str) -> list:
    """A flow sequence on one line (``[1, 2.5, [3, 'x']]``): nested flow
    sequences of scalars, then nothing but a comment."""
    pos = 0

    def skip() -> None:
        nonlocal pos
        while pos < len(text) and text[pos] == " ":
            pos += 1

    def seq() -> list:
        nonlocal pos
        pos += 1  # the "["
        out: list = []
        skip()
        if text[pos:pos + 1] == "]":
            pos += 1
            return out
        while True:
            skip()
            if text[pos:pos + 1] == "[":
                out.append(seq())
            else:
                m = _FLOW_QUOTED.match(text, pos) or _FLOW_PLAIN.match(text, pos)
                token = m.group().strip()
                if not token:
                    raise ValueError(f"unsupported flow sequence: {text!r}")
                out.append(_scalar(token))
                pos = m.end()
            skip()
            if text[pos:pos + 1] == ",":
                pos += 1
            elif text[pos:pos + 1] == "]":
                pos += 1
                return out
            else:
                raise ValueError(f"unsupported flow sequence: {text!r}")

    out = seq()
    if re.fullmatch(r"(?: +#.*)?", text[pos:]) is None:
        raise ValueError(f"unexpected text after a flow sequence: {text!r}")
    return out


def _scalar(text: str, nested: bool = False) -> Any:
    """A value written on one line after ``key: `` or ``- `` (with
    ``nested``, also a flow sequence)."""
    if nested and text[0] == "[":
        return _flow_sequence(text)
    if text[0] in "'\"":
        m = (_SINGLE if text[0] == "'" else _DOUBLE).fullmatch(text)
        if m is None:
            raise ValueError(f"a quoted scalar open, or over several lines: {text!r}")
        return m.group(1).replace("''", "'") if text[0] == "'" else _unescape(m.group(1))
    plain = re.sub(r" +#.*$", "", text)
    if plain in ("[]", "{}"):
        return [] if plain == "[]" else {}
    if plain[0] in "[]{}&*!|>%@`?:#," or plain == "-" or plain.startswith("- ") or ": " in plain \
            or plain.endswith(":"):
        raise ValueError(f"unsupported YAML: {text!r}")
    return _resolve_plain(plain)


def load_yaml(text: str) -> dict:
    """Parse the block YAML that :func:`dump_yaml` and ``yaml.safe_dump``
    write for a config tree, and such a file edited by hand: a mapping of
    nested block mappings with identifier keys, lists of scalars (at their
    key's indent or deeper), ``[]``, ``{}``, one-line plain or quoted
    scalars, and ``#`` comments. Raises ValueError on anything else, a
    scalar folded over several lines included (PyYAML folds a string past
    80 columns: write it on one line)."""
    return _load_block_yaml(text, nested=False)


def load_scraper_yaml(text: str) -> dict:
    """:func:`load_yaml`'s subset plus block lists of mappings (``- name:
    x`` with the item's further keys below it) and one-line flow sequences
    of scalars (``[[2.11, 48.44]]``): the shapes of the reference scraper's
    config.yaml, which no experiment config has."""
    return _load_block_yaml(text, nested=True)


def _load_block_yaml(text: str, nested: bool) -> dict:
    lines: List[Tuple[int, str]] = []
    for raw in text.splitlines():
        body = raw.lstrip(" ")
        if not body.strip() or body.startswith("#"):
            continue
        if body[0] == "\t":
            raise ValueError(f"tab in indentation: {raw!r}")
        lines.append((len(raw) - len(body), body.rstrip()))
    pos = 0

    def item(i: int) -> bool:
        return lines[i][1].startswith("- ")

    def end_of_block(indent: int) -> None:
        if pos < len(lines) and lines[pos][0] > indent:
            raise ValueError(f"unexpected indent (a scalar over several lines?): "
                             f"{lines[pos][1]!r}")

    def value(indent: int) -> Any:
        """The value of a key at ``indent`` with nothing after its colon: a
        deeper block, a list at the key's own indent, or null."""
        if pos < len(lines) and lines[pos][0] > indent:
            return (sequence if item(pos) else mapping)(lines[pos][0])
        if pos < len(lines) and lines[pos][0] == indent and item(pos):
            return sequence(indent)
        return None

    def mapping(indent: int) -> dict:
        nonlocal pos
        out = {}
        while pos < len(lines) and lines[pos][0] >= indent:
            end_of_block(indent)
            m = _KEY.fullmatch(lines[pos][1])
            if m is None:
                raise ValueError(f"expected 'key: value', got {lines[pos][1]!r}")
            if m.group(1) in out:
                raise ValueError(f"duplicate key {m.group(1)!r}")
            pos += 1
            rest = m.group(2) if m.group(2) and m.group(2)[0] != "#" else None
            out[m.group(1)] = _scalar(rest, nested) if rest else value(indent)
        return out

    def sequence(indent: int) -> list:
        nonlocal pos
        out = []
        while pos < len(lines) and lines[pos][0] == indent and item(pos):
            body = lines[pos][1][2:].lstrip(" ")
            if _KEY.fullmatch(body):
                if not nested:
                    raise ValueError(f"only lists of scalars are read, got {lines[pos][1]!r}")
                # the item's mapping: its first key sits after the dash
                lines[pos] = (indent + len(lines[pos][1]) - len(body), body)
                out.append(mapping(lines[pos][0]))
                continue
            out.append(_scalar(body, nested))
            pos += 1
        end_of_block(indent)
        return out

    tree = mapping(0)
    if pos < len(lines):
        raise ValueError(f"unexpected line: {lines[pos][1]!r}")
    return tree
