"""Config loading and dotted command-line overrides.

Counterpart of ``octa_tpu/utils/config.py``. The override semantics are the
reference's (``utils/config_overrides.py:18-62``):

- ``--Section.sub.key value``  sets a nested key
- ``--Section.sub.key=value``  same
- ``--Section.flag``           boolean flag, interpreted as ``true``

Only dotted keys are treated as overrides, so plain argparse flags pass
through.

The port runs on hosts without PyYAML. Configs are read and written as JSON
with the standard library; a ``.yml``/``.yaml`` path is read with the
``yaml`` package where it can be imported, and otherwise by
:func:`parse_block_yaml`, which reads the block subset the shipped configs
use. :func:`dump_config` writes YAML where the ``yaml`` package imports,
and JSON (which is YAML too) under the same name where it does not.
Override values are parsed as the scalars and flow collections YAML would
read them as, by :func:`parse_scalar`.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
import re
from typing import Any

# YAML 1.1's implicit resolvers for numbers (base-60 forms left out: they
# stay strings here)
_INT = re.compile(r"[-+]?(0b[0-1_]+|0[0-7_]+|0|[1-9][0-9_]*|0x[0-9a-fA-F_]+)")
_FLOAT = re.compile(
    r"[-+]?[0-9][0-9_]*\.[0-9_]*([eE][-+][0-9]+)?"
    r"|\.[0-9][0-9_]*([eE][-+][0-9]+)?")

def _yaml():
    """The ``yaml`` module where it is installed, else None."""
    if importlib.util.find_spec("yaml") is None:
        return None
    return importlib.import_module("yaml")


def _is_yaml(path: str) -> bool:
    return os.path.splitext(path)[1].lower() in (".yml", ".yaml")


def load_config(path: str) -> dict[str, Any]:
    """Read a ``.json`` config, or a ``.yml`` one: JSON where its text is a
    JSON object (:func:`dump_config` without PyYAML), else YAML, with the
    ``yaml`` package where it imports and :func:`parse_block_yaml`
    where it does not."""
    path = os.path.abspath(path)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"Your provided config path {path} does not exist!")
    with open(path, "r") as stream:
        if not _is_yaml(path):
            return json.load(stream)
        text = stream.read()
    if text.lstrip().startswith("{"):
        try:
            return json.loads(text)
        except ValueError:
            pass  # a YAML flow mapping
    yaml = _yaml()
    if yaml is None:
        return parse_block_yaml(text, path)
    return yaml.safe_load(text)


def _strip_comment(line: str) -> str:
    """``line`` without a ``#`` comment (a ``#`` at the start or after
    whitespace, outside quotes)."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def parse_block_yaml(text: str, path: str = "<string>") -> Any:
    """Read the block YAML the shipped configs are written in, on hosts
    without PyYAML: nested mappings and ``- `` sequences by indentation,
    flow lists and mappings and plain or quoted scalars on one line
    (:func:`parse_scalar`), comments, and a leading ``---``. A JSON
    document is read as JSON. Anchors, tags and multi-line scalars raise."""
    if text.lstrip().startswith(("{", "[")):
        return json.loads(text)
    lines = []
    for n, raw in enumerate(text.splitlines(), 1):
        body = _strip_comment(raw).rstrip()
        if not body.strip() or body.strip() in ("---", "..."):
            continue
        if "\t" in body[:len(body) - len(body.lstrip())]:
            raise ValueError(f"{path}:{n}: tab in indentation")
        lines.append((len(body) - len(body.lstrip()), body.strip(), n))

    def bad(n, why):
        return ValueError(f"{path}:{n}: {why} (PyYAML is not installed; "
                          "only the configs' block subset is read)")

    def value(text, n):
        if text[:1] in ("&", "*", "!", "|", ">"):
            raise bad(n, f"unsupported YAML: {text!r}")
        return parse_scalar(text)

    def block(i, indent):
        """The node whose lines start at ``lines[i]``, indented ``indent``."""
        if lines[i][1].startswith("- ") or lines[i][1] == "-":
            return seq(i, indent)
        return mapping(i, indent, {})

    def mapping(i, indent, out):
        while i < len(lines) and lines[i][0] == indent:
            _, body, n = lines[i]
            if body.startswith("-"):
                break
            key, sep, rest = body.partition(":")
            if not sep or (rest and not rest.startswith(" ")):
                raise bad(n, f"expected 'key: value', got {body!r}")
            key = parse_scalar(key)
            rest = rest.strip()
            i += 1
            if rest:
                out[key] = value(rest, n)
            elif i < len(lines) and (lines[i][0] > indent or (
                    lines[i][0] == indent and lines[i][1].startswith("-"))):
                out[key], i = block(i, lines[i][0])
            else:
                out[key] = None
        return out, i

    def seq(i, indent):
        out = []
        while i < len(lines) and lines[i][0] == indent \
                and lines[i][1].startswith("-"):
            _, body, n = lines[i]
            rest = body[1:].strip()
            if not rest:
                i += 1
                item, i = block(i, lines[i][0])
            elif rest.startswith("- ") or rest == "-":
                # "- - x" opens a sequence indented past the first dash
                inner = indent + (len(body) - len(rest))
                lines[i] = (inner, rest, n)
                item, i = seq(i, inner)
            elif ":" in rest and not rest.startswith(("[", "{", "'", '"')) \
                    and (rest.partition(":")[2][:1] in ("", " ")):
                # "- key: value" opens a mapping indented past the dash
                inner = indent + (len(body) - len(rest))
                lines[i] = (inner, rest, n)
                item, i = mapping(i, inner, {})
            else:
                item, i = value(rest, n), i + 1
            out.append(item)
        return out, i

    if not lines:
        return None
    node, i = block(0, lines[0][0])
    if i != len(lines):
        raise bad(lines[i][2], "unexpected indentation")
    return node


def dump_config(config: dict[str, Any], path: str,
                sort_keys: bool = True) -> None:
    """Write ``config`` to a ``.yml``/``.yaml`` path as the JAX package
    does, ``yaml.safe_dump(config, f, sort_keys=sort_keys)``, where the
    ``yaml`` package imports; where it does not, and to any other path, as
    JSON (``sort_keys`` kept), which is YAML too and which
    :func:`load_config` reads back. The dataset generator keeps PyYAML's
    sorted keys (``generate_vessel_graph.py:84-85``), a run's snapshot
    the config's order (``octa_tpu/io/visualizer.py:53-54``)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    yaml = _yaml() if _is_yaml(path) else None
    with open(path, "w") as f:
        if yaml is None:
            json.dump(config, f, indent=2, sort_keys=sort_keys)
        else:
            yaml.safe_dump(config, f, sort_keys=sort_keys)


def _flat_yaml_scalar(value) -> str:
    """A bool, int or float as ``yaml.safe_dump`` writes it."""
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    value = float(value)
    if value != value:
        return ".nan"
    if value in (float("inf"), float("-inf")):
        return ".inf" if value > 0 else "-.inf"
    text = repr(value).lower()
    if "." not in text and "e" in text:  # 1e-05 would read back as a string
        text = text.replace("e", ".0e", 1)
    return text


def dump_flat_yaml(mapping: dict[str, Any], path: str) -> None:
    """Write a flat mapping of bools, ints and floats as the bytes
    ``yaml.safe_dump`` writes for it (keys sorted, one ``key: value`` a
    line), without the ``yaml`` package."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for key in sorted(mapping):
            f.write(f"{key}: {_flat_yaml_scalar(mapping[key])}\n")


def parse_cli_overrides(unknown_args: list[str]) -> list[tuple[str, str]]:
    overrides: list[tuple[str, str]] = []
    i = 0
    while i < len(unknown_args):
        token = unknown_args[i]
        if not isinstance(token, str) or not token.startswith("--"):
            i += 1
            continue
        keyval = token[2:]
        if "=" in keyval:
            k, v = keyval.split("=", 1)
            overrides.append((k, v))
            i += 1
            continue
        nxt = unknown_args[i + 1] if i + 1 < len(unknown_args) else None
        if isinstance(nxt, str) and not nxt.startswith("--"):
            overrides.append((keyval, nxt))
            i += 2
        else:
            overrides.append((keyval, "true"))
            i += 1
    return overrides


def _split_flow(body: str) -> list[str]:
    """Split the inside of ``[...]`` or ``{...}`` at top-level commas."""
    parts, depth, start = [], 0, 0
    for i, ch in enumerate(body):
        if ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
        elif ch == "," and depth == 0:
            parts.append(body[start:i])
            start = i + 1
    tail = body[start:]
    if tail.strip() or parts:
        parts.append(tail)
    return parts


def parse_scalar(text: str) -> Any:
    """``text`` as YAML 1.1 would read a plain scalar or a flow collection:
    null, booleans, integers, floats, quoted strings, ``[a, b]`` lists and
    ``{k: v}`` mappings; anything else stays a string."""
    s = text.strip()
    if s in ("", "~", "null", "Null", "NULL"):
        return None
    if s in ("true", "True", "TRUE", "yes", "Yes", "YES", "on", "On", "ON"):
        return True
    if s in ("false", "False", "FALSE", "no", "No", "NO", "off", "Off", "OFF"):
        return False
    if len(s) >= 2 and s[0] == s[-1] and s[0] in "'\"":
        return s[1:-1]
    if s[0] == "[" and s[-1] == "]":
        return [parse_scalar(p) for p in _split_flow(s[1:-1])]
    if s[0] == "{" and s[-1] == "}":
        out = {}
        for part in _split_flow(s[1:-1]):
            k, _, v = part.partition(":")
            out[parse_scalar(k)] = parse_scalar(v)
        return out
    if _INT.fullmatch(s):
        digits = s.replace("_", "")
        body = digits.lstrip("+-")
        if body.startswith("0b"):
            return int(digits.replace("0b", ""), 2)
        if body.startswith("0x"):
            return int(digits.replace("0x", ""), 16)
        if len(body) > 1 and body[0] == "0":
            return int(digits, 8)
        return int(digits)
    if _FLOAT.fullmatch(s):
        # as YAML 1.1: a dot is required, and an exponent needs its sign
        return float(s.replace("_", ""))
    if s.lower() in (".inf", "+.inf"):
        return float("inf")
    if s.lower() == "-.inf":
        return float("-inf")
    if s.lower() == ".nan":
        return float("nan")
    return s


def set_in_config(cfg: dict[str, Any], dotted_key: str, value_str: str) -> None:
    keys = dotted_key.split(".")
    d = cfg
    for k in keys[:-1]:
        if k not in d or not isinstance(d[k], dict):
            d[k] = {}
        d = d[k]
    d[keys[-1]] = parse_scalar(value_str)


def apply_cli_overrides(config: dict[str, Any], unknown_args: list[str]) -> None:
    """Apply dotted-key overrides found in ``unknown_args`` in place."""
    for k, v in parse_cli_overrides(unknown_args):
        if "." in k:  # avoid clashing with normal flags
            set_in_config(config, k, v)
