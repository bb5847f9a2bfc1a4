"""Configuration: YAML file -> dotlist overrides -> flags (counterpart of
``pantomatrix_tpu/utils/config.py``, the reference's OmegaConf use).

The machines the port runs on need not have PyYAML, so the port reads and writes the
YAML subset its config files use itself: nested block mappings, block lists of scalars
(indented under their key or level with it), flow lists of scalars, quoted and plain
scalars and comments. Plain scalars resolve as PyYAML's ``safe_load`` resolves them (YAML
1.1: ``3e-4`` without a dot is a string, ``1.0e-8`` a float, ``yes``/``off`` booleans),
so a file reads the same either way; anything outside the subset raises.
"""
from __future__ import annotations

import ast
import datetime
import glob
import json
import os
import re
import shutil
from typing import Any, Dict, List, Optional, Tuple


class DotDict(dict):
    """dict with attribute access, recursive over nested dicts (OmegaConf-lite)."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    @classmethod
    def wrap(cls, obj):
        if isinstance(obj, dict):
            return cls({k: cls.wrap(v) for k, v in obj.items()})
        if isinstance(obj, list):
            return [cls.wrap(v) for v in obj]
        return obj

    def to_dict(self) -> Dict[str, Any]:
        def unwrap(o):
            if isinstance(o, dict):
                return {k: unwrap(v) for k, v in o.items()}
            if isinstance(o, list):
                return [unwrap(v) for v in o]
            return o

        return unwrap(self)


# ---------------------------------------------------------------------------
# the YAML subset
# ---------------------------------------------------------------------------

# PyYAML's implicit resolvers (yaml/resolver.py) for the plain scalars
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                  r"|[-+]?0x[0-9a-fA-F_]+)$")
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")


class YamlSubsetError(ValueError):
    """The text uses YAML outside the subset the port reads."""


def _plain(s: str) -> Any:
    if _NULL.match(s):
        return None
    if _BOOL.match(s):
        return s.lower() in ("yes", "true", "on")
    if _INT.match(s):
        t = s.replace("_", "")
        sign = -1 if t.startswith("-") else 1
        t = t.lstrip("+-")
        if t.startswith("0b"):
            return sign * int(t[2:], 2)
        if t.startswith("0x"):
            return sign * int(t[2:], 16)
        if len(t) > 1 and t.startswith("0"):
            return sign * int(t, 8)
        return sign * int(t)
    if _FLOAT.match(s):
        t = s.replace("_", "").lower()
        if t.endswith(".inf"):
            return float("-inf") if t.startswith("-") else float("inf")
        if t.endswith(".nan"):
            return float("nan")
        return float(t)
    return s


def _strip_comment(line: str) -> str:
    """The line without a trailing ``# comment`` (a ``#`` at the start or after a space,
    outside quotes)."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and (i == 0 or line[i - 1] in " [,:-"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _scalar(s: str) -> Any:
    s = s.strip()
    if s.startswith('"'):
        if not s.endswith('"') or len(s) < 2:
            raise YamlSubsetError(f"unterminated string {s!r}")
        return json.loads(s)
    if s.startswith("'"):
        if not s.endswith("'") or len(s) < 2:
            raise YamlSubsetError(f"unterminated string {s!r}")
        return s[1:-1].replace("''", "'")
    if s.startswith("[") or s.startswith("{"):
        return _flow(s)
    if s[:1] in ("&", "*", "!", "|", ">", "%", "@", "`"):
        raise YamlSubsetError(f"unsupported YAML: {s!r}")
    return _plain(s)


def _flow(s: str) -> Any:
    """A flow list of scalars, ``[a, 'b', 3]``, or the empty mapping ``{}``."""
    if s == "{}":
        return {}
    if not (s.startswith("[") and s.endswith("]")):
        raise YamlSubsetError(f"unsupported flow collection {s!r}")
    body = s[1:-1].strip()
    if not body:
        return []
    items, cur, quote = [], "", None
    for ch in body:
        if quote:
            cur += ch
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
            cur += ch
        elif ch in "[]{}":
            raise YamlSubsetError(f"nested flow collections are not read: {s!r}")
        elif ch == ",":
            items.append(cur)
            cur = ""
        else:
            cur += ch
    items.append(cur)
    if items and not items[-1].strip():
        items.pop()  # a trailing comma
    return [_scalar(x) for x in items]


def _lines(text: str) -> List[Tuple[int, str]]:
    out = []
    for raw in text.splitlines():
        if "\t" in raw[: len(raw) - len(raw.lstrip())]:
            raise YamlSubsetError("tabs in indentation")
        line = _strip_comment(raw)
        if line.strip() in ("", "---"):
            continue
        out.append((len(line) - len(line.lstrip(" ")), line.strip()))
    return out


def _split_key(text: str) -> Tuple[str, str]:
    """``key: value`` -> (key, value); the key may be quoted."""
    m = re.match(r"""^("(?:[^"\\]|\\.)*"|'(?:[^']|'')*'|[^:#'"][^:]*?)\s*:(?:\s+(.*)|)$""", text)
    if not m:
        raise YamlSubsetError(f"not a 'key: value' line: {text!r}")
    key = m.group(1)
    key = _scalar(key) if key[0] in "'\"" else _plain(key)
    return key, (m.group(2) or "").strip()


def _block(lines, i: int, indent: int):
    """Parse the block starting at line ``i`` whose lines sit at ``indent``; returns
    (value, next line)."""
    if lines[i][1].startswith("- ") or lines[i][1] == "-":
        out = []
        while i < len(lines) and lines[i][0] == indent and (
                lines[i][1].startswith("- ") or lines[i][1] == "-"):
            item = lines[i][1][1:].strip()
            if not item or (item[0] not in "'\"[" and re.search(r":(\s|$)", item)):
                raise YamlSubsetError(f"only scalar list items are read: {lines[i][1]!r}")
            out.append(_scalar(item))
            i += 1
        return out, i
    out: Dict[Any, Any] = {}
    while i < len(lines) and lines[i][0] == indent:
        key, value = _split_key(lines[i][1])
        if key in out:
            raise YamlSubsetError(f"duplicate key {key!r}")
        i += 1
        if value:
            out[key] = _scalar(value)
        elif i < len(lines) and (lines[i][0] > indent or (
                lines[i][0] == indent and lines[i][1].startswith("-"))):
            out[key], i = _block(lines, i, lines[i][0])
        else:
            out[key] = None
    return out, i


def parse_yaml(text: str) -> Any:
    """The document in ``text`` (the subset the port reads; see the module docstring)."""
    lines = _lines(text)
    if not lines:
        return None
    value, i = _block(lines, 0, lines[0][0])
    if i != len(lines):
        raise YamlSubsetError(f"unexpected indentation at {lines[i][1]!r}")
    return value


def _dump_scalar(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if v != v:
            return ".nan"
        if v in (float("inf"), float("-inf")):
            return ".inf" if v > 0 else "-.inf"
        r = repr(v)
        if "." not in r:  # YAML 1.1 floats need a dot: 1e-08 -> 1.0e-08
            mant, _, exp = r.partition("e")
            r = f"{mant}.0" + (f"e{exp if exp[0] in '+-' else '+' + exp}" if exp else "")
        return r
    if isinstance(v, str):
        return json.dumps(v)
    raise YamlSubsetError(f"cannot write {type(v).__name__} {v!r}")


def dump_yaml(obj: Any, indent: int = 0) -> str:
    """``obj`` (dicts, lists of scalars, scalars) in the subset ``parse_yaml`` reads."""
    pad = " " * indent
    if isinstance(obj, dict):
        if not obj:
            return pad + "{}\n"
        out = []
        for k, v in obj.items():
            key = _dump_scalar(k) if not isinstance(k, str) or not re.match(
                r"^[A-Za-z_][A-Za-z0-9_.\-]*$", k) else k
            if isinstance(v, dict) and v:
                out.append(f"{pad}{key}:\n" + dump_yaml(v, indent + 2))
            elif isinstance(v, list) and v:
                out.append(f"{pad}{key}:\n" + "".join(
                    f"{pad}  - {_dump_scalar(x)}\n" for x in v))
            else:
                out.append(f"{pad}{key}: "
                           + ("{}" if isinstance(v, dict) else "[]" if isinstance(v, list)
                              else _dump_scalar(v)) + "\n")
        return "".join(out)
    return pad + _dump_scalar(obj) + "\n"


def load_yaml(path: str) -> DotDict:
    with open(path) as f:
        return DotDict.wrap(parse_yaml(f.read()))


# ---------------------------------------------------------------------------
# overrides, names, snapshots
# ---------------------------------------------------------------------------

def _parse_value(s: str) -> Any:
    try:
        return ast.literal_eval(s)
    except (ValueError, SyntaxError):
        low = s.lower()
        if low in ("true", "false"):
            return low == "true"
        if low in ("null", "none"):
            return None
        return s


def apply_dotlist(cfg: DotDict, overrides: List[str]) -> DotDict:
    """``a.b.c=value`` overrides, parsed like OmegaConf.from_dotlist."""
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"override {item!r} is not key=value")
        key, value = item.split("=", 1)
        node = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            if p not in node or not isinstance(node[p], dict):
                node[p] = DotDict()
            node = node[p]
        node[parts[-1]] = _parse_value(value)
    return cfg


def load_config(path: str, overrides: Optional[List[str]] = None) -> DotDict:
    cfg = load_yaml(path)
    if overrides:
        apply_dotlist(cfg, overrides)
    return cfg


def timestamp_exp_name(exp_name: str) -> str:
    """<name>_<YYYYMMDD_HHMMSS>, as the reference's init_env names runs."""
    return f"{exp_name}_{datetime.datetime.now().strftime('%Y%m%d_%H%M%S')}"


def snapshot_sanity_check(output_dir: str, cfg: DotDict, source_root: str) -> str:
    """Copy the resolved config and every .py file under ``source_root`` into
    ``<output_dir>/sanity_check/`` (the reference's init_env snapshot)."""
    dst = os.path.join(output_dir, "sanity_check")
    os.makedirs(dst, exist_ok=True)
    with open(os.path.join(dst, "resolved_config.yaml"), "w") as f:
        f.write(dump_yaml(cfg.to_dict()))
    for py in glob.glob(os.path.join(source_root, "**", "*.py"), recursive=True):
        target = os.path.join(dst, os.path.relpath(py, source_root))
        os.makedirs(os.path.dirname(target), exist_ok=True)
        shutil.copy2(py, target)
    return dst


__all__ = [
    "DotDict",
    "YamlSubsetError",
    "apply_dotlist",
    "dump_yaml",
    "load_config",
    "load_yaml",
    "parse_yaml",
    "snapshot_sanity_check",
    "timestamp_exp_name",
]
