"""Hydra-compatible YAML config loader + object instantiation.

The reference builds its whole object tree from Hydra YAML configs with
``_target_`` keys, ``defaults:`` composition and ``${..key}`` interpolation
(reference: ``configs/dataset/generator/default.yaml``, ``fetalsyngen/test.py:8-12``).
Hydra is not a dependency, so this module implements the subset the configs
use: recursive ``_target_`` instantiation, relative/absolute interpolation, and
``defaults`` list composition — keeping the reference's YAML schema working
against this framework's classes. The YAML itself is read by
:func:`parse_yaml`, a loader for the subset the configs are written in, so
the config path needs no YAML package.
"""

from __future__ import annotations

import importlib
import re
from pathlib import Path
from typing import Any

_INTERP_RE = re.compile(r"^\$\{([^}]+)\}$")


# ---------------------------------------------------------------------------
# YAML subset
# ---------------------------------------------------------------------------

_NULLS = {"", "~", "null", "Null", "NULL"}
_BOOLS = {
    **dict.fromkeys(("true", "True", "TRUE", "yes", "Yes", "YES", "on", "On", "ON"), True),
    **dict.fromkeys(("false", "False", "FALSE", "no", "No", "NO", "off", "Off", "OFF"), False),
}
_INT_RE = re.compile(r"^[-+]?(0|[1-9][0-9_]*)$")
_FLOAT_RE = re.compile(
    r"^(?:[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?|\.[0-9_]+(?:[eE][-+][0-9]+)?)$"
)
_SPECIAL_FLOATS = {
    **dict.fromkeys((".inf", ".Inf", ".INF", "+.inf", "+.Inf", "+.INF"), float("inf")),
    **dict.fromkeys(("-.inf", "-.Inf", "-.INF"), float("-inf")),
    **dict.fromkeys((".nan", ".NaN", ".NAN"), float("nan")),
}


class YAMLSubsetError(ValueError):
    """Raised for YAML outside the subset :func:`parse_yaml` reads."""


def _plain_scalar(tok: str) -> Any:
    """Resolve a plain scalar like YAML 1.1 (PyYAML's ``safe_load``)."""
    if tok in _NULLS:
        return None
    if tok in _BOOLS:
        return _BOOLS[tok]
    if _INT_RE.match(tok):
        return int(tok.replace("_", ""))
    if _FLOAT_RE.match(tok):
        return float(tok.replace("_", ""))
    if tok in _SPECIAL_FLOATS:
        return _SPECIAL_FLOATS[tok]
    return tok


_ESCAPES = {"n": "\n", "t": "\t", "r": "\r", "0": "\0", '"': '"', "\\": "\\", "/": "/", " ": " "}


def _quoted(s: str, p: int) -> tuple[str, int]:
    """Parse the quoted scalar starting at ``s[p]``; return (value, end)."""
    q = s[p]
    out = []
    i = p + 1
    while i < len(s):
        c = s[i]
        if q == "'" and c == "'":
            if s[i + 1 : i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        if q == '"' and c == "\\":
            esc = s[i + 1 : i + 2]
            if esc not in _ESCAPES:
                raise YAMLSubsetError(f"unsupported escape \\{esc} in {s!r}")
            out.append(_ESCAPES[esc])
            i += 2
            continue
        if q == '"' and c == '"':
            return "".join(out), i + 1
        out.append(c)
        i += 1
    raise YAMLSubsetError(f"unterminated quoted scalar in {s!r}")


def _strip_comment(line: str) -> str:
    """Drop a ``#`` comment (at line start or after whitespace, outside quotes)."""
    i = 0
    while i < len(line):
        c = line[i]
        if c in "'\"" and (i == 0 or line[i - 1] in " \t[{,:-"):
            _, i = _quoted(line, i)
            continue
        if c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
        i += 1
    return line.rstrip()


def _find_colon(text: str) -> int | None:
    """Index of the mapping colon (``:`` + space or end), outside quotes and
    brackets, or None when ``text`` is not a ``key: value`` entry."""
    depth = 0
    i = 0
    while i < len(text):
        c = text[i]
        if c in "'\"" and (i == 0 or text[i - 1] in " \t[{,:"):
            _, i = _quoted(text, i)
            continue
        if c in "[{":
            depth += 1
        elif c in "]}":
            depth -= 1
        elif c == ":" and depth == 0 and (i + 1 == len(text) or text[i + 1] in " \t"):
            return i
        i += 1
    return None


def _key(tok: str) -> Any:
    tok = tok.strip()
    if tok[:1] in "'\"":
        val, end = _quoted(tok, 0)
        if tok[end:].strip():
            raise YAMLSubsetError(f"trailing text after quoted key {tok!r}")
        return val
    return _plain_scalar(tok)


def _flow(s: str, p: int, in_flow: bool) -> tuple[Any, int]:
    """Parse one flow node (``[..]``, ``{..}``, quoted or plain scalar)."""
    while p < len(s) and s[p] == " ":
        p += 1
    if p < len(s) and s[p] in "[{":
        close = "]" if s[p] == "[" else "}"
        is_map = s[p] == "{"
        out: Any = {} if is_map else []
        p += 1
        while True:
            while p < len(s) and s[p] == " ":
                p += 1
            if p >= len(s):
                raise YAMLSubsetError(f"unterminated flow collection in {s!r}")
            if s[p] == close:
                return out, p + 1
            if is_map:
                k, p = _flow(s, p, True)
                while p < len(s) and s[p] == " ":
                    p += 1
                if s[p : p + 1] != ":":
                    raise YAMLSubsetError(f"expected ':' in flow mapping {s!r}")
                v, p = _flow(s, p + 1, True)
                out[k] = v
            else:
                v, p = _flow(s, p, True)
                out.append(v)
            while p < len(s) and s[p] == " ":
                p += 1
            if s[p : p + 1] == ",":
                p += 1
            elif s[p : p + 1] != close:
                raise YAMLSubsetError(f"expected ',' or {close!r} in {s!r}")
    if p < len(s) and s[p] in "'\"":
        return _quoted(s, p)
    end = p
    while end < len(s):
        if in_flow and (s[end] in ",]}" or (s[end] == ":" and s[end + 1 : end + 2] in (" ", ""))):
            break
        end += 1
    return _plain_scalar(s[p:end].strip()), end


def _inline(text: str) -> Any:
    if text[:1] in "&*!|>%@`":
        raise YAMLSubsetError(f"unsupported YAML construct: {text!r}")
    val, end = _flow(text, 0, text[:1] in "[{")
    if text[end:].strip():
        raise YAMLSubsetError(f"trailing text after value {text!r}")
    return val


def _is_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


def _block(lines: list, i: int, indent: int) -> tuple[Any, int]:
    if _is_item(lines[i][1]):
        return _sequence(lines, i, indent)
    return _mapping(lines, i, indent)


def _nested(lines: list, i: int, indent: int, allow_seq_same: bool) -> tuple[Any, int]:
    """Value of an entry whose inline part is empty: the block on the next
    lines (deeper, or a same-column sequence under a mapping key), else null."""
    if i < len(lines):
        nxt_indent, nxt = lines[i]
        if nxt_indent > indent or (allow_seq_same and nxt_indent == indent and _is_item(nxt)):
            return _block(lines, i, nxt_indent)
    return None, i


def _sequence(lines: list, i: int, indent: int) -> tuple[list, int]:
    out = []
    while i < len(lines) and lines[i][0] == indent and _is_item(lines[i][1]):
        text = lines[i][1]
        rest = text[1:].lstrip()
        if not rest:
            val, i = _nested(lines, i + 1, indent, False)
        elif _is_item(rest) or (rest[:1] not in "[{" and _find_colon(rest) is not None):
            # a nested block whose first line shares the dash's line
            col = indent + len(text) - len(rest)
            lines[i] = (col, rest)
            val, i = _block(lines, i, col)
        else:
            val, i = _inline(rest), i + 1
        out.append(val)
    return out, i


def _mapping(lines: list, i: int, indent: int) -> tuple[dict, int]:
    out: dict = {}
    while i < len(lines) and lines[i][0] == indent and not _is_item(lines[i][1]):
        text = lines[i][1]
        c = _find_colon(text)
        if c is None:
            raise YAMLSubsetError(f"expected 'key: value', got {text!r}")
        key, rest = _key(text[:c]), text[c + 1 :].strip()
        if rest:
            val, i = _inline(rest), i + 1
        else:
            val, i = _nested(lines, i + 1, indent, True)
        out[key] = val
    return out, i


def parse_yaml(text: str) -> Any:
    """Parse the YAML subset the configs use (PyYAML ``safe_load`` semantics).

    Supported: block mappings and sequences (including a mapping that starts
    on a ``- `` line), one-line flow lists and mappings, plain / single- /
    double-quoted scalars resolved like YAML 1.1 (null, bool, int, float,
    string; ints are decimal), and ``#`` comments. ``${...}`` interpolations stay strings for
    :func:`resolve_interpolations`. Anchors, tags, multi-line scalars and
    multi-document streams raise :class:`YAMLSubsetError`.
    """
    lines = []
    for raw in text.splitlines():
        if "\t" in raw[: len(raw) - len(raw.lstrip(" \t"))]:
            raise YAMLSubsetError(f"tab indentation: {raw!r}")
        body = _strip_comment(raw)
        stripped = body.lstrip(" ")
        if not stripped or stripped == "---":
            continue
        if stripped[0] in "&*!|>%@`" or stripped == "...":
            raise YAMLSubsetError(f"unsupported YAML construct: {raw!r}")
        lines.append((len(body) - len(stripped), stripped))
    if not lines:
        return None
    if len(lines) == 1 and lines[0][0] == 0 and not _is_item(lines[0][1]) and (
        lines[0][1][:1] in "[{" or _find_colon(lines[0][1]) is None
    ):
        return _inline(lines[0][1])
    val, i = _block(lines, 0, lines[0][0])
    if i != len(lines):
        raise YAMLSubsetError(f"unexpected indentation at {lines[i][1]!r}")
    return val


def _deep_merge(base: dict, override: dict) -> dict:
    out = dict(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def load_yaml(path: str | Path, _root_dir: Path | None = None) -> dict:
    """Load a YAML config, composing any ``defaults:`` list (Hydra-style).

    ``defaults`` entries may be strings (``group/name``) or single-item dicts
    (``{group: name}``); they are resolved relative to the config's directory.
    """
    path = Path(path)
    root = _root_dir or path.parent
    with open(path) as f:
        cfg = parse_yaml(f.read()) or {}

    defaults = cfg.pop("defaults", None)
    if defaults:
        merged: dict = {}
        for entry in defaults:
            if entry == "_self_":
                merged = _deep_merge(merged, cfg)
                cfg = {}
                continue
            if isinstance(entry, dict):
                ((group, name),) = entry.items()
                if name is None:
                    continue
                sub_path = root / str(group) / f"{name}.yaml"
                sub = load_yaml(sub_path)
                keyed = sub
                for part in reversed(str(group).split("/")):
                    keyed = {part: keyed}
                merged = _deep_merge(merged, keyed)
            else:
                # "group/name" nests under the group path (Hydra package
                # semantics); a bare name merges at the root.
                sub_path = root / f"{entry}.yaml"
                sub = load_yaml(sub_path)
                parts = str(entry).split("/")[:-1]
                keyed = sub
                for part in reversed(parts):
                    keyed = {part: keyed}
                merged = _deep_merge(merged, keyed)
        cfg = _deep_merge(merged, cfg)
    return cfg


def _resolve_path(cfg: Any, parts: list[str], stack: list[Any]) -> Any:
    """Resolve an interpolation path like ``..device`` against the node stack."""
    # Count leading empty parts from '..'-style paths: "${..device}" splits to
    # ['', '', 'device'] — each leading '' walks one level up.
    # Leading dots are OmegaConf-relative: one dot = the containing node,
    # each further dot walks one parent up. stack[-1] is the containing node.
    ups = 0
    while ups < len(parts) and parts[ups] == "":
        ups += 1
    if ups:
        node = stack[-ups] if ups <= len(stack) else stack[0]
        keys = parts[ups:]
    else:
        node = stack[0]  # absolute path from root
        keys = parts
    for k in keys:
        node = node[k]
    return node


def resolve_interpolations(cfg: Any) -> Any:
    """Resolve ``${path}`` string interpolations in-place (returns a copy)."""

    def walk(node: Any, stack: list[Any]) -> Any:
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                out[k] = walk(v, stack + [node])
            return out
        if isinstance(node, list):
            return [walk(v, stack) for v in node]
        if isinstance(node, str):
            m = _INTERP_RE.match(node)
            if m:
                resolved = _resolve_path(cfg, m.group(1).split("."), stack)
                return walk(resolved, stack)
        return node

    return walk(cfg, [])


def _import_target(target: str):
    module_name, _, attr = target.rpartition(".")
    module = importlib.import_module(module_name)
    return getattr(module, attr)


def instantiate(cfg: Any, **overrides: Any) -> Any:
    """Recursively instantiate a config node (Hydra ``instantiate`` subset).

    Dicts with a ``_target_`` key become objects; other dicts/lists are
    instantiated recursively; scalars pass through.
    """
    if isinstance(cfg, list):
        return [instantiate(v) for v in cfg]
    if not isinstance(cfg, dict):
        return cfg
    if "_target_" in cfg:
        kwargs = {k: instantiate(v) for k, v in cfg.items() if k != "_target_"}
        kwargs.update(overrides)
        cls = _import_target(cfg["_target_"])
        return cls(**kwargs)
    return {k: instantiate(v) for k, v in cfg.items()}


def load_and_instantiate(path: str | Path, key: str | None = None, **overrides: Any) -> Any:
    """Load a YAML config file, resolve interpolations, and instantiate.

    Args:
        path: Path to the YAML file.
        key: Optional top-level key to instantiate (e.g. ``"dataset"``).
        overrides: Keyword overrides applied to the top-level target.
    """
    cfg = resolve_interpolations(load_yaml(path))
    if key is not None:
        cfg = cfg[key]
    return instantiate(cfg, **overrides)
