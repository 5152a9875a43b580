"""A reader and writer for the subset of YAML that the configuration uses.

The port does not depend on PyYAML. :func:`load` parses the packaged
``default_config.yml`` and any ``config.yml`` that
``yaml.safe_dump(entries, default_flow_style=None, sort_keys=False)`` writes:

* block mappings, and block sequences (indented or at their key's indent);
* flow lists and maps (``[256, 256, 128]``, ``{data: -1, sp: 1}``), also
  when they wrap over several lines;
* single- and double-quoted strings, plain strings, quoted strings folded
  over several lines;
* empty values and ``null``/``~`` as ``None``; the YAML 1.1 booleans
  (``true``, ``False``, ``yes``, ``off`` …); ints (decimal, ``0x``, ``0b``,
  ``0`` octal, ``_`` separators) and floats (``1.``, ``.5``, ``1.0e-06``,
  ``.inf``, ``.nan``) as PyYAML's ``safe_load`` resolves them;
* comments.

Not supported (never written by either package): anchors, aliases, tags,
block scalars (``|``, ``>``), several documents. A plain scalar that
PyYAML would read as a timestamp or a sexagesimal number stays a string.

:func:`dump` writes what PyYAML reads back as the same value: mappings in
block style, lists of scalars in flow style, strings quoted wherever a
plain scalar would resolve to another type, floats in PyYAML's form
(``1.0e-06``: YAML 1.1 reads ``1e-06`` as a string).
"""

from __future__ import annotations

import json
import math
import re
from typing import Any, List, Tuple

__all__ = ["load", "dump", "YamlError"]


class YamlError(ValueError):
    pass


_BOOL = {"yes": True, "Yes": True, "YES": True, "true": True, "True": True, "TRUE": True,
         "on": True, "On": True, "ON": True, "no": False, "No": False, "NO": False,
         "false": False, "False": False, "FALSE": False, "off": False, "Off": False,
         "OFF": False}
_NULL = {"", "~", "null", "Null", "NULL"}
# PyYAML's implicit resolvers (yaml/resolver.py), without sexagesimal forms
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?)$")
_INF = re.compile(r"^[-+]?\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"^\.(?:nan|NaN|NAN)$")
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                  r"|[-+]?0x[0-9a-fA-F_]+)$")
_OTHER_TYPES = re.compile(r"^(?:[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?"
                          r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}.*|<<|=)$")
_PLAIN_SAFE = re.compile(r"^[A-Za-z_/][A-Za-z0-9_./-]*$")


def _plain_scalar(s: str) -> Any:
    s = s.strip()
    if s in _NULL:
        return None
    if s in _BOOL:
        return _BOOL[s]
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
        return float(s.replace("_", ""))
    if _INF.match(s):
        return -math.inf if s.startswith("-") else math.inf
    if _NAN.match(s):
        return math.nan
    return s


# ------------------------------------------------------------------ reading
def _strip_comment(line: str) -> str:
    """The line without a trailing comment (a ``#`` at the start or after
    whitespace, outside quotes)."""
    i, prev, sig = 0, " ", "-"
    while i < len(line):
        ch = line[i]
        if ch in "'\"" and sig in "[{,:-":
            try:
                i = _scan_quoted(line, i)
            except YamlError:  # continues on the next line
                return line.rstrip()
            prev = sig = ch
            continue
        if ch == "#" and prev in " \t":
            return line[:i].rstrip()
        prev = ch
        if ch not in " \t":
            sig = ch
        i += 1
    return line.rstrip()


def _open_brackets(s: str) -> int:
    """Brackets a flow collection leaves open (quoted scalars skipped)."""
    depth, i, prev = 0, 0, "["
    while i < len(s):
        ch = s[i]
        if ch in "'\"" and prev in "[{,:":
            try:
                i = _scan_quoted(s, i)
            except YamlError:  # the quoted scalar continues on the next line
                return depth + 1
            prev = "'"
            continue
        if ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
        if ch not in " \n":
            prev = ch
        i += 1
    return depth


def _unclosed_quote(s: str) -> bool:
    s = s.strip()
    if not s or s[0] not in "'\"":
        return False
    q = s[0]
    i = 1
    while i < len(s):
        if s[i] == "\\" and q == '"':
            i += 2
            continue
        if s[i] == q:
            if q == "'" and i + 1 < len(s) and s[i + 1] == "'":
                i += 2
                continue
            return False
        i += 1
    return True


def _value_part(s: str) -> str:
    """What follows the ``- `` and the ``key:`` of a logical line."""
    while s.startswith("- "):
        s = s[2:].strip()
    kv = _split_key(s)
    return kv[1] if kv is not None else s


def _still_open(s: str) -> bool:
    v = _value_part(s)
    return bool(v) and (_unclosed_quote(v) or (v[0] in "[{" and _open_brackets(v) > 0))


def _lines(text: str) -> List[Tuple[int, str]]:
    """(indent, content) of each logical line: comments and blank lines
    dropped; flow collections and quoted scalars that continue over
    several lines joined with their line breaks, plain scalars folded onto
    a deeper line joined with a space."""
    out: List[Tuple[int, str]] = []
    pending = None
    for line in text.replace("\r\n", "\n").split("\n"):
        if pending is not None:
            pending[1] += "\n" + line
            if not _still_open(pending[1]):
                out.append((pending[0], pending[1]))
                pending = None
            continue
        if line.strip() in ("---", "..."):
            continue
        if "\t" in line[:len(line) - len(line.lstrip())]:
            raise YamlError("tabs in indentation")
        body = _strip_comment(line)
        if not body.strip():
            continue
        ind, body = len(body) - len(body.lstrip(" ")), body.strip()
        if out and ind > out[-1][0]:
            value = _value_part(out[-1][1])
            if value and value[0] not in "[{'\"" and not body.startswith("- ") \
                    and _split_key(body) is None:
                out[-1] = (out[-1][0], out[-1][1] + " " + body)
                continue
        if _still_open(body):
            pending = [ind, body]
            continue
        out.append((ind, body))
    if pending is not None:
        raise YamlError(f"unterminated value: {pending[1]!r}")
    return out


def _split_key(s: str):
    """(key, rest) when ``s`` is a mapping entry ``key: rest`` / ``key:``."""
    if s.startswith(("- ", "[", "{")) or s == "-":
        return None
    i = 0
    if s[0] in "'\"":
        try:
            j = _scan_quoted(s, 0)
        except YamlError:  # a quoted value still open, no key
            return None
        key = _parse_quoted(s[:j])
        i = j
        if not s[i:].startswith(":"):
            return None
        rest = s[i + 1:]
        if rest and not rest.startswith(" "):
            return None
        return key, rest.strip()
    m = re.search(r":(?: |$)", s)
    if m is None:
        return None
    return _plain_scalar(s[:m.start()]), s[m.end():].strip()


def _scan_quoted(s: str, i: int) -> int:
    """Index just past the quoted scalar starting at ``s[i]``."""
    q = s[i]
    j = i + 1
    while j < len(s):
        if q == '"' and s[j] == "\\":
            j += 2
            continue
        if s[j] == q:
            if q == "'" and j + 1 < len(s) and s[j + 1] == "'":
                j += 2
                continue
            return j + 1
        j += 1
    raise YamlError(f"unterminated quoted scalar: {s[i:]!r}")


_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
            "N": "\x85", "_": "\xa0", "L": " ", "P": " "}


def _fold(body: str, double: bool) -> str:
    """Line folding of a quoted scalar over several lines: a line break is
    a space, each blank line a newline; in double quotes a break after a
    backslash joins the lines."""
    parts = body.split("\n")
    res, blanks = parts[0], 0
    for k, p in enumerate(parts[1:], 1):
        if not p.strip(" \t") and k < len(parts) - 1:
            blanks += 1
            continue
        n_bs = len(res) - len(res.rstrip("\\"))
        if double and n_bs % 2 == 1:
            res = res[:-1] + "\n" * blanks + p.lstrip(" \t")
        else:
            res = res.rstrip(" \t") + ("\n" * blanks if blanks else " ") + p.lstrip(" \t")
        blanks = 0
    return res


def _parse_quoted(tok: str) -> str:
    q, body = tok[0], tok[1:-1]
    body = _fold(body, q == '"')
    if q == "'":
        return body.replace("''", "'")
    out, i = [], 0
    while i < len(body):
        ch = body[i]
        if ch != "\\":
            out.append(ch)
            i += 1
            continue
        nx = body[i + 1]
        if nx in "xuU":
            n = {"x": 2, "u": 4, "U": 8}[nx]
            out.append(chr(int(body[i + 2:i + 2 + n], 16)))
            i += 2 + n
        else:
            out.append(_ESCAPES[nx])
            i += 2
    return "".join(out)


def _parse_flow(s: str, i: int, stop: str):
    """One flow node at ``s[i]``; returns (value, index after it)."""
    while i < len(s) and s[i] in " \n":
        i += 1
    if i < len(s) and s[i] == "[":
        out, i = [], i + 1
        while True:
            while s[i] in " \n":
                i += 1
            if s[i] == "]":
                return out, i + 1
            v, i = _parse_flow(s, i, ",]")
            out.append(v)
            while s[i] in " \n":
                i += 1
            if s[i] == ",":
                i += 1
    if i < len(s) and s[i] == "{":
        out, i = {}, i + 1
        while True:
            while s[i] in " \n":
                i += 1
            if s[i] == "}":
                return out, i + 1
            k, i = _parse_flow(s, i, ":,}")
            while s[i] in " \n":
                i += 1
            v = None
            if s[i] == ":":
                v, i = _parse_flow(s, i + 1, ",}")
            out[k] = v
            while s[i] in " \n":
                i += 1
            if s[i] == ",":
                i += 1
    if i < len(s) and s[i] in "'\"":
        j = _scan_quoted(s, i)
        return _parse_quoted(s[i:j]), j
    j = i
    while j < len(s) and not (s[j] in stop and (s[j] != ":" or j + 1 == len(s)
                                                  or s[j + 1] in " ,]}")):
        j += 1
    return _plain_scalar(re.sub(r"[ \t]*\n[ \t]*", " ", s[i:j])), j


def _value(s: str) -> Any:
    if not s:
        return None
    if s[0] in "[{'\"":
        v, j = _parse_flow(s, 0, "")
        if s[j:].strip():
            raise YamlError(f"trailing characters after a value: {s!r}")
        return v
    return _plain_scalar(s)


def _block(lines, i: int, indent: int):
    """The block node whose lines start at ``lines[i]`` with ``indent``."""
    if lines[i][1].startswith("- ") or lines[i][1] == "-":
        out = []
        while i < len(lines) and lines[i][0] == indent and (
                lines[i][1].startswith("- ") or lines[i][1] == "-"):
            rest = lines[i][1][2:].strip()
            if not rest:
                if i + 1 < len(lines) and lines[i + 1][0] > indent:
                    v, i = _block(lines, i + 1, lines[i + 1][0])
                else:
                    v, i = None, i + 1
            elif rest.startswith("- ") or _split_key(rest) is not None:
                # a nested node on the item's own line: re-indent it
                sub = [(indent + 2, rest)]
                j = i + 1
                while j < len(lines) and lines[j][0] > indent:
                    sub.append(lines[j])
                    j += 1
                v, _ = _block(sub, 0, indent + 2)
                i = j
            else:
                v, i = _value(rest), i + 1
            out.append(v)
        return out, i
    out = {}
    while i < len(lines) and lines[i][0] == indent:
        kv = _split_key(lines[i][1])
        if kv is None:
            raise YamlError(f"expected 'key: value', got {lines[i][1]!r}")
        key, rest = kv
        i += 1
        if rest:
            out[key] = _value(rest)
        elif i < len(lines) and (lines[i][0] > indent or (
                lines[i][0] == indent and lines[i][1].startswith("- "))):
            out[key], i = _block(lines, i, lines[i][0])
        else:
            out[key] = None
    return out, i


def load(text: str) -> Any:
    """Parse one YAML document of the supported subset (``None`` if empty)."""
    lines = _lines(text)
    if not lines:
        return None
    if len(lines) == 1 and _split_key(lines[0][1]) is None and not lines[0][1].startswith("- "):
        return _value(lines[0][1])
    v, i = _block(lines, 0, lines[0][0])
    if i != len(lines):
        raise YamlError(f"unexpected indentation at {lines[i][1]!r}")
    return v


# ------------------------------------------------------------------ writing
def _scalar(v: Any) -> str:
    if hasattr(v, "item") and not isinstance(v, (list, dict, str)):
        v = v.item()  # numpy scalars
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
        r = repr(v).lower()
        if "." not in r and "e" in r:
            r = r.replace("e", ".0e", 1)
        return r
    if isinstance(v, str):
        if _PLAIN_SAFE.match(v) and isinstance(_plain_scalar(v), str) \
                and not _OTHER_TYPES.match(v):
            return v
        if v.isprintable():
            return "'" + v.replace("'", "''") + "'"
        return json.dumps(v, ensure_ascii=False)
    raise YamlError(f"cannot write a value of type {type(v).__name__}")


def _is_scalar(v: Any) -> bool:
    return not isinstance(v, (dict, list, tuple))


def _dump(v: Any, indent: int, out: List[str]):
    pad = " " * indent
    if isinstance(v, dict):
        for k, x in v.items():
            key = _scalar(k)
            if isinstance(x, dict) and x:
                out.append(f"{pad}{key}:")
                _dump(x, indent + 2, out)
            elif isinstance(x, (list, tuple)) and x and not all(_is_scalar(e) for e in x):
                out.append(f"{pad}{key}:")
                _dump(list(x), indent + 2, out)
            else:
                out.append(f"{pad}{key}: {_inline(x)}")
        return
    for x in v:  # a list holding collections: one block item each
        if isinstance(x, dict) and x:
            sub: List[str] = []
            _dump(x, indent + 2, sub)
            out.append(f"{pad}- {sub[0].lstrip()}")
            out.extend(sub[1:])
        elif isinstance(x, (list, tuple)) and x and not all(_is_scalar(e) for e in x):
            sub = []
            _dump(list(x), indent + 2, sub)
            out.append(f"{pad}- {sub[0].lstrip()}")
            out.extend(sub[1:])
        else:
            out.append(f"{pad}- {_inline(x)}")


def _inline(v: Any) -> str:
    if isinstance(v, dict):
        return "{" + ", ".join(f"{_scalar(k)}: {_inline(x)}" for k, x in v.items()) + "}"
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_inline(x) for x in v) + "]"
    return _scalar(v)


def dump(data: Any) -> str:
    """YAML text that PyYAML's ``safe_load`` (and :func:`load`) read back as
    ``data``: dicts, lists/tuples (read back as lists), str, int, float,
    bool and None."""
    if not isinstance(data, (dict, list, tuple)) or not data:
        return _inline(data) + "\n"
    out: List[str] = []
    _dump(data if isinstance(data, dict) else list(data), 0, out)
    return "\n".join(out) + "\n"
