"""The port's YAML reader and writer, for the subset its own files use.

The card's host has no PyYAML, so the dataset registry
(`data/registry/`) and the eval registry (`eval/registry.yaml`) are read
here. The subset:
  * block mappings and block lists (a list may sit at its key's indent);
  * plain, single- and double-quoted one-line scalars;
  * plain scalars resolved as PyYAML's `safe_load` resolves them (YAML
    1.1): null (`~`, `null`, empty), booleans (`true`, `yes`, `on`, ...),
    decimal ints and floats (`1.5`, `.inf`, `.nan`); `${VAR}` stays text;
  * flow lists of plain or quoted scalars (`[local, core]`);
  * `>` and `>-` folded blocks;
  * comments.
Anything else (anchors, aliases, tags, flow mappings, literal blocks,
lists of mappings, several documents, a scalar that `safe_load` would read
as an octal, hex, sexagesimal or date) raises `ValueError` naming the line,
so a file never reads differently here than under `safe_load`.

`dump` writes dicts, lists and scalars back in the same subset.
"""

from __future__ import annotations

import math
import re
from typing import Any, List, Optional, Tuple

# PyYAML's implicit resolvers (resolver.py), restricted to the forms kept
_BOOL = {
    **{s: True for s in ("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON")},
    **{s: False for s in ("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF")},
}
_NULL = ("~", "null", "Null", "NULL", "")
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?")
_INF = re.compile(r"[-+]?\.(?:inf|Inf|INF)")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)")
# what safe_load reads as something this reader does not produce
_OTHER = re.compile(
    r"[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?0x[0-9a-fA-F_]+"  # binary, octal, hex
    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?"  # sexagesimal
    r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}.*"  # timestamps
    r"|<<|=")  # merge keys, value keys
_INDICATORS = "-?:,[]{}#&*!|>'\"%@`"
_ESCAPES = {"\\": "\\", '"': '"', "/": "/", "n": "\n", "t": "\t", "r": "\r", "0": "\0"}


class _Line:
    __slots__ = ("no", "indent", "text")

    def __init__(self, no: int, indent: int, text: str) -> None:
        self.no, self.indent, self.text = no, indent, text


def _fail(no: int, what: str):
    raise ValueError(f"line {no}: {what} is outside the YAML subset this reader takes")


def _strip_comment(text: str) -> str:
    """`text` without a trailing comment (a `#` at the start or after a
    space, outside quotes)."""
    quote = None
    for i, ch in enumerate(text):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and (i == 0 or text[i - 1] in " [,:"):
            quote = ch
        elif ch == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
    return text.rstrip()


def _resolve(text: str, no: int) -> Any:
    """A plain scalar's value, as `safe_load` resolves it."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.fullmatch(text):
        return int(text.replace("_", ""))
    if _FLOAT.fullmatch(text):
        return float(text.replace("_", ""))
    if _INF.fullmatch(text):
        return -math.inf if text[0] == "-" else math.inf
    if _NAN.fullmatch(text):
        return math.nan
    if _OTHER.fullmatch(text):
        _fail(no, f"the scalar {text!r}")
    return text


def _scalar(text: str, no: int, flow: bool = False) -> Any:
    """One scalar: quoted, or plain and resolved."""
    if not text:
        return None
    if text[0] == "'":
        if len(text) < 2 or text[-1] != "'" or "'" in text[1:-1].replace("''", ""):
            _fail(no, f"the quoted scalar {text}")
        return text[1:-1].replace("''", "'")
    if text[0] == '"':
        if len(text) < 2 or text[-1] != '"':
            _fail(no, f"the quoted scalar {text}")
        out, i, body = [], 0, text[1:-1]
        while i < len(body):
            ch = body[i]
            if ch == '"':
                _fail(no, f"the quoted scalar {text}")
            if ch == "\\":
                esc = body[i + 1:i + 2]
                if esc not in _ESCAPES:
                    _fail(no, f"the escape \\{esc}")
                out.append(_ESCAPES[esc])
                i += 2
                continue
            out.append(ch)
            i += 1
        return "".join(out)
    if text[0] in _INDICATORS and not (text[0] in "-?:" and len(text) > 1
                                       and text[1] not in " "):
        _fail(no, f"the scalar {text!r}")
    if ": " in text or text.endswith(":") or (flow and any(c in text for c in ",[]{}")):
        _fail(no, f"the scalar {text!r}")
    return _resolve(text, no)


def _flow_list(text: str, no: int) -> List[Any]:
    body = text[1:-1].strip()
    if not body:
        return []
    items, item, quote = [], [], None
    for ch in body:
        if quote:
            item.append(ch)
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
            item.append(ch)
        elif ch == ",":
            items.append("".join(item).strip())
            item = []
        else:
            item.append(ch)
    items.append("".join(item).strip())
    if any(not i for i in items):
        _fail(no, f"the flow list {text}")
    return [_scalar(i, no, flow=True) for i in items]


def _value(text: str, no: int) -> Any:
    """The value written after `key:` or `- ` on the same line."""
    if text.startswith("["):
        if not text.endswith("]"):
            _fail(no, f"the flow list {text}")
        return _flow_list(text, no)
    return _scalar(text, no)


def _split_key(text: str, no: int) -> Optional[Tuple[Any, str]]:
    """(key, rest) of a `key: value` / `key:` line, or None."""
    if text[0] in "'\"":
        end = text.find(text[0], 1)
        while text[0] == "'" and end != -1 and text[end + 1:end + 2] == "'":
            end = text.find("'", end + 2)
        if end == -1 or text[end + 1:end + 2] != ":":
            return None
        key, rest = _scalar(text[:end + 1], no), text[end + 2:]
    else:
        m = re.search(r":(?: |$)", text)
        if not m:
            return None
        key, rest = _scalar(text[:m.start()], no), text[m.start() + 1:]
    if rest and rest[0] != " ":
        _fail(no, f"the key line {text!r}")
    return key, rest.strip()


class _Parser:
    def __init__(self, raw: List[str]) -> None:
        self.raw = raw
        self.lines: List[_Line] = []
        self.i = 0
        no = 0
        while no < len(raw):
            line = raw[no]
            no += 1
            body = line.lstrip(" ")
            if body.startswith("\t"):
                _fail(no, "a tab in the indentation")
            text = _strip_comment(body)
            if not text:
                continue
            if text in ("---", "...") or text.startswith(("--- ", "%")):
                _fail(no, f"the marker {text!r}")
            self.lines.append(_Line(no, len(line) - len(body), text))

    def _peek(self) -> Optional[_Line]:
        return self.lines[self.i] if self.i < len(self.lines) else None

    def parse(self) -> Any:
        if not self.lines:
            return None
        first = self.lines[0]
        if first.indent:
            _fail(first.no, "an indented first line")
        if first.text.startswith("- ") or first.text == "-":
            out = self._list(0)
        elif _split_key(first.text, first.no) is not None:
            out = self._map(0)
        else:
            self.i = 1
            out = _value(first.text, first.no)
        rest = self._peek()
        if rest is not None:
            _fail(rest.no, "a line after the document's end")
        return out

    def _nested(self, parent_indent: int, is_map_value: bool) -> Any:
        """The block under a `key:` (or `-`) with nothing after it."""
        nxt = self._peek()
        if nxt is None or nxt.indent < parent_indent:
            return None
        if nxt.indent == parent_indent:
            # a block list may sit at its key's indent
            if is_map_value and (nxt.text.startswith("- ") or nxt.text == "-"):
                return self._list(parent_indent)
            return None
        if nxt.text.startswith("- ") or nxt.text == "-":
            return self._list(nxt.indent)
        if _split_key(nxt.text, nxt.no) is not None:
            return self._map(nxt.indent)
        _fail(nxt.no, "a multi-line plain scalar")

    def _folded(self, header: str, parent_indent: int, no: int) -> str:
        if header not in (">", ">-"):
            _fail(no, f"the block scalar header {header!r}")
        # the block's lines come from the raw text: comments are content there
        lines, indent = [], None
        k = no  # raw index of the line after the header
        while k < len(self.raw):
            line = self.raw[k]
            body = line.lstrip(" ")
            ind = len(line) - len(body)
            if body.strip() == "":
                if line and (indent is None or len(line) > indent):
                    _fail(k + 1, "a blank line with spaces in a folded block")
                lines.append("")
                k += 1
                continue
            if indent is None:
                if ind <= parent_indent:
                    break
                indent = ind
            if ind < indent:
                break
            if ind > indent or body.startswith("\t"):
                _fail(k + 1, "a more-indented line in a folded block")
            lines.append(body.rstrip(" "))
            k += 1
        while self.i < len(self.lines) and self.lines[self.i].no <= k:
            self.i += 1
        while lines and lines[-1] == "":
            lines.pop()
        out, blank = "", 0
        for j, text in enumerate(lines):
            if text == "":
                blank += 1
                continue
            if j and out:
                out += "\n" * blank if blank else " "
            elif blank:
                out += "\n" * blank
            out += text
            blank = 0
        return out if header == ">-" or not out else out + "\n"

    def _after(self, rest: str, line: _Line, indent: int, is_map_value: bool) -> Any:
        if rest.startswith(">") or rest.startswith("|"):
            if rest.startswith("|"):
                _fail(line.no, "a literal block")
            return self._folded(rest, indent, line.no)
        if rest:
            if rest[0] in "&*!{":
                _fail(line.no, f"the value {rest!r}")
            return _value(rest, line.no)
        return self._nested(indent, is_map_value)

    def _map(self, indent: int) -> dict:
        out: dict = {}
        while True:
            line = self._peek()
            if line is None or line.indent < indent:
                return out
            if line.indent > indent:
                _fail(line.no, "an unexpected indent")
            if line.text.startswith("- ") or line.text == "-":
                return out
            kv = _split_key(line.text, line.no)
            if kv is None:
                _fail(line.no, f"the line {line.text!r}")
            key, rest = kv
            if line.text[0] in "?&*!{[":
                _fail(line.no, f"the key {line.text!r}")
            self.i += 1
            out[key] = self._after(rest, line, indent, True)

    def _list(self, indent: int) -> list:
        out: list = []
        while True:
            line = self._peek()
            if line is None or line.indent < indent:
                return out
            if line.indent > indent:
                _fail(line.no, "an unexpected indent")
            if not (line.text.startswith("- ") or line.text == "-"):
                return out
            rest = line.text[2:].strip()
            if rest.startswith("- ") or rest == "-" or (
                    rest and rest[0] not in "'\"[" and _split_key(rest, line.no) is not None):
                _fail(line.no, "a nested item in a block list")
            self.i += 1
            out.append(self._after(rest, line, indent, False))


def loads(text: str) -> Any:
    """The value of a YAML document in the subset; `ValueError` otherwise."""
    return _Parser(text.splitlines()).parse()


def load_file(path: str) -> Any:
    with open(path) as f:
        return loads(f.read())


# --------------------------------------------------------------------------
# Writing
# --------------------------------------------------------------------------


def _dump_scalar(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v)
        if "." not in text:  # 1e-05 would read back as text
            mant, _, exp = text.partition("e")
            text = f"{mant}.0" + (f"e{exp if exp[0] in '+-' else '+' + exp}" if exp else "")
        return text
    if not isinstance(v, str):
        raise ValueError(f"cannot write {type(v).__name__} in the YAML subset")
    plain_ok = (v == v.strip() and v and "\n" not in v and "\t" not in v
                and v[0] not in _INDICATORS and ": " not in v and " #" not in v
                and not v.endswith(":"))
    if plain_ok:
        try:
            if _resolve(v, 0) == v:
                return v
        except ValueError:
            pass
    if "\n" in v or "\r" in v or "\t" in v or "\0" in v:
        esc = {"\\": "\\\\", '"': '\\"', "\n": "\\n", "\t": "\\t", "\r": "\\r", "\0": "\\0"}
        return '"' + "".join(esc.get(c, c) for c in v) + '"'
    return "'" + v.replace("'", "''") + "'"


def _dump(obj: Any, indent: int, out: List[str]) -> None:
    pad = " " * indent
    if isinstance(obj, dict):
        for k, v in obj.items():
            key = _dump_scalar(k)
            if isinstance(v, dict) and v:
                out.append(f"{pad}{key}:")
                _dump(v, indent + 2, out)
            elif isinstance(v, list) and v:
                out.append(f"{pad}{key}:")
                _dump(v, indent + 2, out)
            elif isinstance(v, (dict, list)):
                if isinstance(v, dict):
                    raise ValueError("an empty mapping is outside the YAML subset")
                out.append(f"{pad}{key}: []")
            else:
                out.append(f"{pad}{key}: {_dump_scalar(v)}")
    elif isinstance(obj, list):
        for v in obj:
            if isinstance(v, (dict, list)):
                raise ValueError("a list of mappings or lists is outside the YAML subset")
            out.append(f"{pad}- {_dump_scalar(v)}")
    else:
        out.append(pad + _dump_scalar(obj))


def dump(obj: Any) -> str:
    """`obj` (dicts, lists of scalars, scalars) as YAML text in the subset."""
    if isinstance(obj, (dict, list)) and not obj:
        if isinstance(obj, dict):
            raise ValueError("an empty mapping is outside the YAML subset")
        return "[]\n"
    out: List[str] = []
    _dump(obj, 0, out)
    return "\n".join(out) + "\n"
