"""A small YAML reader and writer for the recipe configs, without PyYAML.

The card's machine has no PyYAML. :func:`safe_load` reads the subset that
the shipped configs under ``config/`` use, and gives what ``yaml.safe_load``
gives for it: block mappings and sequences, flow lists and mappings (which
may run over several lines), comments, single- and double-quoted scalars,
and plain scalars resolved by YAML 1.1's rules as PyYAML applies them
(``1e-4`` stays a string, ``1.0e-4`` is a float, ``yes`` and ``off`` are
booleans, ``0o17`` is a string but ``017`` is octal). Anything outside the
subset raises ``ValueError``: anchors, aliases, tags, block scalars (``|``,
``>``), multi-line plain or quoted scalars, complex keys, documents and
directives, and timestamps.

:func:`safe_dump` writes block mappings with flow lists; every string that
would read back as another type, or that holds an indicator, is quoted.
Its output reads back to the same data under this reader and PyYAML's.
"""

from __future__ import annotations

import math
import re
from typing import Any, List, Tuple

_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
# PyYAML's implicit resolvers (resolver.py), YAML 1.1
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
    |[-+]?0[0-7_]+
    |[-+]?(?:0|[1-9][0-9_]*)
    |[-+]?0x[0-9a-fA-F_]+
    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
    |\.[0-9_]+(?:[eE][-+][0-9]+)?
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""", re.X)
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
    |[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?
    (?:[Tt]|[ \t]+)[0-9][0-9]?
    :[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?
    (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
            "N": "\x85", "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}
_FLOW = ",[]{}"


def _sexagesimal(value: str, cast):
    total, base = cast(0), 1
    for part in reversed(value.split(":")):
        total += cast(part) * base
        base *= 60
    return total


def _resolve(text: str) -> Any:
    """A plain scalar as ``yaml.safe_load`` constructs it."""
    if text in _NULL:
        return None
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if _INT.match(text):
        value = text.replace("_", "")
        sign = -1 if value[0] == "-" else 1
        if value[0] in "+-":
            value = value[1:]
        if value == "0":
            return 0
        if value.startswith("0b"):
            return sign * int(value[2:], 2)
        if value.startswith("0x"):
            return sign * int(value[2:], 16)
        if ":" in value:
            return sign * _sexagesimal(value, int)
        if value[0] == "0":
            return sign * int(value, 8)
        return sign * int(value)
    if _FLOAT.match(text):
        value = text.replace("_", "").lower()
        sign = -1.0 if value[0] == "-" else 1.0
        if value[0] in "+-":
            value = value[1:]
        if value == ".inf":
            return sign * math.inf
        if value == ".nan":
            return math.nan
        if ":" in value:
            return sign * _sexagesimal(value, float)
        return sign * float(value)
    if _TIMESTAMP.match(text) or text in ("<<", "="):
        raise ValueError(f"{text!r}: timestamps, merge keys and '=' are not read")
    return text


class _Flow:
    """Recursive-descent reader of one flow node (``[...]``, ``{...}`` or a
    scalar) in ``text`` from ``pos``."""

    def __init__(self, text: str, where: str):
        self.text, self.pos, self.where = text, 0, where

    def fail(self, what: str):
        raise ValueError(f"{self.where}: {what} at column {self.pos + 1} of {self.text!r}")

    def skip(self) -> str:
        while self.pos < len(self.text) and self.text[self.pos] in " \t":
            self.pos += 1
        return self.text[self.pos] if self.pos < len(self.text) else ""

    def node(self) -> Any:
        c = self.skip()
        if c == "[":
            return self.collection("]", self.node)
        if c == "{":
            return dict(self.collection("}", self.pair))
        if c in ("'", '"'):
            value, self.pos = _quoted(self.text, self.pos, self.where)
            return value
        return _resolve(self.plain())

    def pair(self) -> Tuple[Any, Any]:
        key = self.node()
        if self.skip() != ":":
            self.fail("expected ':' in a flow mapping")
        self.pos += 1
        if self.skip() in (",", "}"):
            return key, None
        return key, self.node()

    def collection(self, close: str, item):
        self.pos += 1
        out = []
        while True:
            if self.skip() == close:
                self.pos += 1
                return out
            out.append(item())
            c = self.skip()
            if c == ",":
                self.pos += 1
            elif c != close:
                self.fail(f"expected ',' or {close!r}")

    def plain(self) -> str:
        start = self.pos
        c = self.text[start:start + 1]
        if not c or c in _FLOW or c in "#&*!|>%@`" or (c in "-?:" and self._spaced(start + 1)):
            self.fail("unsupported or empty flow scalar")
        while self.pos < len(self.text):
            c = self.text[self.pos]
            if c in _FLOW or (c == ":" and self._spaced(self.pos + 1)):
                break
            self.pos += 1
        return self.text[start:self.pos].strip()

    def _spaced(self, i: int) -> bool:
        return i >= len(self.text) or self.text[i] in " \t" + _FLOW


def _quoted(text: str, pos: int, where: str) -> Tuple[str, int]:
    """A single- or double-quoted scalar starting at ``pos`` -> (value, end)."""
    quote, out, i = text[pos], [], pos + 1
    while i < len(text):
        c = text[i]
        if quote == "'" and c == "'":
            if text[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        if quote == '"' and c == '"':
            return "".join(out), i + 1
        if quote == '"' and c == "\\":
            e = text[i + 1:i + 2]
            if e in _ESCAPES:
                out.append(_ESCAPES[e])
                i += 2
            elif e in _HEX_ESCAPES:
                n = _HEX_ESCAPES[e]
                out.append(chr(int(text[i + 2:i + 2 + n], 16)))
                i += 2 + n
            else:
                raise ValueError(f"{where}: unknown escape \\{e} in {text!r}")
            continue
        out.append(c)
        i += 1
    raise ValueError(f"{where}: a quoted scalar must end on its line: {text!r}")


def _strip_comment(line: str) -> str:
    """The line without its ``#`` comment (a ``#`` at the start or after a
    space, outside quotes)."""
    quote, escaped = None, False
    for i, c in enumerate(line):
        if escaped:
            escaped = False
        elif quote:
            if c == quote:
                quote = None
            escaped = c == "\\" and quote == '"'
        elif c in "'\"" and (i == 0 or line[i - 1] in " \t[{,:-"):
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _depth(text: str) -> int:
    """Open brackets minus closed ones, outside quotes."""
    depth, quote = 0, None
    for i, c in enumerate(text):
        if quote:
            if c == quote:
                quote = None
        elif c in "'\"" and (i == 0 or text[i - 1] in " \t[{,:"):
            quote = c
        elif c in "[{":
            depth += 1
        elif c in "]}":
            depth -= 1
    return depth


def _key_split(content: str):
    """(key text, rest) of a block mapping entry, or None: the first ':'
    followed by a space or the line's end, outside quotes and brackets."""
    quote, depth = None, 0
    for i, c in enumerate(content):
        if quote:
            if c == quote:
                quote = None
        elif c in "'\"" and i == 0:
            quote = c
        elif c in "[{":
            depth += 1
        elif c in "]}":
            depth -= 1
        elif c == ":" and depth == 0 and (i + 1 == len(content) or content[i + 1] in " \t"):
            return content[:i].rstrip(), content[i + 1:].strip()
    return None


class _Block:
    def __init__(self, text: str):
        self.lines: List[List] = []  # [indent, content, line number]
        for n, raw in enumerate(text.splitlines(), start=1):
            if "\t" in raw[:len(raw) - len(raw.lstrip())]:
                raise ValueError(f"line {n}: a tab in the indentation")
            content = _strip_comment(raw)
            if not content.strip():
                continue
            if content.startswith(("---", "...", "%")):
                raise ValueError(f"line {n}: documents and directives are not read")
            self.lines.append([len(content) - len(content.lstrip()), content.strip(), n])
        self.i = 0

    def where(self) -> str:
        return f"line {self.lines[min(self.i, len(self.lines) - 1)][2]}"

    def node(self, owner: int) -> Any:
        """The node on the current line; ``owner`` is the indentation of the
        entry or item that holds it (-1 for the document)."""
        indent, content, _ = self.lines[self.i]
        if content == "-" or content.startswith("- "):
            return self.sequence(indent)
        if _key_split(content) is not None and content[0] not in "[{":
            return self.mapping(indent)
        return self.inline(content, owner)

    def inline(self, text: str, owner: int) -> Any:
        """A scalar or flow value starting on the current line, which a flow
        value may continue on the lines after it."""
        where = self.where()
        self.i += 1
        if text[0] in "[{":
            while _depth(text) > 0 and self.i < len(self.lines):
                text += " " + self.lines[self.i][1]
                self.i += 1
        elif self.i < len(self.lines) and self.lines[self.i][0] > owner:
            raise ValueError(f"{where}: a scalar continued on the next line is not read")
        if text[0] in "&*!|>%@`" or (text[0] in "?" and text[1:2] in ("", " ")):
            raise ValueError(f"{where}: anchors, aliases, tags, block scalars and complex "
                             f"keys are not read: {text!r}")
        flow = _Flow(text, where)
        value = flow.node()
        if flow.skip():
            flow.fail("unexpected text after the value")
        return value

    def mapping(self, indent: int) -> dict:
        out = {}
        while self.i < len(self.lines) and self.lines[self.i][0] == indent:
            content = self.lines[self.i][1]
            split = _key_split(content)
            if split is None or content.startswith("- "):
                raise ValueError(f"{self.where()}: expected a mapping entry: {content!r}")
            key_text, rest = split
            if key_text.startswith("? "):
                raise ValueError(f"{self.where()}: complex keys are not read")
            key = _Flow(key_text, self.where()).node()
            if rest:
                out[key] = self.inline(rest, indent)
                continue
            self.i += 1
            nxt = self.lines[self.i] if self.i < len(self.lines) else None
            if nxt is not None and (nxt[0] > indent or (
                    nxt[0] == indent and (nxt[1] == "-" or nxt[1].startswith("- ")))):
                out[key] = self.node(indent)
            else:
                out[key] = None
        if self.i < len(self.lines) and self.lines[self.i][0] > indent:
            raise ValueError(f"{self.where()}: unexpected indentation")
        return out

    def sequence(self, indent: int) -> list:
        out = []
        while (self.i < len(self.lines) and self.lines[self.i][0] == indent
               and (self.lines[self.i][1] == "-" or self.lines[self.i][1].startswith("- "))):
            content = self.lines[self.i][1]
            item = content[1:].lstrip()
            if not item:
                self.i += 1
                nxt = self.lines[self.i] if self.i < len(self.lines) else None
                out.append(self.node(indent) if nxt is not None and nxt[0] > indent else None)
                continue
            # the item's text is a node of its own at its column
            self.lines[self.i][:2] = [indent + len(content) - len(item), item]
            out.append(self.node(indent))
        return out


def safe_load(text: str) -> Any:
    """``yaml.safe_load(text)`` for the subset above."""
    block = _Block(text)
    if not block.lines:
        return None
    value = block.node(-1)
    if block.i < len(block.lines):
        raise ValueError(f"{block.where()}: unexpected text after the document")
    return value


# -- writer ------------------------------------------------------------------


def _plain_ok(s: str) -> bool:
    if not s or s != s.strip() or not s.isprintable() or s[0] in "-?:,[]{}#&*!|>'\"%@`":
        return False
    if any(c in s for c in _FLOW) or ": " in s or " #" in s or s.endswith(":"):
        return False
    try:
        return _resolve(s) == s and isinstance(_resolve(s), str)
    except ValueError:
        return False


def _escape(c: str) -> str:
    if c in '"\\':
        return "\\" + c
    if c.isprintable():
        return c
    n = ord(c)
    return f"\\x{n:02x}" if n < 0x100 else f"\\u{n:04x}" if n < 0x10000 else f"\\U{n:08x}"


def _scalar(value) -> str:
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if math.isnan(value):
            return ".nan"
        if math.isinf(value):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value).lower()
        return text.replace("e", ".0e", 1) if "." not in text and "e" in text else text
    if isinstance(value, str):
        if _plain_ok(value):
            return value
        if value.isprintable():
            return "'" + value.replace("'", "''") + "'"
        return '"' + "".join(map(_escape, value)) + '"'
    raise TypeError(f"cannot write a {type(value).__name__} to YAML: {value!r}")


def _flow(value) -> str:
    if isinstance(value, list):
        return "[" + ", ".join(_flow(v) for v in value) + "]"
    if isinstance(value, dict):
        return "{" + ", ".join(f"{_scalar(k)}: {_flow(v)}" for k, v in value.items()) + "}"
    return _scalar(value)


def _block(value: dict, indent: int, out: List[str]) -> None:
    for key, v in value.items():
        head = " " * indent + _scalar(key) + ":"
        if isinstance(v, dict) and v:
            out.append(head)
            _block(v, indent + 2, out)
        else:
            out.append(head + " " + _flow(v))


def safe_dump(value) -> str:
    """YAML text for ``value`` (dicts, lists, str, int, float, bool, None),
    keys in their given order."""
    if isinstance(value, dict) and value:
        out: List[str] = []
        _block(value, 0, out)
        return "\n".join(out) + "\n"
    return _flow(value) + "\n"
