"""A reader for the subset of YAML that the configuration files use.

The card's machine has no PyYAML, and the JAX package reads its config
files and its `--k=[...]` / `--k={...}` flag values with `yaml.safe_load`
(`oovrec_tpu/config/configurator.py:91-93, 226-248`). `load` gives what
`yaml.safe_load` gives on that subset:

  * block mappings nested by indentation, block sequences of scalars and
    flow collections (`[...]`, `{...}`, nested, over several lines);
  * plain scalars resolved as PyYAML's SafeLoader resolves them (YAML
    1.1): `yes/no/on/off/true/false` in three casings are booleans, `~`,
    `null` and the empty value are None, integers in decimal, octal
    (`0o`-less `017`), hex, binary and base 60, floats only with a dot
    (`1e-05` stays a string, `1.0e-5` is a float, `1.0e5` a string) or
    `.inf` / `.nan`;
  * single-quoted (`''` escapes a quote) and double-quoted scalars with
    PyYAML's backslash escapes; quoted keys, and a value indicator right
    after a quoted key in a flow mapping (`{"a":1}`);
  * comments after `#` at a line's start or after whitespace.

Anything else (anchors and aliases, tags, block scalars `|` / `>`,
multi-line plain or quoted scalars, complex keys, several documents,
timestamps) raises `YamlSubsetError` rather than being read differently.
"""

from __future__ import annotations

import math
import re
from typing import Any, List, Optional, Tuple

_BOOL = {
    "yes": True, "Yes": True, "YES": True, "no": False, "No": False, "NO": False,
    "true": True, "True": True, "TRUE": True, "false": False, "False": False,
    "FALSE": False, "on": True, "On": True, "ON": True, "off": False, "Off": False,
    "OFF": False,
}
_NULL = {"~", "null", "Null", "NULL", ""}
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
    |[-+]?0[0-7_]+
    |[-+]?(?:0|[1-9][0-9_]*)
    |[-+]?0x[0-9a-fA-F_]+
    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""", re.X)
_TIMESTAMP = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?")
_ESCAPES = {
    "0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t", "n": "\n",
    "v": "\x0b", "f": "\x0c", "r": "\r", "e": "\x1b", " ": " ", '"': '"',
    "\\": "\\", "/": "/", "N": "\x85", "_": "\xa0", "L": "\u2028", "P": "\u2029",
}
_ESCAPE_CODES = {"x": 2, "u": 4, "U": 8}
_FLOW_END = ",[]{}"


class YamlSubsetError(ValueError):
    """The text is not YAML, or uses YAML beyond the subset this reads."""


def _sexagesimal(digits: str, base_type):
    value = 0
    for part in digits.split(":"):
        value = value * 60 + base_type(part)
    return value


def resolve_plain(text: str) -> Any:
    """The value of a plain (unquoted) scalar, as SafeLoader resolves it."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _FLOAT.match(text):
        v = text.replace("_", "").lower()
        sign = -1 if v[0] == "-" else 1
        if v[0] in "+-":
            v = v[1:]
        if v == ".inf":
            return sign * math.inf
        if v == ".nan":
            return math.nan
        if ":" in v:
            return sign * _sexagesimal(v, float)
        return sign * float(v)
    if _INT.match(text):
        v = text.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        if v[0] in "+-":
            v = v[1:]
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if v[0] == "0":
            return sign * int(v, 8)
        if ":" in v:
            return sign * _sexagesimal(v, int)
        return sign * int(v)
    if _TIMESTAMP.match(text):
        raise YamlSubsetError(f"timestamp scalar {text!r} is outside the subset")
    return text


def _quote_starts(line: str, i: int) -> bool:
    """Whether a quote at `line[i]` opens a quoted scalar (and is not a
    character inside a plain one, as in `it's`)."""
    return i == 0 or line[i - 1] in " \t[{,:-"


def _strip_comment(line: str) -> str:
    """`line` without its comment, quotes respected."""
    i, quote = 0, None
    while i < len(line):
        c = line[i]
        if quote == "'":
            if c == "'":
                if i + 1 < len(line) and line[i + 1] == "'":
                    i += 1
                else:
                    quote = None
        elif quote == '"':
            if c == "\\":
                i += 1
            elif c == '"':
                quote = None
        elif c in "'\"" and _quote_starts(line, i):
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
        i += 1
    return line


class _Flow:
    """A scanner over one flow-context or scalar text."""

    def __init__(self, text: str):
        self.s = text
        self.i = 0

    def ws(self) -> None:
        while self.i < len(self.s) and self.s[self.i] in " \t\n":
            self.i += 1

    def peek(self) -> str:
        return self.s[self.i] if self.i < len(self.s) else ""

    def quoted(self) -> str:
        q = self.s[self.i]
        self.i += 1
        out: List[str] = []
        while True:
            if self.i >= len(self.s):
                raise YamlSubsetError(f"unterminated quoted scalar in {self.s!r}")
            c = self.s[self.i]
            if c == "\n":
                raise YamlSubsetError("multi-line quoted scalars are outside the subset")
            if q == "'":
                if c == "'":
                    if self.s[self.i + 1: self.i + 2] == "'":
                        out.append("'")
                        self.i += 2
                        continue
                    self.i += 1
                    return "".join(out)
                out.append(c)
                self.i += 1
                continue
            if c == '"':
                self.i += 1
                return "".join(out)
            if c == "\\":
                e = self.s[self.i + 1: self.i + 2]
                if e in _ESCAPES:
                    out.append(_ESCAPES[e])
                    self.i += 2
                elif e in _ESCAPE_CODES:
                    n = _ESCAPE_CODES[e]
                    code = self.s[self.i + 2: self.i + 2 + n]
                    if len(code) != n or not re.fullmatch(r"[0-9a-fA-F]+", code):
                        raise YamlSubsetError(f"bad escape in {self.s!r}")
                    out.append(chr(int(code, 16)))
                    self.i += 2 + n
                else:
                    raise YamlSubsetError(f"unknown escape \\{e} in {self.s!r}")
                continue
            out.append(c)
            self.i += 1

    def plain(self, flow: bool) -> str:
        """A plain scalar's text: it ends at a flow indicator (in flow
        context), at ': ' and at ' #'."""
        start = self.i
        s = self.s
        while self.i < len(s):
            c = s[self.i]
            nxt = s[self.i + 1: self.i + 2]
            if flow and c in _FLOW_END:
                break
            if c == ":" and (nxt in ("", " ", "\t", "\n") or (flow and nxt in _FLOW_END)):
                break
            if c == "#" and self.i > start and s[self.i - 1] in " \t":
                break
            self.i += 1
        return s[start:self.i].strip()

    def node(self, flow: bool) -> Any:
        self.ws()
        c = self.peek()
        if c == "[":
            return self.sequence()
        if c == "{":
            return self.mapping()
        if c in ("'", '"'):
            return self.quoted()
        if c and c in "&*!|>%@`":
            raise YamlSubsetError(f"{c!r} (anchor, alias, tag or block scalar) is outside the subset")
        text = self.plain(flow)
        return resolve_plain(text)

    def key(self) -> Tuple[Any, bool]:
        """(key, quoted) of a flow-mapping entry."""
        self.ws()
        c = self.peek()
        if c in ("'", '"'):
            return self.quoted(), True
        if c in "[{?":
            raise YamlSubsetError("complex flow keys are outside the subset")
        return resolve_plain(self.plain(flow=True)), False

    def sequence(self) -> list:
        self.i += 1  # '['
        out = []
        while True:
            self.ws()
            if self.peek() == "]":
                self.i += 1
                return out
            item = self.node(flow=True)
            self.ws()
            if self.peek() == ":":
                raise YamlSubsetError("single-pair mappings in a flow sequence are outside the subset")
            out.append(item)
            self.ws()
            c = self.peek()
            if c == ",":
                self.i += 1
            elif c != "]":
                raise YamlSubsetError(f"expected ',' or ']' in {self.s!r}")

    def mapping(self) -> dict:
        self.i += 1  # '{'
        out = {}
        while True:
            self.ws()
            if self.peek() == "}":
                self.i += 1
                return out
            key, _ = self.key()
            self.ws()
            if self.peek() == ":":
                self.i += 1
                self.ws()
                value = None if self.peek() in (",", "}") else self.node(flow=True)
            else:
                value = None
            out[key] = value
            self.ws()
            c = self.peek()
            if c == ",":
                self.i += 1
            elif c != "}":
                raise YamlSubsetError(f"expected ',' or '}}' in {self.s!r}")

    def end(self) -> None:
        self.ws()
        if self.i != len(self.s):
            raise YamlSubsetError(f"unexpected text {self.s[self.i:]!r}")


def _value(text: str) -> Any:
    """A block-context value: one scalar or one flow collection."""
    f = _Flow(text)
    if text.startswith("- ") or text == "-":
        raise YamlSubsetError("a block sequence on a key's line is outside the subset")
    v = f.node(flow=False)
    if isinstance(v, str) and f.peek() == ":":
        raise YamlSubsetError(f"mapping values are not allowed here: {text!r}")
    f.end()
    return v


def _flow_complete(text: str) -> bool:
    """Whether the brackets of a flow collection close within `text`."""
    depth, quote, i = 0, None, 0
    while i < len(text):
        c = text[i]
        if quote:
            if c == "\\" and quote == '"':
                i += 1
            elif c == quote:
                quote = None
        elif c in "'\"" and _quote_starts(text, i):
            quote = c
        elif c in "[{":
            depth += 1
        elif c in "]}":
            depth -= 1
        i += 1
    return depth <= 0


class _Block:
    def __init__(self, lines: List[Tuple[int, str]]):
        self.lines = lines  # (indent, content) of every non-empty line
        self.i = 0

    def _flow_text(self, first: str) -> str:
        """A flow value that may continue over the next lines."""
        text = first
        while not _flow_complete(text):
            if self.i >= len(self.lines):
                raise YamlSubsetError("unterminated flow collection")
            text += " " + self.lines[self.i][1]
            self.i += 1
        return text

    def node(self, indent: int) -> Any:
        ind, content = self.lines[self.i]
        if content.startswith("- ") or content == "-":
            return self.sequence(ind)
        return self.mapping(ind)

    def sequence(self, indent: int) -> list:
        out = []
        while self.i < len(self.lines):
            ind, content = self.lines[self.i]
            if ind != indent or not (content.startswith("- ") or content == "-"):
                break
            self.i += 1
            rest = content[1:].strip()
            if not rest:
                raise YamlSubsetError("nested block collections in a sequence are outside the subset")
            if rest[0] in "[{":
                rest = self._flow_text(rest)
            elif _split_key(rest) is not None:
                raise YamlSubsetError("mappings inside a block sequence are outside the subset")
            out.append(_value(rest))
        if self.i < len(self.lines) and self.lines[self.i][0] > indent:
            raise YamlSubsetError("multi-line scalars are outside the subset")
        return out

    def mapping(self, indent: int) -> dict:
        out = {}
        while self.i < len(self.lines):
            ind, content = self.lines[self.i]
            if ind < indent:
                break
            if ind > indent:
                raise YamlSubsetError(f"unexpected indentation at {content!r} "
                                      "(multi-line scalars are outside the subset)")
            split = _split_key(content)
            if split is None:
                raise YamlSubsetError(f"expected 'key: value', got {content!r}")
            key, rest = split
            self.i += 1
            if rest:
                if rest[0] in "[{":
                    rest = self._flow_text(rest)
                out[key] = _value(rest)
                continue
            nxt = self.lines[self.i] if self.i < len(self.lines) else None
            if nxt is not None and (nxt[0] > indent or (
                    nxt[0] == indent and (nxt[1].startswith("- ") or nxt[1] == "-"))):
                out[key] = self.node(nxt[0])
            else:
                out[key] = None
        return out


def _split_key(content: str) -> Optional[Tuple[Any, str]]:
    """(key, value text) of a block mapping line, None if it has no
    key."""
    f = _Flow(content)
    if content[0] in ("'", '"'):
        key = f.quoted()
        f.ws()
        if f.peek() != ":":
            return None
    else:
        if content[0] in "[{?&*!|>%@`":
            return None
        text = f.plain(flow=False)
        if f.peek() != ":":
            return None
        key = resolve_plain(text)
    f.i += 1
    rest = content[f.i:]
    if rest and rest[0] not in " \t":
        return None
    return key, rest.strip()


def load(text: str) -> Any:
    """`yaml.safe_load(text)` for a text within the subset."""
    lines: List[Tuple[int, str]] = []
    for raw in text.splitlines():
        body = _strip_comment(raw).rstrip()
        if not body.strip():
            continue
        stripped = body.lstrip(" ")
        if stripped.startswith("\t"):
            raise YamlSubsetError("tabs in indentation are not YAML")
        lines.append((len(body) - len(stripped), stripped))
    if lines and lines[0] == (0, "---"):
        lines = lines[1:]
    if any(c in ("---", "...") and ind == 0 for ind, c in lines):
        raise YamlSubsetError("several documents are outside the subset")
    if not lines:
        return None
    first = lines[0][1]
    if first[0] in "[{" or (_split_key(first) is None
                             and not (first.startswith("- ") or first == "-")):
        # one flow collection or one scalar
        f = _Flow(" ".join(c for _, c in lines))
        v = f.node(flow=False)
        f.end()
        return v
    block = _Block(lines)
    v = block.node(lines[0][0])
    if block.i != len(lines):
        raise YamlSubsetError(f"unexpected text at {lines[block.i][1]!r}")
    return v


def load_file(path: str) -> Any:
    with open(path, encoding="utf-8") as f:
        return load(f.read())
