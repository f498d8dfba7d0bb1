"""Loader for the YAML subset that scenario files use, with no dependency.

Covers block mappings and block sequences by indentation, flow mappings
and flow sequences (``{a: 1}``, ``[x, y]``, nested, possibly spanning
lines), single- and double-quoted strings, comments, and plain scalars
resolved as YAML 1.1 does (PyYAML's ``safe_load``): ``1e-3`` without a
dot or a signed exponent stays a string, ``yes``/``no``/``on``/``off``
are booleans, ``~``/``null``/empty are None. Anchors, tags, multi-line
block scalars and multiple documents are refused.
"""

from __future__ import annotations

import re

_BOOL = {
    **{w: True for w in ("yes", "Yes", "YES", "true", "True", "TRUE", "on",
                         "On", "ON")},
    **{w: False for w in ("no", "No", "NO", "false", "False", "FALSE", "off",
                          "Off", "OFF")},
}
_NULL = {"", "~", "null", "Null", "NULL"}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_OCT = re.compile(r"[-+]?0[0-7_]+$")
_HEX = re.compile(r"[-+]?0x[0-9a-fA-F_]+$")
_FLOAT = re.compile(
    r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?$"
    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?$"
)
_INF = re.compile(r"[-+]?\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)$")


class YamlSubsetError(ValueError):
    pass


def _plain(s: str):
    s = s.strip()
    if s in _NULL:
        return None
    if s in _BOOL:
        return _BOOL[s]
    if _INT.match(s):
        return int(s.replace("_", ""))
    if _OCT.match(s):
        return int(s.replace("_", ""), 8)
    if _HEX.match(s):
        return int(s.replace("_", ""), 16)
    if _FLOAT.match(s):
        return float(s.replace("_", ""))
    if _INF.match(s):
        return float("-inf") if s.startswith("-") else float("inf")
    if _NAN.match(s):
        return float("nan")
    if s[:1] in ("&", "*", "!", "|", ">", "%", "@", "`"):
        raise YamlSubsetError(f"unsupported YAML construct: {s!r}")
    return s


def _quoted(s: str, i: int):
    """Parse the quoted string starting at s[i]; returns (value, next i)."""
    q = s[i]
    out = []
    i += 1
    while i < len(s):
        c = s[i]
        if q == "'" and c == "'":
            if s[i + 1 : i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        if q == '"' and c == "\\":
            nxt = s[i + 1 : i + 2]
            out.append({"n": "\n", "t": "\t", '"': '"', "\\": "\\",
                        "/": "/", "0": "\0"}.get(nxt, "\\" + nxt))
            i += 2
            continue
        if q == '"' and c == '"':
            return "".join(out), i + 1
        out.append(c)
        i += 1
    raise YamlSubsetError(f"unterminated string: {s!r}")


class _Flow:
    """Recursive-descent parser for one flow value."""

    def __init__(self, s):
        self.s = s
        self.i = 0

    def ws(self):
        while self.i < len(self.s) and self.s[self.i].isspace():
            self.i += 1

    def value(self):
        self.ws()
        c = self.s[self.i : self.i + 1]
        if c == "[":
            return self.seq()
        if c == "{":
            return self.mapping()
        if c in ("'", '"'):
            v, self.i = _quoted(self.s, self.i)
            return v
        start = self.i
        while self.i < len(self.s) and self.s[self.i] not in ",]}":
            if self.s[self.i] == ":" and self.s[self.i + 1 : self.i + 2] in (
                " ", ",", "]", "}", ""
            ):
                break
            self.i += 1
        return _plain(self.s[start : self.i])

    def seq(self):
        self.i += 1
        out = []
        while True:
            self.ws()
            if self.s[self.i : self.i + 1] == "]":
                self.i += 1
                return out
            out.append(self.value())
            self.ws()
            if self.s[self.i : self.i + 1] == ",":
                self.i += 1
            elif self.s[self.i : self.i + 1] != "]":
                raise YamlSubsetError(f"bad flow sequence: {self.s!r}")

    def mapping(self):
        self.i += 1
        out = {}
        while True:
            self.ws()
            if self.s[self.i : self.i + 1] == "}":
                self.i += 1
                return out
            key = self.value()
            self.ws()
            val = None
            if self.s[self.i : self.i + 1] == ":":
                self.i += 1
                self.ws()
                if self.s[self.i : self.i + 1] not in (",", "}"):
                    val = self.value()
            out[key] = val
            self.ws()
            if self.s[self.i : self.i + 1] == ",":
                self.i += 1
            elif self.s[self.i : self.i + 1] != "}":
                raise YamlSubsetError(f"bad flow mapping: {self.s!r}")


def _inline(text: str):
    text = text.strip()
    if text[:1] in ("[", "{"):
        p = _Flow(text)
        v = p.value()
        if text[p.i :].strip():
            raise YamlSubsetError(f"trailing text after flow value: {text!r}")
        return v
    if text[:1] in ("'", '"'):
        v, end = _quoted(text, 0)
        if text[end:].strip():
            raise YamlSubsetError(f"trailing text after string: {text!r}")
        return v
    return _plain(text)


def _strip_comment(line: str) -> str:
    q = None
    for k, c in enumerate(line):
        if q:
            if c == q:
                q = None
        elif c in ("'", '"') and (k == 0 or line[k - 1] in " \t:[{,-"):
            q = c
        elif c == "#" and (k == 0 or line[k - 1] in " \t"):
            return line[:k].rstrip()
    return line.rstrip()


def _split_key(content: str):
    """'key: value' -> (key, value text) or None when not a mapping entry."""
    if content[:1] in ("'", '"'):
        key, end = _quoted(content, 0)
        rest = content[end:]
        if rest.startswith(":") and (len(rest) == 1 or rest[1] == " "):
            return key, rest[1:]
        return None
    if content[:1] in ("[", "{"):
        return None
    m = re.match(r"([^:]*?[^\s:]|[^:\s]):(?: (.*)|$)", content)
    if not m:
        return None
    return _plain(m.group(1)), m.group(2) or ""


def _brackets_open(text: str) -> bool:
    depth, q = 0, None
    for c in text:
        if q:
            if c == q:
                q = None
        elif c in ("'", '"'):
            q = c
        elif c in "[{":
            depth += 1
        elif c in "]}":
            depth -= 1
    return depth > 0


def load(text: str):
    """Parse one YAML document of the supported subset."""
    lines = []
    for raw in text.splitlines():
        if raw.strip() in ("---", "..."):
            continue
        if "\t" in raw[: len(raw) - len(raw.lstrip())]:
            raise YamlSubsetError("tab indentation")
        content = _strip_comment(raw)
        if content.strip():
            lines.append((len(content) - len(content.lstrip()), content.strip()))
    if not lines:
        return None
    value, i = _block(lines, 0, lines[0][0])
    if i != len(lines):
        raise YamlSubsetError(f"unexpected line: {lines[i][1]!r}")
    return value


def _value_after(lines, i, indent, text):
    """Value of an entry whose inline part is ``text`` on line i-1: inline,
    a flow value continued over lines, or a nested block."""
    text = text.strip()
    if text:
        while _brackets_open(text) and i < len(lines):
            text += " " + lines[i][1]
            i += 1
        return _inline(text), i
    if i < len(lines) and (
        lines[i][0] > indent
        or (lines[i][0] == indent and lines[i][1].startswith("- "))
    ):
        return _block(lines, i, lines[i][0])
    return None, i


def _block(lines, i, indent):
    if lines[i][1] == "-" or lines[i][1].startswith("- "):
        out = []
        while i < len(lines) and lines[i][0] == indent and (
            lines[i][1] == "-" or lines[i][1].startswith("- ")
        ):
            item = lines[i][1][1:].strip()
            kv = _split_key(item) if item else None
            if kv is not None:
                # "- key: value": a mapping whose keys sit two columns in
                sub = indent + 2
                lines[i] = (sub, item)
                val, i = _block(lines, i, sub)
            else:
                val, i = _value_after(lines, i + 1, indent, item)
            out.append(val)
        return out, i
    out = {}
    while i < len(lines) and lines[i][0] == indent:
        kv = _split_key(lines[i][1])
        if kv is None:
            if len(lines) == 1 or i == 0 and len(out) == 0 and len(lines) == i + 1:
                return _inline(lines[i][1]), i + 1
            raise YamlSubsetError(f"expected 'key: value': {lines[i][1]!r}")
        key, rest = kv
        val, i = _value_after(lines, i + 1, indent, rest)
        out[key] = val
    if i < len(lines) and lines[i][0] > indent:
        raise YamlSubsetError(f"bad indentation: {lines[i][1]!r}")
    return out, i
