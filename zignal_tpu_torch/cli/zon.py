"""Minimal ZON (Zig Object Notation) reader for pipeline recipes
(reference: src/cli/pipeline.zig parses recipes with std.zon).

Supports the subset recipes use: anonymous structs `.{ ... }` (maps or
lists), `.field = value`, enum literals `.name`, strings, numbers,
booleans, and null. Enum literals parse to their bare name string.

Copied from zignal_tpu/cli/zon.py.
"""

from __future__ import annotations

import re

__all__ = ["parse_zon"]

_TOKEN = re.compile(
    r"""
    \s+
  | //[^\n]*
  | (?P<lbrace>\.\{)
  | (?P<rbrace>\})
  | (?P<comma>,)
  | (?P<eq>=)
  | (?P<string>"(?:[^"\\]|\\.)*")
  | (?P<number>-?\d+(?:\.\d+)?(?:[eE][+-]?\d+)?)
  | (?P<field>\.[A-Za-z_][A-Za-z0-9_]*)
  | (?P<word>[A-Za-z_][A-Za-z0-9_]*)
    """,
    re.VERBOSE,
)


class _Tokens:
    def __init__(self, text: str):
        self.toks = []
        pos = 0
        while pos < len(text):
            m = _TOKEN.match(text, pos)
            if not m:
                raise ValueError(f"bad ZON syntax at offset {pos}: {text[pos:pos+20]!r}")
            pos = m.end()
            kind = m.lastgroup
            if kind:
                self.toks.append((kind, m.group()))
        self.i = 0

    def peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else (None, None)

    def next(self):
        tok = self.peek()
        self.i += 1
        return tok


def _parse_value(t: _Tokens):
    kind, text = t.next()
    if kind == "lbrace":
        return _parse_struct(t)
    if kind == "string":
        return text[1:-1].encode().decode("unicode_escape")
    if kind == "number":
        return float(text) if ("." in text or "e" in text or "E" in text) else int(text)
    if kind == "field":  # enum literal like .gaussian
        return text[1:]
    if kind == "word":
        if text == "true":
            return True
        if text == "false":
            return False
        if text == "null":
            return None
        raise ValueError(f"unexpected identifier {text!r}")
    raise ValueError(f"unexpected token {text!r}")


def _parse_struct(t: _Tokens):
    items = []
    fields = {}
    while True:
        kind, text = t.peek()
        if kind == "rbrace":
            t.next()
            break
        if kind == "comma":
            t.next()
            continue
        if kind == "field":
            nk, _ = t.toks[t.i + 1] if t.i + 1 < len(t.toks) else (None, None)
            if nk == "eq":
                t.next()  # field
                t.next()  # =
                fields[text[1:]] = _parse_value(t)
                continue
        items.append(_parse_value(t))
    if fields and items:
        raise ValueError("ZON struct mixes named fields and positional values")
    return fields if fields else items


def parse_zon(text: str):
    t = _Tokens(text)
    return _parse_value(t)
