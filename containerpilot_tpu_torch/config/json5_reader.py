"""A JSON5 reader of the port's own.

The reference's loader parses configs with the ``json5`` package
(``containerpilot_tpu/config/loader.py``). The port depends on nothing
beyond torch and the standard library, so it reads JSON5 itself, with
the values ``json5.loads`` gives for the same text:

- ``//`` and ``/* */`` comments; every JSON5 white space (Unicode
  ``Zs``, ``\\v``, ``\\f``, NBSP, BOM, and the line terminators
  ``\\n``, ``\\r``, U+2028 and U+2029);
- object keys as strings or ECMAScript identifiers (``$``, ``_``,
  Unicode letters, ``\\uXXXX`` escapes); a trailing comma in objects
  and arrays; a repeated key keeps its first position and last value;
- single- or double-quoted strings with the escapes ``\\b \\f \\n \\r
  \\t \\v \\0 \\xHH \\uXXXX``, an escaped line terminator as a line
  continuation, and any other escaped character standing for itself;
- numbers with a leading ``+`` or ``-``, hexadecimal integers,
  ``Infinity`` and ``NaN``, and a leading or trailing decimal point;
  integers come back as ``int``, anything with a point or an exponent
  as ``float``.

A parse error is a ``ValueError`` that names the line and column of the
character the reader stopped at (``Unexpected "b" at line 3 column
2``), so the loader can mark the offending line.
"""
from __future__ import annotations

import unicodedata
from typing import Any, Dict, List

__all__ = ["JSON5Error", "loads"]

_EOL = "\n\r\u2028\u2029"
_WS = " \t\v\f\xa0\ufeff"
_ESCAPES = {
    "b": "\b", "f": "\f", "n": "\n", "r": "\r", "t": "\t", "v": "\v",
    "'": "'", '"': '"', "\\": "\\",
}
_ID_START_CATS = frozenset({"Lu", "Ll", "Lt", "Lm", "Lo", "Nl"})
_ID_CONTINUE_CATS = _ID_START_CATS | {"Mn", "Mc", "Nd", "Pc"}
_HEX = frozenset("0123456789abcdefABCDEF")


class JSON5Error(ValueError):
    """A document that is not JSON5, with the line and column of the
    character where reading stopped."""


def _id_start(ch: str) -> bool:
    return (("a" <= ch <= "z") or ("A" <= ch <= "Z") or ch in "$_"
            or (ch > "\x7f" and unicodedata.category(ch) in _ID_START_CATS))


def _id_continue(ch: str) -> bool:
    return (_id_start(ch) or ("0" <= ch <= "9") or ch in "\u200c\u200d"
            or (ch > "\x7f"
                and unicodedata.category(ch) in _ID_CONTINUE_CATS))


class _Reader:
    def __init__(self, text: str) -> None:
        self.text = text
        self.pos = 0
        self.end = len(text)

    # -- errors ---------------------------------------------------------

    def error(self, pos: int = -1) -> JSON5Error:
        pos = self.pos if pos < 0 else pos
        line = self.text.count("\n", 0, pos) + 1
        col = pos - (self.text.rfind("\n", 0, pos) + 1) + 1
        thing = ("end of input" if pos >= self.end
                 else f'"{self.text[pos]}"')
        return JSON5Error(f"Unexpected {thing} at line {line} column {col}")

    def peek(self) -> str:
        return self.text[self.pos] if self.pos < self.end else ""

    def expect(self, ch: str) -> None:
        if self.peek() != ch:
            raise self.error()
        self.pos += 1

    # -- white space and comments ---------------------------------------

    def skip_space(self) -> None:
        text, end = self.text, self.end
        while self.pos < end:
            ch = text[self.pos]
            if ch in _WS or ch in _EOL:
                self.pos += 1
            elif ch == "/" and text.startswith("//", self.pos):
                self.pos += 2
                while self.pos < end and text[self.pos] not in _EOL:
                    self.pos += 1
            elif ch == "/" and text.startswith("/*", self.pos):
                close = text.find("*/", self.pos + 2)
                if close < 0:
                    raise self.error(end)
                self.pos = close + 2
            elif ch > "\x7f" and unicodedata.category(ch) == "Zs":
                self.pos += 1
            else:
                return

    # -- values ---------------------------------------------------------

    def value(self) -> Any:
        ch = self.peek()
        if ch == "{":
            return self.object()
        if ch == "[":
            return self.array()
        if ch in ("'", '"'):
            return self.string()
        for word, val in (("null", None), ("true", True), ("false", False)):
            if self.text.startswith(word, self.pos):
                self.pos += len(word)
                return val
        return self.number()

    def object(self) -> Dict[str, Any]:
        self.expect("{")
        out: Dict[str, Any] = {}
        self.skip_space()
        if self.peek() == "}":
            self.pos += 1
            return out
        while True:
            key = self.string() if self.peek() in ("'", '"') else self.ident()
            self.skip_space()
            self.expect(":")
            self.skip_space()
            out[key] = self.value()
            self.skip_space()
            if self.peek() == ",":
                self.pos += 1
                self.skip_space()
                if self.peek() == "}":
                    self.pos += 1
                    return out
                continue
            self.expect("}")
            return out

    def array(self) -> List[Any]:
        self.expect("[")
        out: List[Any] = []
        self.skip_space()
        if self.peek() == "]":
            self.pos += 1
            return out
        while True:
            out.append(self.value())
            self.skip_space()
            if self.peek() == ",":
                self.pos += 1
                self.skip_space()
                if self.peek() == "]":
                    self.pos += 1
                    return out
                continue
            self.expect("]")
            return out

    def hex_digits(self, n: int) -> str:
        digits = self.text[self.pos:self.pos + n]
        for i, d in enumerate(digits):
            if d not in _HEX:
                raise self.error(self.pos + i)
        if len(digits) < n:
            raise self.error(self.pos + len(digits))
        self.pos += n
        return chr(int(digits, 16))

    def escape(self) -> str:
        """The character(s) after a backslash, the backslash consumed."""
        ch = self.peek()
        if not ch:
            raise self.error()
        if ch in _EOL:  # line continuation
            self.pos += 2 if self.text.startswith("\r\n", self.pos) else 1
            return ""
        self.pos += 1
        if ch in _ESCAPES:
            return _ESCAPES[ch]
        if ch == "0":
            if "0" <= self.peek() <= "9":
                raise self.error()
            return "\x00"
        if ch == "x":
            return self.hex_digits(2)
        if ch == "u":
            return self.hex_digits(4)
        if "1" <= ch <= "9":
            raise self.error(self.pos - 1)
        return ch

    def string(self) -> str:
        quote = self.peek()
        self.pos += 1
        text, end = self.text, self.end
        parts: List[str] = []
        while True:
            start = self.pos
            while (self.pos < end and text[self.pos] != quote
                   and text[self.pos] != "\\"
                   and text[self.pos] not in _EOL):
                self.pos += 1
            parts.append(text[start:self.pos])
            ch = self.peek()
            if ch == quote:
                self.pos += 1
                return "".join(parts)
            if ch == "\\":
                self.pos += 1
                parts.append(self.escape())
                continue
            raise self.error()  # end of input or a bare line terminator

    def ident(self) -> str:
        chars: List[str] = []
        while True:
            ch = self.peek()
            if ch == "\\":
                if not self.text.startswith("\\u", self.pos):
                    raise self.error()
                self.pos += 2
                chars.append(self.hex_digits(4))
                continue
            if ch and (_id_continue(ch) if chars else _id_start(ch)):
                chars.append(ch)
                self.pos += 1
                continue
            if not chars:
                raise self.error()
            return "".join(chars)

    def digits(self) -> str:
        start = self.pos
        while "0" <= self.peek() <= "9":
            self.pos += 1
        return self.text[start:self.pos]

    def number(self) -> Any:
        negative = self.peek() == "-"
        if self.peek() and self.peek() in "+-":
            self.pos += 1
        for word, val in (("Infinity", float("inf")), ("NaN", float("nan"))):
            if self.text.startswith(word, self.pos):
                self.pos += len(word)
                return -val if negative else val
        sign = "-" if negative else ""
        if self.text.startswith(("0x", "0X"), self.pos):
            self.pos += 2
            hex_start = self.pos
            while self.peek() and self.peek() in _HEX:
                self.pos += 1
            if self.pos == hex_start:
                raise self.error()
            return int(sign + self.text[hex_start:self.pos], 16)
        start = self.pos
        int_part = ""
        if self.peek() == "0":
            self.pos += 1
            int_part = "0"
            if "0" <= self.peek() <= "9":
                raise self.error()
        elif "1" <= self.peek() <= "9":
            int_part = self.digits()
        frac = exp = ""
        if self.peek() == ".":
            self.pos += 1
            frac = "." + self.digits()
        if not int_part and len(frac) < 2:  # no digit at all
            raise self.error(start)
        if self.peek() in ("e", "E"):
            mark = self.pos
            self.pos += 1
            if self.peek() and self.peek() in "+-":
                self.pos += 1
            if not self.digits():
                raise self.error()
            exp = self.text[mark:self.pos]
        if self.peek() and _id_start(self.peek()):
            raise self.error()
        literal = sign + int_part + frac + exp
        return float(literal) if frac or exp else int(literal)

def loads(text: str) -> Any:
    """Parse one JSON5 document (``json5.loads`` with its defaults)."""
    if text == "":
        raise JSON5Error("Empty strings are not legal JSON5")
    reader = _Reader(text)
    reader.skip_space()
    value = reader.value()
    reader.skip_space()
    if reader.pos != reader.end:
        raise reader.error()
    return value

