"""Vendored R syntax validator — the `parse()` stand-in.

The port's copy of h2o3_tpu/client_r/rcheck.py.

No R runtime exists in this image (VERDICT r1 item 9), so generated R
sources are validated with a real tokenizer + structural checks that
catch the error classes `R CMD check`'s parse step would: unterminated
strings, unbalanced delimiters (with string/comment stripping), operators
dangling at end-of-file, malformed `function(...)` headers, and `<-`
assignments without a left-hand side.
"""

from __future__ import annotations

import re
from typing import List, Tuple

_OPS = {"+", "-", "*", "/", "^", "<-", "<<-", "->", "=", "==", "!=",
        "<", ">", "<=", ">=", "&", "&&", "|", "||", "%%", "%/%", "%in%",
        "$", "@", "~", "?", ":", ","}


def tokenize_r(src: str) -> List[Tuple[str, str]]:
    """(kind, text) tokens; raises ValueError on lexical errors."""
    tokens: List[Tuple[str, str]] = []
    i, n = 0, len(src)
    while i < n:
        ch = src[i]
        if ch in " \t\r":
            i += 1
        elif ch == "\n":
            tokens.append(("newline", "\n"))
            i += 1
        elif ch == "#":
            while i < n and src[i] != "\n":
                i += 1
        elif ch in "\"'":
            q = ch
            j = i + 1
            while j < n and src[j] != q:
                j += 2 if src[j] == "\\" else 1
            if j >= n:
                raise ValueError(f"unterminated string at offset {i}")
            tokens.append(("string", src[i:j + 1]))
            i = j + 1
        elif ch == "`":
            j = src.find("`", i + 1)
            if j < 0:
                raise ValueError(f"unterminated backtick name at {i}")
            tokens.append(("name", src[i:j + 1]))
            i = j + 1
        elif ch.isdigit() or (ch == "." and i + 1 < n
                              and src[i + 1].isdigit()):
            m = re.match(r"[0-9.]+([eE][+-]?\d+)?L?i?", src[i:])
            tokens.append(("number", m.group(0)))
            i += m.end()
        elif ch.isalpha() or ch in "._":
            m = re.match(r"[A-Za-z._][A-Za-z0-9._]*", src[i:])
            tokens.append(("name", m.group(0)))
            i += m.end()
        elif ch == "%":
            j = src.find("%", i + 1)
            if j < 0:
                raise ValueError(f"unterminated %op% at {i}")
            tokens.append(("op", src[i:j + 1]))
            i = j + 1
        elif ch in "()[]{}":
            tokens.append(("bracket", ch))
            i += 1
        elif src[i:i + 3] in ("<<-",):
            tokens.append(("op", src[i:i + 3]))
            i += 3
        elif src[i:i + 2] in ("<-", "->", "==", "!=", "<=", ">=", "&&",
                              "||", "::"):
            tokens.append(("op", src[i:i + 2]))
            i += 2
        elif ch in "+-*/^<>=!&|~?:;,$@":
            tokens.append(("op", ch))
            i += 1
        else:
            raise ValueError(f"unexpected character {ch!r} at offset {i}")
    return tokens


def check_r_source(src: str) -> List[str]:
    """Structural validation; returns a list of error strings (empty =
    passes the parse-level checks)."""
    errors: List[str] = []
    try:
        tokens = tokenize_r(src)
    except ValueError as e:
        return [str(e)]

    # balanced delimiters with correct nesting
    stack: List[str] = []
    pairs = {")": "(", "]": "[", "}": "{"}
    for kind, text in tokens:
        if kind != "bracket":
            continue
        if text in "([{":
            stack.append(text)
        else:
            if not stack or stack[-1] != pairs[text]:
                errors.append(f"mismatched '{text}'")
                break
            stack.pop()
    if stack:
        errors.append(f"unclosed '{stack[-1]}'")

    code = [(k, t) for k, t in tokens if k != "newline"]
    # function headers: `function` must be followed by '('
    for j, (kind, text) in enumerate(code):
        if kind == "name" and text == "function":
            if j + 1 >= len(code) or code[j + 1][1] != "(":
                errors.append("`function` not followed by '('")
        if kind == "op" and text in ("<-", "<<-"):
            if j == 0 or code[j - 1][0] not in ("name", "string") \
                    and code[j - 1][1] not in (")", "]"):
                errors.append("assignment without assignable LHS")
    # dangling operator at EOF
    if code and code[-1][0] == "op" and code[-1][1] not in (";",):
        errors.append(f"dangling operator {code[-1][1]!r} at EOF")
    return errors
