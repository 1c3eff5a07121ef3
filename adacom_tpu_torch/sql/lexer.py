"""SQL lexer with literal parameterization for plan caching.

The reference parses every query from scratch (libpg_query); our hot path
(thousands of point lookups differing only in literal values,
benchmark/micro/succinct/zipf_distribution.cpp:41-47) instead lexes the
query, replaces literals with parameter slots, and reuses the cached bound
plan for identical templates."""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

KEYWORDS = {
    "SELECT", "FROM", "WHERE", "GROUP", "BY", "HAVING", "ORDER", "LIMIT",
    "OFFSET", "AS", "AND", "OR", "NOT", "IN", "BETWEEN", "LIKE", "ILIKE",
    "IS", "NULL", "TRUE", "FALSE", "CASE", "WHEN", "THEN", "ELSE", "END",
    "CAST", "CREATE", "TABLE", "VIEW", "OR", "REPLACE", "IF", "EXISTS",
    "INSERT", "INTO", "VALUES", "UPDATE", "SET", "DELETE", "DROP", "BEGIN",
    "COMMIT", "ROLLBACK", "TRANSACTION", "PRAGMA", "EXPLAIN", "ANALYZE",
    "JOIN", "INNER", "LEFT", "RIGHT", "FULL", "OUTER", "CROSS", "ON",
    "USING", "UNION", "ALL", "EXCEPT", "INTERSECT", "DISTINCT", "WITH",
    "RECURSIVE", "ASC", "DESC", "NULLS", "FIRST", "LAST", "INTERVAL",
    "DATE", "TIMESTAMP", "EXTRACT", "SUBSTRING", "FOR", "CHECKPOINT",
    "VACUUM", "DEFAULT", "PRIMARY", "KEY", "UNIQUE", "CONSTRAINT",
    "FOREIGN", "REFERENCES", "CHECK", "COPY", "TO", "DESCRIBE", "SHOW",
    "ANY", "SOME", "ESCAPE", "OVER", "PARTITION", "ROWS", "RANGE",
    "PRECEDING", "FOLLOWING", "UNBOUNDED", "CURRENT", "ROW", "WINDOW",
    "FILTER", "PREPARE", "EXECUTE", "INDEX",
}

# token kinds
IDENT, KW, NUM, STR, OP, EOF = "IDENT", "KW", "NUM", "STR", "OP", "EOF"


class NumText(float):
    """A numeric literal written with a fraction or an exponent: its float
    value, and the text it was written as, which a DECIMAL column takes
    exactly (main/coerce.py from_values). Arithmetic gives plain floats."""

    __slots__ = ("text",)

    def __new__(cls, text: str):
        self = super().__new__(cls, text)
        self.text = text
        return self

    def __getnewargs__(self):
        return (self.text,)

    def __neg__(self):
        return NumText(self.text[1:] if self.text.startswith("-")
                       else "-" + self.text)


class _Placeholder:
    """Sentinel literal value for '?' slots (replaced at EXECUTE)."""

    def __repr__(self):
        return "?"


PLACEHOLDER = _Placeholder()

_OPS = [
    "::", "<=", ">=", "<>", "!=", "==", "||", "<", ">", "=", "(", ")", ",",
    "+", "-", "*", "/", "%", ".", ";",
]


@dataclasses.dataclass
class Token:
    kind: str
    value: str
    pos: int
    # index into the literal slot list when this token is a literal
    param: Optional[int] = None


class LexError(Exception):
    pass


def tokenize(sql: str) -> Tuple[List[Token], Tuple, List]:
    """Returns (tokens, template_key, literal_values).

    template_key is hashable and identical for queries differing only in
    literal values; literal_values[i] is the value of parameter slot i
    (python int/float/str)."""
    toks: List[Token] = []
    key: List = []
    lits: List = []
    i, n = 0, len(sql)
    while i < n:
        c = sql[i]
        if c.isspace():
            i += 1
            continue
        if c == "-" and i + 1 < n and sql[i + 1] == "-":
            j = sql.find("\n", i)
            i = n if j < 0 else j + 1
            continue
        if c == "/" and i + 1 < n and sql[i + 1] == "*":
            j = sql.find("*/", i + 2)
            if j < 0:
                raise LexError("unterminated block comment")
            i = j + 2
            continue
        if c == "'":
            j = i + 1
            buf = []
            while True:
                if j >= n:
                    raise LexError("unterminated string literal")
                if sql[j] == "'":
                    if j + 1 < n and sql[j + 1] == "'":
                        buf.append("'")
                        j += 2
                        continue
                    break
                buf.append(sql[j])
                j += 1
            val = "".join(buf)
            toks.append(Token(STR, val, i, param=len(lits)))
            key.append(("STR",))
            lits.append(val)
            i = j + 1
            continue
        if c == '"':
            j = sql.find('"', i + 1)
            if j < 0:
                raise LexError("unterminated quoted identifier")
            toks.append(Token(IDENT, sql[i + 1 : j], i))
            key.append((IDENT, sql[i + 1 : j].lower()))
            i = j + 1
            continue
        if c.isdigit() or (c == "." and i + 1 < n and sql[i + 1].isdigit()):
            j = i
            is_float = False
            while j < n and (sql[j].isdigit() or sql[j] in ".eE" or
                             (sql[j] in "+-" and j > i and sql[j - 1] in "eE")):
                if sql[j] in ".eE":
                    is_float = True
                j += 1
            text = sql[i:j]
            val = NumText(text) if is_float else int(text)
            toks.append(Token(NUM, text, i, param=len(lits)))
            key.append(("NUM", "f" if is_float else "i"))
            lits.append(val)
            i = j
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (sql[j].isalnum() or sql[j] == "_"):
                j += 1
            word = sql[i:j]
            up = word.upper()
            if up in KEYWORDS:
                toks.append(Token(KW, up, i))
                key.append((KW, up))
            else:
                toks.append(Token(IDENT, word, i))
                key.append((IDENT, word.lower()))
            i = j
            continue
        if c == "?":
            # prepared-statement placeholder: a parameter slot whose value
            # arrives at EXECUTE time (PEP 249 qmark / PREPARE..EXECUTE)
            toks.append(Token(NUM, "?", i, param=len(lits)))
            key.append(("NUM", "?"))
            lits.append(PLACEHOLDER)
            i += 1
            continue
        matched = None
        for op in _OPS:
            if sql.startswith(op, i):
                matched = op
                break
        if matched is None:
            raise LexError(f"unexpected character {c!r} at {i}")
        toks.append(Token(OP, matched, i))
        key.append((OP, matched))
        i += len(matched)
    toks.append(Token(EOF, "", n))
    return toks, tuple(key), lits
