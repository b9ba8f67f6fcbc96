"""YAML for the config tree without PyYAML: a reader and a writer.

:func:`load` returns what ``yaml.safe_load`` (PyYAML 6, the YAML 1.1
resolver) returns for the forms the files of ``config/``, the run
directory's snapshot and the dotlist overrides use: block mappings and
sequences (a sequence under a key may sit at the key's indent), flow
sequences and mappings, plain, single- and double-quoted scalars (folded
over lines as PyYAML folds them) and comments. Plain scalars are typed by
PyYAML's implicit resolver: ``off`` is False, ``1e-5`` (no dot) a string,
``~`` None, ``1_000`` an int. A construct it does not take raises
ValueError naming the construct and its line: anchors, aliases, tags,
block scalars (``|``, ``>``), complex keys (``?``), empty keys,
collections as keys, directives, several documents, tabs outside quotes,
timestamps and merge keys.

:func:`dump` writes the bytes of ``yaml.safe_dump(tree, sort_keys=False)``
for a tree of dicts, lists, str, int, float, bool and None whose strings
are printable ASCII and whose keys are scalars PyYAML writes as simple
keys (not empty, under 128 characters with their tag). It raises
ValueError for anything else: other characters, a container reached
twice (PyYAML writes an anchor), a key PyYAML writes with ``?``.
"""

from __future__ import annotations

import re
from typing import Any, List, Tuple

# PyYAML's implicit resolvers (resolver.py), in the order it tries them
_RESOLVERS = [
    ("bool", re.compile(r"yes|Yes|YES|no|No|NO|true|True|TRUE|false|False"
                        r"|FALSE|on|On|ON|off|Off|OFF")),
    ("float", re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                         r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                         r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
                         r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN)")),
    ("int", re.compile(r"[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                       r"|[-+]?0x[0-9a-fA-F_]+"
                       r"|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+")),
    ("merge", re.compile(r"<<")),
    ("null", re.compile(r"~|null|Null|NULL|")),
    ("timestamp", re.compile(
        r"[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]"
        r"|[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?"
        r"(?:[Tt]|[ \t]+)[0-9][0-9]?:[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?"
        r"(?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?")),
    ("value", re.compile(r"=")),
    ("yaml", re.compile(r"!|&|\*")),
]
_BOOLS = {"yes": True, "no": False, "true": True, "false": False,
          "on": True, "off": False}
_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\x0b", "f": "\x0c", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}
_NOT_PLAIN = "\0 \t\n-?:,[]{}#&*!|>'\"%@`"


def _resolve_tag(text: str) -> str:
    """The type PyYAML gives a plain scalar: bool, float, int, merge, null,
    timestamp, value, yaml or str."""
    for tag, pattern in _RESOLVERS:
        if pattern.fullmatch(text):
            return tag
    return "str"


def _sexagesimal(text: str, kind):
    value = kind(0)
    for part in text.split(":"):
        value = value * 60 + kind(part)
    return value


def _int(text: str) -> int:
    value, sign = text.replace("_", ""), 1
    if value[0] in "+-":
        sign, value = -1 if value[0] == "-" else 1, value[1:]
    if value == "0":
        return 0
    if value.startswith("0b"):
        return sign * int(value[2:], 2)
    if value.startswith("0x"):
        return sign * int(value[2:], 16)
    if value[0] == "0":
        return sign * int(value, 8)
    if ":" in value:
        return sign * _sexagesimal(value, int)
    return sign * int(value)


def _float(text: str) -> float:
    value, sign = text.replace("_", "").lower(), 1
    if value[0] in "+-":
        sign, value = -1 if value[0] == "-" else 1, value[1:]
    if value == ".inf":
        return sign * float("inf")
    if value == ".nan":
        return float("nan")
    if ":" in value:
        return sign * _sexagesimal(value, float)
    return sign * float(value)


class _Reader:
    """A recursive-descent reader over the text; ``i`` is the position."""

    def __init__(self, text: str):
        text = text.replace("\r\n", "\n").replace("\r", "\n")
        self.s = text[1:] if text.startswith("\ufeff") else text
        self.i = 0

    # -- position ----------------------------------------------------------
    def peek(self, k: int = 0) -> str:
        j = self.i + k
        return self.s[j] if j < len(self.s) else "\0"

    def line(self) -> int:
        return self.s.count("\n", 0, self.i) + 1

    def col(self) -> int:
        return self.i - (self.s.rfind("\n", 0, self.i) + 1)

    def marker(self) -> bool:
        """A document marker (``---`` or ``...``) at this line's start."""
        return (self.col() == 0 and self.s[self.i:self.i + 3] in ("---", "...")
                and self.peek(3) in " \n\0")

    def done(self) -> bool:
        """The end of the text or of the document's block content."""
        return self.i >= len(self.s) or self.marker()

    def unsupported(self, what: str):
        raise ValueError(f"yamlio: {what} at line {self.line()} is not "
                         "supported")

    def error(self, what: str):
        raise ValueError(f"yamlio: {what} at line {self.line()}")

    # -- white space -------------------------------------------------------
    def skip_spaces(self) -> None:
        while self.peek() == " ":
            self.i += 1
        if self.peek() == "\t":
            self.unsupported("a tab outside quotes")

    def end_line(self) -> None:
        """Nothing but spaces and a comment may follow a value."""
        self.skip_spaces()
        if self.peek() == "#":
            while self.peek() not in "\n\0":
                self.i += 1
        if self.peek() not in "\n\0":
            self.error(f"unexpected {self.peek()!r} after a value")

    def next_content(self) -> None:
        """From a line's end, past blank and comment lines to the first
        character of the next line with content (or the end)."""
        while self.i < len(self.s):
            if self.peek() == "\n":
                self.i += 1
                continue
            self.skip_spaces()
            if self.peek() == "#":
                while self.peek() not in "\n\0":
                    self.i += 1
            if self.peek() not in "\n\0":
                return

    def flow_space(self) -> None:
        """Spaces, line breaks and comments inside a flow collection."""
        while True:
            if self.marker():
                self.error("a document marker inside a flow collection")
            ch = self.peek()
            if ch in " \n":
                self.i += 1
            elif ch == "#":
                while self.peek() not in "\n\0":
                    self.i += 1
            elif ch == "\t":
                self.unsupported("a tab outside quotes")
            else:
                return

    # -- document and block nodes -----------------------------------------
    def document(self) -> Any:
        self.next_content()
        if self.i >= len(self.s):
            return None
        if self.col() == 0 and self.peek() == "%":
            self.unsupported("a directive")
        if self.marker() and self.peek() == "-":
            self.i += 3
            self.skip_spaces()
            if self.peek() not in "#\n\0":
                self.unsupported("content on the '---' line")
            self.end_line()
            self.next_content()
        value = None if self.done() else self.node(-1)
        if self.marker() and self.peek() == ".":
            self.i += 3
            self.end_line()
            self.next_content()
        if self.i < len(self.s):
            if self.marker():
                self.unsupported("a second document")
            self.error(f"unexpected {self.peek()!r}")
        return value

    def node(self, parent: int) -> Any:
        """The node at this character; returns at the next content line."""
        ch = self.peek()
        if ch == "-" and self.peek(1) in " \n\0":
            return self.block_sequence(self.col())
        if ch == "?" and self.peek(1) in " \n\0":
            self.unsupported("a complex key ('?')")
        if self.is_key():
            return self.block_mapping(self.col())
        value = self.inline(parent)
        self.end_line()
        self.next_content()
        return value

    def block_value(self, column: int, indentless: bool) -> Any:
        """A value that starts on the lines after its indicator: deeper
        than ``column``, or (``indentless``) a sequence at it."""
        self.end_line()
        self.next_content()
        if self.done():
            return None
        if self.col() > column:
            return self.node(column)
        if indentless and self.col() == column and self.entry():
            return self.block_sequence(column)
        return None

    def entry(self) -> bool:
        return self.peek() == "-" and self.peek(1) in " \n\0"

    def block_sequence(self, column: int) -> list:
        out = []
        while True:
            self.i += 1
            self.skip_spaces()
            if self.peek() in "#\n\0":
                out.append(self.block_value(column, indentless=False))
            else:
                out.append(self.node(column))
            if self.done() or self.col() < column:
                return out
            if self.col() > column:
                self.error("bad indentation")
            if not self.entry():
                return out

    def block_mapping(self, column: int) -> dict:
        out = {}
        while True:
            key = self.key()
            self.skip_spaces()
            if self.peek() in "#\n\0":
                out[key] = self.block_value(column, indentless=True)
            else:
                if self.entry():
                    self.error("a block sequence on its key's line")
                out[key] = self.inline(column)
                self.end_line()
                self.next_content()
            if self.done() or self.col() < column:
                return out
            if self.col() > column:
                self.error("bad indentation")
            if not self.is_key():
                self.error("expected a mapping key")

    def is_key(self) -> bool:
        """Whether a simple key (a scalar on this line and ``:``) starts
        here."""
        start = self.i
        try:
            ch = self.peek()
            if ch in "'\"":
                self.quoted()
                multiline = "\n" in self.s[start:self.i]
            elif ch in "[{":
                self.flow_collection()
                self.skip_spaces()
                if self.peek() == ":":
                    self.unsupported("a collection as a mapping key")
                return False
            elif self.plain_start(False):
                self.plain_chunk(False)
                multiline = False
            else:
                return False
            self.skip_spaces()
            found = self.peek() == ":" and self.peek(1) in " \n\0"
            if found and multiline:
                self.unsupported("a key over several lines")
            return found
        finally:
            self.i = start

    def key(self) -> Any:
        if self.peek() in "'\"":
            key = self.quoted()
        else:
            key = self.construct(self.plain_chunk(False))
        self.skip_spaces()
        self.i += 1  # ':'
        return key

    def inline(self, parent: int) -> Any:
        ch = self.peek()
        if ch in "[{":
            return self.flow_collection()
        if ch in "'\"":
            return self.quoted()
        self.indicator(ch)
        if ch == "-" and self.peek(1) in " \n\0":
            self.error("a block sequence entry here")
        if ch == ":" and self.peek(1) in " \n\0":
            self.unsupported("an empty mapping key")
        if not self.plain_start(False):
            self.error(f"unexpected {ch!r}")
        return self.construct(self.plain(parent, False))

    def indicator(self, ch: str) -> None:
        names = {"&": "an anchor", "*": "an alias", "!": "a tag",
                 "|": "a block scalar ('|')", ">": "a block scalar ('>')"}
        if ch in names:
            self.unsupported(names[ch])

    # -- scalars -----------------------------------------------------------
    def plain_start(self, flow: bool) -> bool:
        ch = self.peek()
        return ch not in _NOT_PLAIN or (
            self.peek(1) not in "\0 \t\n"
            and (ch == "-" or (not flow and ch in "?:")))

    def plain_chunk(self, flow: bool) -> str:
        """A plain scalar's text on this line, trailing spaces left."""
        start = self.i
        while True:
            ch = self.peek()
            if ch in "\n\0" or (ch == " " and self.peek(1) == "#"):
                break
            if ch == "\t":
                self.unsupported("a tab outside quotes")
            if ch == ":" and (self.peek(1) in " \n\0"
                              or (flow and self.peek(1) in ",[]{}")):
                break
            if flow and ch in ",?[]{}":
                break
            self.i += 1
        text = self.s[start:self.i].rstrip(" ")
        self.i = start + len(text)
        return text

    def plain(self, parent: int, flow: bool) -> str:
        """A plain scalar, folded over continuation lines (deeper than
        ``parent`` in block context): one break is a space, n blank lines
        are n newlines."""
        text = self.plain_chunk(flow)
        while True:
            end = self.i
            while self.peek() == " ":
                self.i += 1
            if self.peek() != "\n":
                break
            breaks = -1
            while self.peek() == "\n":
                self.i += 1
                breaks += 1
                if self.marker():
                    break
                while self.peek() == " ":
                    self.i += 1
            if (self.marker() or self.peek() in "#\0\t"
                    or (not flow and self.col() <= parent)):
                break
            chunk = self.plain_chunk(flow)
            if not chunk:
                break
            text += ("\n" * breaks if breaks else " ") + chunk
        self.i = end
        return text

    def construct(self, text: str) -> Any:
        tag = _resolve_tag(text)
        if tag == "str":
            return text
        if tag == "null":
            return None
        if tag == "bool":
            return _BOOLS[text.lower()]
        if tag == "int":
            return _int(text)
        if tag == "float":
            return _float(text)
        self.unsupported(f"a {tag} scalar ({text!r})")

    def quoted(self) -> str:
        """A single- or double-quoted scalar (PyYAML's scan_flow_scalar)."""
        quote = self.peek()
        double = quote == '"'
        self.i += 1
        chunks: List[str] = []
        while True:
            self.quoted_text(double, chunks)
            if self.peek() == quote:
                self.i += 1
                return "".join(chunks)
            self.quoted_spaces(chunks)

    def quoted_text(self, double: bool, chunks: List[str]) -> None:
        while True:
            start = self.i
            while self.peek() not in "'\"\\\0 \t\n":
                self.i += 1
            if self.i > start:
                chunks.append(self.s[start:self.i])
            ch = self.peek()
            if not double and ch == "'" and self.peek(1) == "'":
                chunks.append("'")
                self.i += 2
            elif (double and ch == "'") or (not double and ch in '"\\'):
                chunks.append(ch)
                self.i += 1
            elif double and ch == "\\":
                self.i += 1
                ch = self.peek()
                if ch in _ESCAPES:
                    chunks.append(_ESCAPES[ch])
                    self.i += 1
                elif ch in _HEX_ESCAPES:
                    n = _HEX_ESCAPES[ch]
                    digits = self.s[self.i + 1:self.i + 1 + n]
                    if len(digits) != n or not all(
                            c in "0123456789ABCDEFabcdef" for c in digits):
                        self.error(f"a bad '\\{ch}' escape")
                    chunks.append(chr(int(digits, 16)))
                    self.i += 1 + n
                elif ch == "\n":
                    self.i += 1
                    chunks.extend(self.quoted_breaks())
                else:
                    self.error(f"an unknown escape '\\{ch}'")
            else:
                return

    def quoted_spaces(self, chunks: List[str]) -> None:
        start = self.i
        while self.peek() in " \t":
            self.i += 1
        if self.peek() == "\0":
            self.error("an unterminated quoted scalar")
        if self.peek() == "\n":
            self.i += 1
            breaks = self.quoted_breaks()
            chunks.append("".join(breaks) if breaks else " ")
        else:
            chunks.append(self.s[start:self.i])

    def quoted_breaks(self) -> List[str]:
        breaks = []
        while True:
            if self.marker():
                self.error("a document marker inside a quoted scalar")
            while self.peek() in " \t":
                self.i += 1
            if self.peek() != "\n":
                return breaks
            breaks.append("\n")
            self.i += 1

    # -- flow collections --------------------------------------------------
    def flow_collection(self) -> Any:
        return self.flow_sequence() if self.peek() == "[" \
            else self.flow_mapping()

    def flow_node(self) -> Any:
        self.flow_space()
        ch = self.peek()
        if ch in "[{":
            return self.flow_collection()
        if ch in "'\"":
            return self.quoted()
        self.indicator(ch)
        if ch == "?":
            self.unsupported("a complex key ('?')")
        if ch == ":":
            self.unsupported("an empty mapping key")
        if ch == ",":
            self.error("an empty entry in a flow collection")
        if not self.plain_start(True):
            self.error(f"unexpected {ch!r} in a flow collection")
        return self.construct(self.plain(-1, True))

    def hashable(self, key: Any) -> Any:
        if isinstance(key, (list, dict)):
            self.unsupported("a collection as a mapping key")
        return key

    def flow_value(self, close: str) -> Any:
        """After ``:``: the value, or None where the entry ends."""
        self.i += 1
        self.flow_space()
        if self.peek() in "," + close:
            return None
        value = self.flow_node()
        self.flow_space()
        return value

    def flow_next(self, close: str) -> None:
        if self.peek() == ",":
            self.i += 1
        elif self.peek() != close:
            self.error(f"expected ',' or '{close}' in a flow collection")

    def flow_sequence(self) -> list:
        self.i += 1
        out = []
        while True:
            self.flow_space()
            if self.peek() == "]":
                self.i += 1
                return out
            item = self.flow_node()
            self.flow_space()
            if self.peek() == ":":  # a single-pair mapping
                item = {self.hashable(item): self.flow_value("]")}
            out.append(item)
            self.flow_next("]")

    def flow_mapping(self) -> dict:
        self.i += 1
        out = {}
        while True:
            self.flow_space()
            if self.peek() == "}":
                self.i += 1
                return out
            key = self.hashable(self.flow_node())
            self.flow_space()
            out[key] = self.flow_value("}") if self.peek() == ":" else None
            self.flow_next("}")


def load(text: str) -> Any:
    """The document in ``text`` as ``yaml.safe_load`` reads it (None for
    an empty one); ValueError for what this reader does not take."""
    return _Reader(text).document()


# -- the writer --------------------------------------------------------------
_TAGS = {type(None): "!!null", bool: "!!bool", int: "!!int",
         float: "!!float", str: "!!str"}


def _scalar(value: Any) -> Tuple[str, str, str]:
    """(text, the type a plain reading must give, tag) of a scalar, as
    PyYAML's SafeRepresenter writes it."""
    if value is None:
        return "null", "null", "!!null"
    if isinstance(value, bool):
        return ("true" if value else "false"), "bool", "!!bool"
    if isinstance(value, int):
        return str(value), "int", "!!int"
    if isinstance(value, float):
        if value != value:
            text = ".nan"
        elif value in (float("inf"), float("-inf")):
            text = ".inf" if value > 0 else "-.inf"
        else:
            text = repr(value).lower()
            if "." not in text and "e" in text:
                text = text.replace("e", ".0e", 1)
        return text, "float", "!!float"
    if isinstance(value, str):
        if not all(" " <= c <= "~" for c in value):
            raise ValueError(f"yamlio.dump writes printable ASCII strings "
                             f"only, not {value!r}")
        return value, "str", "!!str"
    raise ValueError(f"yamlio.dump cannot write a {type(value).__name__}")


def _plain_allowed(text: str) -> bool:
    """PyYAML's analyze_scalar for a printable ASCII scalar in block
    context: no leading or trailing space, no indicator that would end or
    change a plain scalar."""
    if not text:
        return True
    if text[0] == " " or text[-1] == " " or text.startswith(("---", "...")):
        return False
    n = len(text)
    for k, ch in enumerate(text):
        followed = k + 1 >= n or text[k + 1] == " "
        if k == 0:
            if ch in "#,[]{}&*!|>'\"%@`" or (ch in "?:-" and followed):
                return False
        elif (ch == ":" and followed) or (ch == "#" and text[k - 1] == " "):
            return False
    return True


class _Writer:
    """PyYAML's Emitter for block style, best width 80, indent 2."""

    def __init__(self):
        self.out: List[str] = []
        self.indents: List[Any] = []
        self.indent = None
        self.column = 0
        self.whitespace = True
        self.indention = True
        self.open_ended = False
        self.seen = set()

    def write(self, data: str) -> None:
        self.column += len(data)
        self.out.append(data)

    def indicator(self, text: str, need_whitespace: bool,
                  whitespace: bool = False, indention: bool = False) -> None:
        self.write(text if self.whitespace or not need_whitespace
                   else " " + text)
        self.whitespace = whitespace
        self.indention = self.indention and indention
        self.open_ended = False

    def line_break(self) -> None:
        self.out.append("\n")
        self.whitespace = self.indention = True
        self.column = 0

    def write_indent(self) -> None:
        indent = self.indent or 0
        if not self.indention or self.column > indent or (
                self.column == indent and not self.whitespace):
            self.line_break()
        if self.column < indent:
            self.whitespace = True
            self.write(" " * (indent - self.column))

    def increase_indent(self, flow: bool = False,
                        indentless: bool = False) -> None:
        self.indents.append(self.indent)
        if self.indent is None:
            self.indent = 2 if flow else 0
        elif not indentless:
            self.indent += 2

    def node(self, data: Any, root: bool = False, mapping: bool = False,
             simple_key: bool = False) -> None:
        if isinstance(data, (dict, list, tuple)):
            if id(data) in self.seen and data != ():
                raise ValueError("yamlio.dump: a container reached twice "
                                 "(PyYAML writes an anchor)")
            self.seen.add(id(data))
            if not data:
                self.empty("{}" if isinstance(data, dict) else "[]")
            elif isinstance(data, dict):
                self.mapping(data)
            else:
                self.sequence(data, mapping)
            return
        text, kind, _ = _scalar(data)
        self.increase_indent(flow=True)
        if (_resolve_tag(text) == kind and not (simple_key and not text)
                and _plain_allowed(text)):
            self.plain(text, split=not simple_key, root=root)
        else:
            self.single_quoted(text, split=not simple_key)
        self.indent = self.indents.pop()

    def empty(self, pair: str) -> None:
        self.indicator(pair[0], True, whitespace=True)
        self.indicator(pair[1], False)

    def mapping(self, data: dict) -> None:
        self.increase_indent()
        for key, value in data.items():
            self.write_indent()
            if isinstance(key, (dict, list, tuple)):
                raise ValueError("yamlio.dump: a collection as a key")
            text, _, tag = _scalar(key)
            if not text or len(text) + len(tag) >= 128:
                raise ValueError(f"yamlio.dump: the key {key!r} is not a "
                                 "simple key (PyYAML writes it with '?')")
            self.node(key, mapping=True, simple_key=True)
            self.indicator(":", False)
            self.node(value, mapping=True)
        self.indent = self.indents.pop()

    def sequence(self, data, mapping: bool) -> None:
        self.increase_indent(indentless=mapping and not self.indention)
        for item in data:
            self.write_indent()
            self.indicator("-", True, indention=True)
            self.node(item)
        self.indent = self.indents.pop()

    def plain(self, text: str, split: bool, root: bool) -> None:
        if root:
            self.open_ended = True
        if not text:
            return
        if not self.whitespace:
            self.write(" ")
        self.whitespace = self.indention = False
        spaces, start = False, 0
        for end in range(len(text) + 1):
            ch = text[end] if end < len(text) else None
            if spaces:
                if ch != " ":
                    if start + 1 == end and self.column > 80 and split:
                        self.write_indent()
                        self.whitespace = self.indention = False
                    else:
                        self.write(text[start:end])
                    start = end
            elif ch is None or ch == " ":
                self.write(text[start:end])
                start = end
            spaces = ch == " "

    def single_quoted(self, text: str, split: bool) -> None:
        self.indicator("'", True)
        spaces, start = False, 0
        for end in range(len(text) + 1):
            ch = text[end] if end < len(text) else None
            if spaces:
                if ch != " ":
                    if (start + 1 == end and self.column > 80 and split
                            and start != 0 and end != len(text)):
                        self.write_indent()
                    else:
                        self.write(text[start:end])
                    start = end
            elif (ch is None or ch in " '") and start < end:
                self.write(text[start:end])
                start = end
            if ch == "'":
                self.write("''")
                start = end + 1
            spaces = ch == " "
        self.indicator("'", False)


def dump(tree: Any) -> str:
    """``tree`` as ``yaml.safe_dump(tree, sort_keys=False)`` writes it."""
    w = _Writer()
    w.node(tree, root=True)
    w.write_indent()
    if w.open_ended:
        w.indicator("...", True)
        w.write_indent()
    return "".join(w.out)
