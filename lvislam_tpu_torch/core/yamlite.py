"""A reader for the subset of YAML that the system's parameter files use,
so the port loads them without PyYAML.

``loads(text)`` gives what ``yaml.safe_load`` gives on these files:

- block mappings nested by indentation (the ROS 2 ``/**:`` /
  ``ros__parameters:`` layout included), keys plain or quoted;
- scalars resolved by YAML 1.1's core rules as PyYAML resolves them:
  decimal int, float (``3.99e-03``, ``.5``, ``.inf``, ``.nan``; underscores
  dropped), bool (``true`` / ``yes`` / ``on`` and their negations), null
  (``~``, ``null``, empty), and strings, plain or quoted;
- comments, whole-line or after a value;
- flow sequences of scalars, ``[a, b, ...]``, over as many lines as they run;
- the OpenCV ``%YAML:1.0`` header, a ``---`` before the content, and the
  ``!!opencv-matrix`` tag that OpenCV writes on a matrix's mapping (dropped).

Anything else (block sequences, flow mappings, nested flow sequences,
anchors and aliases, other tags, block or multi-line scalars, further
documents, other directives, tabs in indentation, the octal / hex / binary /
sexagesimal numbers of YAML 1.1) raises ``ValueError`` naming the line: it is
never guessed.
"""

from __future__ import annotations

import re

_BOOL = {"yes": True, "Yes": True, "YES": True, "true": True, "True": True, "TRUE": True,
         "on": True, "On": True, "ON": True, "no": False, "No": False, "NO": False,
         "false": False, "False": False, "FALSE": False, "off": False, "Off": False,
         "OFF": False}
_NULL = {"", "~", "null", "Null", "NULL"}
# PyYAML's implicit resolvers (resolver.py), YAML 1.1
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9_]+(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                  |[-+]?0[0-7_]+
                  |[-+]?(?:0|[1-9][0-9_]*)
                  |[-+]?0x[0-9a-fA-F_]+
                  |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_DECIMAL = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_IGNORED_TAG = "!!opencv-matrix"


def _fail(lineno: int, what: str):
    raise ValueError(f"line {lineno}: {what} is outside the YAML subset this reader takes")


def _plain(text: str, lineno: int):
    """A plain scalar resolved as PyYAML resolves it."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        if not _DECIMAL.match(text):
            _fail(lineno, f"the YAML 1.1 integer {text!r}")
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        v = text.replace("_", "").lower()
        if ":" in v:
            _fail(lineno, f"the sexagesimal number {text!r}")
        sign = -1.0 if v.startswith("-") else 1.0
        body = v.lstrip("+-")
        if body == ".inf":
            return sign * float("inf")
        if body == ".nan":
            return float("nan")
        return sign * float(body)
    if text[0] in "&*":
        _fail(lineno, "an anchor or alias")
    if text[0] == "!":
        _fail(lineno, f"the tag {text.split()[0]!r}")
    if text[0] in "|>":
        _fail(lineno, "a block scalar")
    if text[0] in "{":
        _fail(lineno, "a flow mapping")
    if text[0] in "@`%,]}":
        _fail(lineno, f"a plain scalar starting with {text[0]!r}")
    if text.startswith("- ") or text == "-":
        _fail(lineno, "a block sequence")
    if ": " in text or text.endswith(":"):
        _fail(lineno, "a mapping inside a plain scalar")
    return text


def _quoted(text: str, lineno: int) -> str:
    """A whole single- or double-quoted scalar (simple escapes only)."""
    q = text[0]
    if len(text) < 2 or text[-1] != q:
        _fail(lineno, "an unterminated or multi-line quoted scalar")
    body = text[1:-1]
    if q == "'":
        if "'" in body.replace("''", ""):
            _fail(lineno, "a malformed single-quoted scalar")
        return body.replace("''", "'")
    out, i = [], 0
    escapes = {'"': '"', "\\": "\\", "/": "/", "n": "\n", "t": "\t", "r": "\r", "0": "\0"}
    while i < len(body):
        c = body[i]
        if c == '"':
            _fail(lineno, "a malformed double-quoted scalar")
        if c == "\\":
            if i + 1 >= len(body) or body[i + 1] not in escapes:
                _fail(lineno, "a double-quoted escape other than \\\" \\\\ \\/ \\n \\t \\r \\0")
            out.append(escapes[body[i + 1]])
            i += 2
            continue
        out.append(c)
        i += 1
    return "".join(out)


def _scalar(text: str, lineno: int):
    text = text.strip()
    if text[:1] in ("'", '"'):
        return _quoted(text, lineno)
    return _plain(text, lineno)


def _strip_comment(line: str) -> str:
    """`line` without its comment: a '#' at the start or after whitespace,
    outside a quoted scalar (a quote opens one only where a scalar starts)."""
    quote, last = None, ""  # `last`: the last non-space character outside quotes
    for i, c in enumerate(line):
        if quote:
            if c == quote:
                quote, last = None, c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
        elif c in "'\"" and last in ("", ":", "[", ","):
            quote = c
        elif not c.isspace():
            last = c
    return line.rstrip()


def _split_key(content: str, lineno: int):
    """(key, rest) of a `key: value` line; the key may be quoted."""
    if content[:1] in ("'", '"'):
        end = content.find(content[0], 1)
        while content[0] == "'" and end >= 0 and content[end + 1:end + 2] == "'":
            end = content.find("'", end + 2)
        if end < 0:
            _fail(lineno, "an unterminated quoted key")
        key = _quoted(content[:end + 1], lineno)
        rest = content[end + 1:]
        if not (rest.startswith(": ") or rest == ":"):
            _fail(lineno, "a quoted scalar where a key was expected")
        return key, rest[1:].strip()
    m = re.search(r":(?:\s|$)", content)
    if m is None:
        if content.startswith("- ") or content == "-":
            _fail(lineno, "a block sequence")
        _fail(lineno, f"a line that is no `key: value` ({content!r})")
    key = content[:m.start()].strip()
    if not key:
        _fail(lineno, "an empty key")
    if key[0] == "?":
        _fail(lineno, "a complex key")
    if key[0] in "[{":
        _fail(lineno, "a flow collection as a key")
    return _plain(key, lineno), content[m.end():].strip()


def _lines(text: str):
    """[(line number, indent, content)] of the document's content lines."""
    out, started, doc_marks = [], False, 0
    for lineno, raw in enumerate(text.splitlines(), 1):
        if not started and raw.startswith("%"):
            if raw.startswith("%YAML"):  # `%YAML 1.1` or OpenCV's `%YAML:1.0`
                continue
            _fail(lineno, f"the directive {raw.split()[0]!r}")
        body = _strip_comment(raw)
        if not body.strip():
            continue
        if body.rstrip() in ("---", "..."):
            if started or body.rstrip() == "..." or doc_marks:
                _fail(lineno, "a second document or a document end")
            doc_marks += 1
            continue
        if body.startswith("--- ") or body.startswith("... "):
            _fail(lineno, "content on a document marker")
        lead = body[:len(body) - len(body.lstrip())]
        if "\t" in lead:
            _fail(lineno, "a tab in indentation")
        started = True
        out.append((lineno, len(lead), body.strip()))
    return out


def _flow_sequence(lines, i: int, first: str):
    """A flow sequence of scalars starting with `first` (after its key),
    continued over the following lines until its ']'. Returns (list, next i)."""
    lineno = lines[i][0]
    text = first
    while text.count("[") > text.count("]"):
        i += 1
        if i >= len(lines):
            _fail(lineno, "an unterminated flow sequence")
        text += " " + lines[i][2]
    text = text.strip()
    if not text.endswith("]") or text.count("[") != 1 or text.count("]") != 1:
        _fail(lineno, "a nested flow collection or text after a flow sequence")
    inner = text[1:-1].strip()
    if "{" in inner or "}" in inner:
        _fail(lineno, "a flow mapping")
    items = [s.strip() for s in inner.split(",")] if inner else []
    if items and items[-1] == "":
        items.pop()  # a trailing comma
    if any(s == "" for s in items):
        _fail(lineno, "an empty flow sequence entry")
    return [_scalar(s, lineno) for s in items], i + 1


def _mapping(lines, i: int, indent: int):
    """The block mapping whose keys stand at `indent`, from line index i.
    Returns (dict, next i)."""
    out = {}
    while i < len(lines):
        lineno, ind, content = lines[i]
        if ind < indent:
            break
        if ind > indent:
            _fail(lineno, "a continued scalar or an indentation that opens no mapping")
        key, rest = _split_key(content, lineno)
        if rest.startswith(_IGNORED_TAG):
            rest = rest[len(_IGNORED_TAG):].strip()
            if rest:
                _fail(lineno, f"a value after {_IGNORED_TAG}")
        if rest == "":
            nxt = lines[i + 1] if i + 1 < len(lines) else None
            if nxt is not None and nxt[1] > indent:
                out[key], i = _mapping(lines, i + 1, nxt[1])
            else:
                out[key], i = None, i + 1
        elif rest.startswith("["):
            out[key], i = _flow_sequence(lines, i, rest)
        else:
            out[key] = _scalar(rest, lineno)
            i += 1
    return out, i


def loads(text: str):
    """The document in `text` as nested dicts, lists and scalars (None for
    an empty document)."""
    lines = _lines(text)
    if not lines:
        return None
    if lines[0][1] != 0:
        _fail(lines[0][0], "an indented first line")
    value, i = _mapping(lines, 0, 0)
    if i != len(lines):
        _fail(lines[i][0], "an indentation below the document's")
    return value


def load(path: str):
    """``loads`` of the file at `path`."""
    with open(path) as f:
        return loads(f.read())
