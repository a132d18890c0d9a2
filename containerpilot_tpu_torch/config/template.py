"""Config-file template rendering over the process environment.

Capability parity with the reference's template preprocessing
(reference: config/template/template.go): configs are rendered before
JSON5 parsing, with environment variables addressable as ``{{ .VAR }}``
(missing variables render empty — Go's ``missingkey=zero``) and the
same helper functions with the same argument order:

- ``default <fallback> <value>``  (template.go:126-136)
- ``env <name>``                  (template.go:62-64)
- ``split <sep> <s>`` / ``join <sep> <list>``    (template.go:19-32)
- ``replaceAll <from> <to> <s>``                 (template.go:36-38)
- ``regexReplaceAll <re> <to> <s>``              (template.go:41-47)
- ``loop [start] <stop>`` (ranges, descending supported; template.go:80-117)

plus pipelines (``{{ .VAR | default "x" }}`` appends the piped value as
the last argument), ``if``/``else``/``end`` blocks, and
``range``/``end`` blocks with ``.`` bound to the loop item.

This is a fresh implementation of the *template dialect the reference's
config files use*, not a Go text/template port: the grammar here is the
subset that appears in supervisor configs.

The port's own copy of ``containerpilot_tpu/config/template.py``.
"""
from __future__ import annotations

import os
import re
from typing import Any, Callable, Dict, List, Optional, Tuple, Union


class TemplateError(ValueError):
    """Template syntax or rendering error."""


# --- helper functions (reference: template.go) -----------------------------

def _fn_default(fallback: Any, value: Any = None) -> str:
    # only a non-empty string wins over the fallback
    # (reference: template.go:126-136)
    if isinstance(value, str) and value != "":
        return value
    return _to_string(fallback)


def _fn_env(name: Any) -> str:
    return os.environ.get(str(name), "")


def _fn_split(sep: Any, s: Any) -> List[str]:
    s = str(s).strip()
    if s == "":
        return []
    return s.split(str(sep))


def _fn_join(sep: Any, items: Any) -> str:
    if not items:
        return ""
    return str(sep).join(str(i) for i in items)


def _fn_replace_all(frm: Any, to: Any, s: Any) -> str:
    return str(s).replace(str(frm), str(to))


def _fn_regex_replace_all(pattern: Any, to: Any, s: Any) -> str:
    # Go regexp uses $1 for group refs; Python uses \1 — accept both
    replacement = re.sub(r"\$(\d+)", r"\\\1", str(to))
    return re.sub(str(pattern), replacement, str(s))


def _ensure_int(v: Any) -> int:
    if isinstance(v, str):
        return int(v)
    if isinstance(v, bool):
        raise TemplateError(f"loop: not an integer: {v!r}")
    if isinstance(v, (int, float)):
        return int(v)
    raise TemplateError(f"loop: not an integer: {v!r}")


def _fn_loop(*params: Any) -> List[int]:
    if len(params) == 1:
        start, stop = 0, _ensure_int(params[0])
    elif len(params) == 2:
        start, stop = _ensure_int(params[0]), _ensure_int(params[1])
    else:
        raise TemplateError(
            f"loop: wrong number of arguments, expected 1 or 2, got {len(params)}"
        )
    step = 1 if stop >= start else -1
    return list(range(start, stop, step))


def _check_comparable(a: Any, b: Any) -> None:
    """Go's eq/ne raise on incomparable basic kinds; env values are
    always strings and number literals are int/float, so a silent
    False on `eq .COUNT 2` would take the wrong branch with no
    diagnostic. Mirrors the reference for mixed numeric kinds too:
    Go treats int vs float as incomparable (``eq 1 1.0`` errors), so
    we reject it rather than silently returning Python's True."""
    def kind(v: Any) -> str:
        if isinstance(v, bool):
            return "bool"
        if isinstance(v, int):
            return "int"
        if isinstance(v, float):
            return "float"
        if isinstance(v, str):
            return "str"
        return "other"

    ka, kb = kind(a), kind(b)
    mismatch = (
        ka != kb
        and {ka, kb} <= {"str", "int", "float"}
    )
    if mismatch:
        hint = (
            "(env values are strings; quote the literal)"
            if "str" in (ka, kb)
            else "(int and float literals are incomparable kinds in "
            "Go templates; use matching literals)"
        )
        raise TemplateError(
            f"incompatible types for comparison: {a!r} vs {b!r} {hint}"
        )


def _fn_eq(first: Any, *rest: Any) -> bool:
    """Go text/template's builtin ``eq``: true when arg1 equals ANY of
    the remaining args (reference configs use it inside if blocks)."""
    if not rest:
        raise TemplateError("eq needs at least two arguments")
    for other in rest:
        _check_comparable(first, other)
    return any(first == other for other in rest)


def _fn_ne(a: Any, b: Any) -> bool:
    """Go text/template's builtin ``ne``."""
    _check_comparable(a, b)
    return a != b


FUNCS: Dict[str, Callable[..., Any]] = {
    "default": _fn_default,
    "env": _fn_env,
    "split": _fn_split,
    "join": _fn_join,
    "replaceAll": _fn_replace_all,
    "regexReplaceAll": _fn_regex_replace_all,
    "loop": _fn_loop,
    "eq": _fn_eq,
    "ne": _fn_ne,
}


def _to_string(v: Any) -> str:
    if v is None:
        return ""
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, list):
        return "[" + " ".join(_to_string(i) for i in v) + "]"
    return str(v)


def _truthy(v: Any) -> bool:
    if isinstance(v, str):
        return v != ""
    if isinstance(v, (list, dict)):
        return len(v) > 0
    return bool(v)


# --- expression mini-language ----------------------------------------------

_TOKEN = re.compile(
    r"""\s*(?:
        (?P<string>"(?:\\.|[^"\\])*")
      | (?P<number>-?\d+(?:\.\d+)?)
      | (?P<var>\.[A-Za-z_][A-Za-z0-9_]*)
      | (?P<dot>\.)
      | (?P<ident>[A-Za-z_][A-Za-z0-9_]*)
      | (?P<pipe>\|)
      | (?P<lparen>\()
      | (?P<rparen>\))
    )""",
    re.VERBOSE,
)


def _tokenize_expr(src: str) -> List[Tuple[str, str]]:
    tokens: List[Tuple[str, str]] = []
    pos = 0
    while pos < len(src):
        m = _TOKEN.match(src, pos)
        if not m or m.end() == pos:
            rest = src[pos:].strip()
            if not rest:
                break
            raise TemplateError(f"bad token in template expression: {rest!r}")
        pos = m.end()
        for kind in ("string", "number", "var", "dot", "ident", "pipe",
                     "lparen", "rparen"):
            val = m.group(kind)
            if val is not None:
                tokens.append((kind, val))
                break
    return tokens


class _ExprParser:
    """Parses one action's expression: pipeline of commands, each a
    function call or a term."""

    def __init__(self, tokens: List[Tuple[str, str]]) -> None:
        self.tokens = tokens
        self.pos = 0

    def peek(self) -> Optional[Tuple[str, str]]:
        return self.tokens[self.pos] if self.pos < len(self.tokens) else None

    def next(self) -> Tuple[str, str]:
        tok = self.tokens[self.pos]
        self.pos += 1
        return tok

    def parse_pipeline(self) -> "Pipeline":
        commands = [self.parse_command()]
        while self.peek() and self.peek()[0] == "pipe":
            self.next()
            commands.append(self.parse_command())
        return Pipeline(commands)

    def parse_command(self) -> "CommandNode":
        head = self.peek()
        if head is None:
            raise TemplateError("empty template expression")
        if head[0] == "ident":
            name = self.next()[1]
            args: List[Any] = []
            while self.peek() and self.peek()[0] not in ("pipe", "rparen"):
                args.append(self.parse_term())
            return CommandNode(func=name, args=args)
        term = self.parse_term()
        return CommandNode(func=None, args=[term])

    def parse_term(self) -> Any:
        kind, val = self.next()
        if kind == "string":
            # single left-to-right pass so \\n decodes to backslash+n,
            # not to a newline
            escapes = {'"': '"', "n": "\n", "t": "\t", "\\": "\\"}
            return StringLit(
                re.sub(
                    r"\\(.)",
                    lambda m: escapes.get(m.group(1), "\\" + m.group(1)),
                    val[1:-1],
                )
            )
        if kind == "number":
            return NumberLit(float(val) if "." in val else int(val))
        if kind == "var":
            return VarRef(val[1:])
        if kind == "dot":
            return DotRef()
        if kind == "lparen":
            inner = self.parse_pipeline()
            if not self.peek() or self.next()[0] != "rparen":
                raise TemplateError("unclosed '(' in template expression")
            return inner
        if kind == "ident":
            # bare identifier as arg: nested no-arg function (e.g. env)
            return CommandNode(func=val, args=[])
        raise TemplateError(f"unexpected token {val!r}")


class StringLit:
    def __init__(self, v: str) -> None:
        self.v = v

    def eval(self, ctx: "Context") -> Any:
        return self.v


class NumberLit:
    def __init__(self, v: Union[int, float]) -> None:
        self.v = v

    def eval(self, ctx: "Context") -> Any:
        return self.v


class VarRef:
    def __init__(self, name: str) -> None:
        self.name = name

    def eval(self, ctx: "Context") -> Any:
        return ctx.lookup(self.name)


class DotRef:
    def eval(self, ctx: "Context") -> Any:
        return ctx.dot


_SENTINEL = object()


class CommandNode:
    def __init__(self, func: Optional[str], args: List[Any]) -> None:
        self.func = func
        self.args = args

    def eval(self, ctx: "Context", piped: Any = _SENTINEL) -> Any:
        args = [a.eval(ctx) for a in self.args]
        if self.func is None:
            if piped is not _SENTINEL:
                raise TemplateError("cannot pipe into a literal")
            return args[0]
        fn = FUNCS.get(self.func)
        if fn is None:
            raise TemplateError(f"unknown template function: {self.func!r}")
        if piped is not _SENTINEL:
            args.append(piped)
        try:
            return fn(*args)
        except TemplateError:
            raise
        except Exception as exc:
            raise TemplateError(f"{self.func}: {exc}") from None


class Pipeline:
    def __init__(self, commands: List[CommandNode]) -> None:
        self.commands = commands

    def eval(self, ctx: "Context") -> Any:
        value = self.commands[0].eval(ctx)
        for cmd in self.commands[1:]:
            value = cmd.eval(ctx, value)
        return value


# --- block structure -------------------------------------------------------

class Context:
    def __init__(self, env: Dict[str, str], dot: Any = None) -> None:
        self.env = env
        self.dot = dot if dot is not None else env

    def lookup(self, name: str) -> str:
        # missingkey=zero: absent vars render as the zero value ""
        return self.env.get(name, "")

    def child(self, dot: Any) -> "Context":
        return Context(self.env, dot)


_ACTION = re.compile(r"\{\{-?\s*(.*?)\s*-?\}\}", re.DOTALL)


def _parse_blocks(src: str):
    """Split source into a node tree: text, actions, if/range blocks."""
    nodes: List[Any] = []
    stack: List[Tuple[str, Any, List[Any]]] = []  # (kind, pipeline, nodes)
    current = nodes
    pos = 0
    for m in _ACTION.finditer(src):
        if m.start() > pos:
            current.append(("text", src[pos:m.start()]))
        pos = m.end()
        body = m.group(1).strip()
        if body.startswith("if "):
            pipeline = _ExprParser(_tokenize_expr(body[3:])).parse_pipeline()
            stack.append(("if", pipeline, current))
            block: List[Any] = []
            current.append(("if", pipeline, block, None))
            current = block
        elif body.startswith("range "):
            pipeline = _ExprParser(_tokenize_expr(body[6:])).parse_pipeline()
            stack.append(("range", pipeline, current))
            block = []
            current.append(("range", pipeline, block))
            current = block
        elif body == "else":
            if not stack or stack[-1][0] != "if":
                raise TemplateError("'else' outside of 'if'")
            parent = stack[-1][2]
            # replace the if-node's else-branch with a fresh block
            kind, pipeline, then_block, _ = parent[-1]
            else_block: List[Any] = []
            parent[-1] = (kind, pipeline, then_block, else_block)
            current = else_block
        elif body == "end":
            if not stack:
                raise TemplateError("'end' without open block")
            _, _, parent = stack.pop()
            current = parent
        else:
            pipeline = _ExprParser(_tokenize_expr(body)).parse_pipeline()
            current.append(("expr", pipeline))
    if stack:
        raise TemplateError("unclosed block in template")
    if pos < len(src):
        current.append(("text", src[pos:]))
    return nodes


def _render_nodes(nodes: List[Any], ctx: Context, out: List[str]) -> None:
    for node in nodes:
        kind = node[0]
        if kind == "text":
            out.append(node[1])
        elif kind == "expr":
            out.append(_to_string(node[1].eval(ctx)))
        elif kind == "if":
            _, pipeline, then_block, else_block = node
            if _truthy(pipeline.eval(ctx)):
                _render_nodes(then_block, ctx, out)
            elif else_block:
                _render_nodes(else_block, ctx, out)
        elif kind == "range":
            _, pipeline, block = node
            items = pipeline.eval(ctx)
            if isinstance(items, dict):
                items = list(items.values())
            for item in items or []:
                _render_nodes(block, ctx.child(item), out)


def apply_template(
    config_text: str, env: Optional[Dict[str, str]] = None
) -> str:
    """Render a config template against the environment
    (reference: config/template/template.go:167-180)."""
    if env is None:
        env = dict(os.environ)
    nodes = _parse_blocks(config_text)
    out: List[str] = []
    _render_nodes(nodes, Context(env), out)
    return "".join(out)
