"""cpcheck's interprocedural layer: a project-wide call graph and the
rules that need to see across function and module boundaries.

The port's counterpart of ``containerpilot_tpu/analysis/callgraph.py``,
stdlib only. The reachability rules reuse this package's cpcheck
catalogs, so CP-ASYNCREACH and CP-HOTREACH see the torch names
(``torch.cuda.synchronize``, ``.cpu()``, ``.tolist()``, ``.numpy()``,
``.synchronize()``) as well as the JAX ones.

All ten cpcheck rules are lexical — each looks at one function body in
one module. That misses exactly the failures this repo's runtime
machinery exists to catch late: a ``time.sleep`` one sync-helper deep
on an async request path (CP-ASYNCREACH), a ``# cpcheck: hotpath``
region whose helpers do host syncs the lexical CP-HOTSYNC never sees
(CP-HOTREACH), a lock-order inversion split across two modules that
racecheck's runtime tests never happened to drive (CP-LOCKORDER), and
a heartbeat note field whose producer and parser drifted apart
(CP-NOTEWIRE, the static face of ``fleet/notes.py``).

The graph is deliberately honest rather than clever:

- **Resolved edges** come only from constructs the resolver actually
  understands: module functions (local or imported by name),
  ``self.``/``cls.`` methods (including single-inheritance bases the
  project can see), methods on module-level or function-local
  instances of project classes, and ``mod.func`` through an imported
  module alias.
- **Deferred edges** — ``functools.partial(f, ...)`` targets and
  ``spawn(coro())`` / ``create_task`` / ``ensure_future`` targets —
  are resolved and recorded (kind ``partial`` / ``spawn``) but NOT
  walked by the synchronous-reachability rules: the callee runs
  later, on some other frame, not inside the caller's await-free
  window.
- **Sanctioned edges** are callables referenced inside
  ``run_in_executor(...)`` / ``to_thread(...)`` arguments: the escape
  hatch, recognized at ANY hop, never traversed.
- **Unknown edges** (a duck-typed ``self.server.foo()``, a method on
  an attribute-sourced object, a name the resolver can't find) are
  RECORDED with a reason, never guessed at. Reachability simply
  stops there; ``CallGraph.unknown`` keeps the honesty auditable.

Parsing is paid once: ``ProjectContext`` holds the parsed-AST forest
(one ``ModuleContext`` per file) and the built ``CallGraph``, shared
by every rule in a scan.
"""
from __future__ import annotations

import ast
import builtins
import os
from collections import deque
from dataclasses import dataclass, field
from typing import (
    Dict,
    Iterable,
    List,
    Mapping,
    Optional,
    Sequence,
    Set,
    Tuple,
)

from .cpcheck import (
    AsyncBlockRule,
    Finding,
    HotSyncRule,
    LockPubRule,
    ModuleContext,
    RetraceRule,
    _body_nodes,
    _expr_path,
    _is_hotpath,
    _Pragmas,
    _index_scopes,
    dotted_name,
)

_BUILTIN_NAMES = frozenset(dir(builtins))

#: call tails whose arguments are the sanctioned off-loop escape
EXECUTOR_TAILS = AsyncBlockRule.EXECUTOR_TAILS
#: call tails that schedule their first argument to run LATER
SPAWN_TAILS = {"spawn", "create_task", "ensure_future"}
PARTIAL_TAILS = {"partial"}

#: edge kinds the synchronous-reachability rules may walk
SYNC_KINDS = ("direct", "method")


def module_name(path: str) -> str:
    """Dotted module name for a repo-relative path:
    ``containerpilot_tpu_torch/fleet/member.py`` ->
    ``containerpilot_tpu_torch.fleet.member`` (and the reference's
    paths to ``containerpilot_tpu.*``); ``__init__.py`` names the
    package itself; non-.py scratch paths name themselves."""
    name = path[:-3] if path.endswith(".py") else path
    name = name.replace(os.sep, "/").replace("/", ".")
    if name.endswith(".__init__"):
        name = name[: -len(".__init__")]
    return name


@dataclass
class FunctionInfo:
    """One function or method the graph knows about."""

    key: str          # "<module>:<qualified scope>"
    module: str       # dotted module name
    scope: str        # qualname inside the module ("Cls.meth")
    node: ast.AST     # the FunctionDef / AsyncFunctionDef
    ctx: ModuleContext
    cls: Optional[str] = None  # enclosing class name, if a method

    @property
    def is_async(self) -> bool:
        return isinstance(self.node, ast.AsyncFunctionDef)

    @property
    def display(self) -> str:
        return f"{self.module}.{self.scope}"


@dataclass(frozen=True)
class CallEdge:
    """A resolved call: caller -> callee, with enough provenance to
    print a witness path."""

    caller: str
    callee: str
    lineno: int
    kind: str          # direct | method | partial | spawn
    sanctioned: bool   # referenced inside run_in_executor/to_thread


@dataclass(frozen=True)
class UnknownEdge:
    """A call the resolver refused to guess at — recorded, not lost."""

    caller: str
    name: str
    lineno: int
    reason: str


@dataclass
class _ClassInfo:
    name: str
    methods: Dict[str, ast.AST] = field(default_factory=dict)
    bases: Tuple[str, ...] = ()


@dataclass
class _ModuleInfo:
    """Per-module symbol table feeding resolution."""

    ctx: ModuleContext
    name: str
    is_package: bool = False
    funcs: Dict[str, ast.AST] = field(default_factory=dict)
    classes: Dict[str, _ClassInfo] = field(default_factory=dict)
    #: import alias -> dotted module name
    imports_mod: Dict[str, str] = field(default_factory=dict)
    #: import alias -> (dotted module name, symbol)
    imports_sym: Dict[str, Tuple[str, str]] = field(default_factory=dict)
    #: module-level `name = SomeClass()` instances -> (module, class)
    instances: Dict[str, Tuple[str, str]] = field(default_factory=dict)
    #: every module-level assigned name (lock-identity qualification)
    global_names: Set[str] = field(default_factory=set)


class ProjectContext:
    """The parsed-AST forest for one scan: every ModuleContext, the
    symbol tables, and (built once, lazily) the call graph. Shared by
    all interprocedural rules so each file is parsed exactly once."""

    def __init__(self, contexts: Sequence[ModuleContext]) -> None:
        self.contexts: List[ModuleContext] = list(contexts)
        self.by_path: Dict[str, ModuleContext] = {
            ctx.path: ctx for ctx in self.contexts
        }
        self._graph: Optional[CallGraph] = None

    @property
    def graph(self) -> "CallGraph":
        if self._graph is None:
            self._graph = CallGraph(self)
        return self._graph


def build_project(sources: Mapping[str, str]) -> ProjectContext:
    """Parse a ``{path: source}`` mapping into a ProjectContext —
    the in-memory entry point tests and scan_source use."""
    contexts = []
    for path in sorted(sources):
        tree = ast.parse(sources[path], filename=path)
        ctx = ModuleContext(
            path=path,
            tree=tree,
            lines=sources[path].splitlines(),
            pragmas=_Pragmas(sources[path]),
        )
        _index_scopes(ctx)
        contexts.append(ctx)
    return ProjectContext(contexts)


def build_project_from_paths(
    paths: Sequence[str], relative_to: str
) -> ProjectContext:
    """Parse files from disk; paths are reported (and keyed)
    relative to ``relative_to``, matching scan_file's convention."""
    sources: Dict[str, str] = {}
    for path in paths:
        rel = os.path.relpath(path, relative_to).replace(os.sep, "/")
        with open(path, "r", encoding="utf-8") as fh:
            sources[rel] = fh.read()
    return build_project(sources)


class CallGraph:
    """Project-wide symbol table + call edges + reachability."""

    def __init__(self, project: ProjectContext) -> None:
        self.project = project
        self.modules: Dict[str, _ModuleInfo] = {}
        self.functions: Dict[str, FunctionInfo] = {}
        self.edges_from: Dict[str, List[CallEdge]] = {}
        self.unknown: List[UnknownEdge] = []
        for ctx in project.contexts:
            self._index_module(ctx)
        for info in list(self.functions.values()):
            self._extract_edges(info)

    # -- symbol tables -------------------------------------------------

    def _index_module(self, ctx: ModuleContext) -> None:
        mod = _ModuleInfo(
            ctx=ctx,
            name=module_name(ctx.path),
            is_package=ctx.path.endswith("__init__.py"),
        )
        self.modules[mod.name] = mod
        for stmt in ctx.tree.body:
            if isinstance(stmt, (ast.Import,)):
                for alias in stmt.names:
                    mod.imports_mod[
                        alias.asname or alias.name.partition(".")[0]
                    ] = alias.name if alias.asname else (
                        alias.name.partition(".")[0]
                    )
            elif isinstance(stmt, ast.ImportFrom):
                target = self._import_base(mod, stmt)
                if target is None:
                    continue
                for alias in stmt.names:
                    if alias.name == "*":
                        continue
                    mod.imports_sym[alias.asname or alias.name] = (
                        target, alias.name
                    )
            elif isinstance(
                stmt, (ast.FunctionDef, ast.AsyncFunctionDef)
            ):
                mod.funcs[stmt.name] = stmt
                self._add_function(mod, ctx, stmt, cls=None)
            elif isinstance(stmt, ast.ClassDef):
                info = _ClassInfo(
                    name=stmt.name,
                    bases=tuple(
                        dotted_name(b) for b in stmt.bases
                        if dotted_name(b)
                    ),
                )
                mod.classes[stmt.name] = info
                for member in stmt.body:
                    if isinstance(
                        member,
                        (ast.FunctionDef, ast.AsyncFunctionDef),
                    ):
                        info.methods[member.name] = member
                        self._add_function(
                            mod, ctx, member, cls=stmt.name
                        )
            elif isinstance(stmt, ast.Assign):
                for target in stmt.targets:
                    if isinstance(target, ast.Name):
                        mod.global_names.add(target.id)
        # module-level instances need classes + imports indexed first
        for stmt in ctx.tree.body:
            if not (
                isinstance(stmt, ast.Assign)
                and isinstance(stmt.value, ast.Call)
            ):
                continue
            cls = self._resolve_class(mod, dotted_name(stmt.value.func))
            if cls is None:
                continue
            for target in stmt.targets:
                if isinstance(target, ast.Name):
                    mod.instances[target.id] = cls

    @staticmethod
    def _import_base(
        mod: _ModuleInfo, stmt: ast.ImportFrom
    ) -> Optional[str]:
        """Absolute module a ``from X import ...`` names, resolving
        relative levels against this module's package."""
        if stmt.level == 0:
            return stmt.module
        # a package __init__'s own name IS its package; a plain
        # module's package is its parent
        pkg = mod.name.split(".")
        if not mod.is_package:
            pkg = pkg[:-1]
        drop = stmt.level - 1
        if drop > len(pkg):
            return None
        base = pkg[: len(pkg) - drop]
        if stmt.module:
            base = base + stmt.module.split(".")
        return ".".join(base) if base else None

    def _add_function(
        self,
        mod: _ModuleInfo,
        ctx: ModuleContext,
        node: ast.AST,
        cls: Optional[str],
    ) -> None:
        scope = f"{cls}.{node.name}" if cls else node.name
        key = f"{mod.name}:{scope}"
        self.functions[key] = FunctionInfo(
            key=key, module=mod.name, scope=scope,
            node=node, ctx=ctx, cls=cls,
        )

    # -- resolution ----------------------------------------------------

    def _resolve_class(
        self, mod: _ModuleInfo, name: str
    ) -> Optional[Tuple[str, str]]:
        """``(module, class)`` a dotted name refers to, else None."""
        if not name:
            return None
        parts = name.split(".")
        if len(parts) == 1:
            if parts[0] in mod.classes:
                return (mod.name, parts[0])
            sym = mod.imports_sym.get(parts[0])
            if sym:
                target = self.modules.get(sym[0])
                if target and sym[1] in target.classes:
                    return (sym[0], sym[1])
            return None
        if len(parts) == 2 and parts[0] in mod.imports_mod:
            target = self.modules.get(mod.imports_mod[parts[0]])
            if target and parts[1] in target.classes:
                return (target.name, parts[1])
        return None

    def _method_key(
        self, cmod: str, cname: str, meth: str,
        seen: Optional[Set[str]] = None,
    ) -> Optional[str]:
        """Resolve a method on class ``cmod.cname``, walking base
        classes the project can see (single inheritance chains)."""
        seen = seen if seen is not None else set()
        if f"{cmod}.{cname}" in seen:
            return None
        seen.add(f"{cmod}.{cname}")
        mod = self.modules.get(cmod)
        if mod is None:
            return None
        info = mod.classes.get(cname)
        if info is None:
            return None
        if meth in info.methods:
            return f"{cmod}:{cname}.{meth}"
        for base in info.bases:
            resolved = self._resolve_class(mod, base)
            if resolved:
                key = self._method_key(
                    resolved[0], resolved[1], meth, seen
                )
                if key:
                    return key
        return None

    def resolve(
        self,
        mod: _ModuleInfo,
        name: str,
        current_cls: Optional[str],
        local_types: Mapping[str, Tuple[str, str]],
    ) -> Tuple[Optional[str], Optional[str]]:
        """Resolve a dotted call name to a function key.

        Returns ``(key, None)`` on success, ``(None, reason)`` for an
        honest unknown, and ``(None, None)`` for calls that are
        out of scope for the graph (builtins, external modules,
        constructors — nothing to record)."""
        if not name:
            return None, "unresolvable call expression"
        parts = name.split(".")
        head = parts[0]
        if len(parts) == 1:
            if head in mod.funcs:
                return f"{mod.name}:{head}", None
            sym = mod.imports_sym.get(head)
            if sym is not None:
                target = self.modules.get(sym[0])
                if target is None:
                    return None, None  # external import
                if sym[1] in target.funcs:
                    return f"{target.name}:{sym[1]}", None
                if sym[1] in target.classes:
                    return None, None  # constructor
                # re-exported through a package __init__ we parsed
                hop = target.imports_sym.get(sym[1])
                if hop is not None:
                    hop_mod = self.modules.get(hop[0])
                    if hop_mod and hop[1] in hop_mod.funcs:
                        return f"{hop_mod.name}:{hop[1]}", None
                return None, None
            if head in mod.classes or head in _BUILTIN_NAMES:
                return None, None  # constructor / builtin
            if head in local_types or head in mod.instances:
                return None, None  # calling the instance itself
            return None, None  # plain local callable variable etc.
        # dotted: resolve the receiver
        rest = parts[1:]
        if head in ("self", "cls") and current_cls:
            if len(rest) == 1:
                key = self._method_key(mod.name, current_cls, rest[0])
                if key:
                    return key, None
                return None, (
                    f"method `{name}` not found on "
                    f"{mod.name}.{current_cls} or its visible bases"
                )
            return None, f"attribute chain `{name}` not typed"
        receiver_cls = local_types.get(head) or mod.instances.get(head)
        if receiver_cls and len(rest) == 1:
            key = self._method_key(
                receiver_cls[0], receiver_cls[1], rest[0]
            )
            if key:
                return key, None
            return None, (
                f"method `{rest[0]}` not found on instance of "
                f"{receiver_cls[0]}.{receiver_cls[1]}"
            )
        if head in mod.imports_mod:
            target = self.modules.get(mod.imports_mod[head])
            if target is None:
                return None, None  # stdlib / external module
            if len(rest) == 1 and rest[0] in target.funcs:
                return f"{target.name}:{rest[0]}", None
            if len(rest) == 2 and rest[0] in target.classes:
                key = self._method_key(target.name, rest[0], rest[1])
                if key:
                    return key, None
            return None, None
        if head in mod.imports_sym:
            # module imported from a package: `from .. import notes`
            sym = mod.imports_sym[head]
            dotted = f"{sym[0]}.{sym[1]}"
            target = self.modules.get(dotted)
            if target and len(rest) == 1 and rest[0] in target.funcs:
                return f"{target.name}:{rest[0]}", None
            if target is not None:
                return None, None
        if head in ("self", "cls"):
            return None, f"`{name}` outside a known class"
        # a call through an untyped receiver: the honest unknown
        return None, f"receiver `{head}` has no known type"

    # -- edge extraction -----------------------------------------------

    def _extract_edges(self, info: FunctionInfo) -> None:
        mod = self.modules[info.module]
        edges: List[CallEdge] = []
        local_types: Dict[str, Tuple[str, str]] = {}
        body = getattr(info.node, "body", [])
        for node in _body_nodes(body, skip_defs=True):
            if isinstance(node, ast.Assign) and isinstance(
                node.value, ast.Call
            ):
                cls = self._resolve_class(
                    mod, dotted_name(node.value.func)
                )
                if cls:
                    for target in node.targets:
                        if isinstance(target, ast.Name):
                            local_types[target.id] = cls

        def add(
            target: Optional[str],
            reason: Optional[str],
            node: ast.AST,
            kind: str,
            sanctioned: bool,
            name: str,
        ) -> None:
            if target is not None:
                edges.append(CallEdge(
                    caller=info.key, callee=target,
                    lineno=node.lineno, kind=kind,
                    sanctioned=sanctioned,
                ))
            elif reason is not None:
                self.unknown.append(UnknownEdge(
                    caller=info.key, name=name,
                    lineno=node.lineno, reason=reason,
                ))

        def resolve_ref(expr: ast.AST) -> Tuple[
            Optional[str], Optional[str], str
        ]:
            name = dotted_name(expr)
            key, reason = self.resolve(
                mod, name, info.cls, local_types
            )
            return key, reason, name

        def visit(node: ast.AST, sanctioned: bool) -> None:
            if isinstance(
                node,
                (ast.FunctionDef, ast.AsyncFunctionDef,
                 ast.ClassDef, ast.Lambda),
            ):
                return  # nested defs run later, on their own frames
            if isinstance(node, ast.Call):
                name = dotted_name(node.func)
                tail = name.rpartition(".")[2]
                if tail in EXECUTOR_TAILS:
                    # arguments are the escape hatch: callables named
                    # here become sanctioned edges, and calls nested
                    # inside run on the executor, not this frame
                    for arg in list(node.args) + [
                        kw.value for kw in node.keywords
                    ]:
                        visit(arg, True)
                    return
                if tail in SPAWN_TAILS and node.args and isinstance(
                    node.args[0], ast.Call
                ):
                    inner = node.args[0]
                    key, reason, iname = resolve_ref(inner.func)
                    add(key, reason, inner, "spawn", True, iname)
                    for arg in list(inner.args) + [
                        kw.value for kw in inner.keywords
                    ]:
                        visit(arg, sanctioned)
                    for arg in list(node.args[1:]) + [
                        kw.value for kw in node.keywords
                    ]:
                        visit(arg, sanctioned)
                    return
                if tail in PARTIAL_TAILS and node.args:
                    key, reason, iname = resolve_ref(node.args[0])
                    add(
                        key, reason, node, "partial", sanctioned,
                        iname,
                    )
                    for arg in list(node.args[1:]) + [
                        kw.value for kw in node.keywords
                    ]:
                        visit(arg, sanctioned)
                    return
                key, reason, _ = resolve_ref(node.func)
                if key is not None:
                    callee = self.functions.get(key)
                    kind = (
                        "method"
                        if callee is not None and callee.cls
                        else "direct"
                    )
                    add(key, None, node, kind, sanctioned, name)
                elif reason is not None:
                    add(None, reason, node, "direct", sanctioned, name)
                # descend into arguments (and a computed func
                # expression), but not the plain func name itself —
                # the edge above already covers it
                if not isinstance(
                    node.func, (ast.Name, ast.Attribute)
                ):
                    visit(node.func, sanctioned)
                for arg in list(node.args) + [
                    kw.value for kw in node.keywords
                ]:
                    visit(arg, sanctioned)
                return
            # a bare callable reference inside executor args (the
            # `run_in_executor(None, fn)` shape) becomes a
            # sanctioned edge; its identity resolving to nothing is
            # normal data, not an unknown worth recording
            if sanctioned and isinstance(
                node, (ast.Name, ast.Attribute)
            ):
                key, _reason, name = resolve_ref(node)
                if key is not None:
                    add(key, None, node, "direct", True, name)
                return
            for child in ast.iter_child_nodes(node):
                visit(child, sanctioned)

        for stmt in body:
            visit(stmt, False)
        self.edges_from[info.key] = edges

    # -- queries -------------------------------------------------------

    def sync_reachable(
        self,
        root: str,
        max_hops: Optional[int] = None,
    ) -> Iterable[Tuple[FunctionInfo, Tuple[CallEdge, ...]]]:
        """BFS over UNsanctioned, synchronous (direct/method) edges
        from ``root``, yielding each reached SYNC function once with
        the (shortest) edge path that reached it. Async callees are
        not yielded or traversed: an awaited coroutine suspends, it
        does not hold the caller's frame; deferred kinds (partial,
        spawn) run later, elsewhere."""
        seen: Set[str] = {root}
        queue: deque = deque([(root, ())])
        while queue:
            key, path = queue.popleft()
            if max_hops is not None and len(path) >= max_hops:
                continue
            for edge in self.edges_from.get(key, ()):
                if edge.sanctioned or edge.kind not in SYNC_KINDS:
                    continue
                if edge.callee in seen:
                    continue
                callee = self.functions.get(edge.callee)
                if callee is None or callee.is_async:
                    continue
                seen.add(edge.callee)
                new_path = path + (edge,)
                yield callee, new_path
                queue.append((edge.callee, new_path))


# -- interprocedural rules -------------------------------------------------


class ProjectRule:
    """Base: like cpcheck.Rule, but ``run_project`` sees the whole
    forest + graph at once instead of one module."""

    rule_id = "CP-NONE"

    def run_project(
        self, project: ProjectContext
    ) -> List[Finding]:  # pragma: no cover - interface
        raise NotImplementedError

    def finding_at(
        self,
        ctx: ModuleContext,
        lineno: int,
        scope: str,
        message: str,
    ) -> Optional[Finding]:
        if ctx.pragmas.is_disabled(self.rule_id, lineno):
            return None
        return Finding(
            rule=self.rule_id, file=ctx.path, line=lineno,
            scope=scope, text=ctx.line_text(lineno), message=message,
        )


def _blocking_calls(
    fn: ast.AST,
) -> Iterable[Tuple[ast.Call, str]]:
    """CP-ASYNCBLOCK catalog hits in a function body, with the
    executor escape honored lexically (calls inside
    run_in_executor/to_thread arguments are healed) and nested defs
    skipped. Name-catalog only — the .result()/.join() dataflow part
    of CP-ASYNCBLOCK stays lexical, where its aliasing is sound."""
    out: List[Tuple[ast.Call, str]] = []

    def visit(node: ast.AST) -> None:
        if isinstance(
            node,
            (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef,
             ast.Lambda),
        ):
            return
        if isinstance(node, ast.Call):
            name = dotted_name(node.func)
            tail = name.rpartition(".")[2]
            if tail in EXECUTOR_TAILS:
                visit(node.func)
                return
            if (
                name in AsyncBlockRule.BLOCKED_NAMES
                or tail in AsyncBlockRule.BLOCKED_TAILS
            ):
                out.append((node, name or tail))
        for child in ast.iter_child_nodes(node):
            visit(child)

    for stmt in getattr(fn, "body", []):
        visit(stmt)
    return out


def _chain(root: FunctionInfo, path: Sequence[CallEdge],
           graph: CallGraph) -> str:
    names = [root.display]
    for edge in path:
        callee = graph.functions.get(edge.callee)
        names.append(callee.display if callee else edge.callee)
    return " -> ".join(names)


class AsyncReachRule(ProjectRule):
    """CP-ASYNCREACH: a blocking call reachable from an ``async def``
    through at most 3 synchronous call hops.

    CP-ASYNCBLOCK only fires on direct lexical containment; one
    innocent-looking sync helper hides the stall. This rule walks the
    call graph from every async function over resolved sync edges
    (hop bound 3 — deep chains get noisy and helper 4 is still
    covered from helper 1's own callers), flagging CP-ASYNCBLOCK
    name-catalog hits in any reached helper. The executor heal is
    recognized at ANY hop: a sanctioned edge is never traversed, and
    a blocking call lexically inside executor args inside a helper is
    healed exactly as the lexical rule heals it. The finding anchors
    at the FIRST hop's call site in the async function — that is the
    line its author can fix — with the full chain in the message."""

    rule_id = "CP-ASYNCREACH"

    MAX_HOPS = 3

    def run_project(self, project: ProjectContext) -> List[Finding]:
        graph = project.graph
        findings: List[Finding] = []
        for info in graph.functions.values():
            if not info.is_async:
                continue
            for helper, path in graph.sync_reachable(
                info.key, max_hops=self.MAX_HOPS
            ):
                for call, name in _blocking_calls(helper.node):
                    if helper.ctx.pragmas.is_disabled(
                        self.rule_id, call.lineno
                    ):
                        continue
                    first = path[0]
                    f = self.finding_at(
                        info.ctx, first.lineno, info.scope,
                        f"blocking `{name}` reachable from async "
                        f"`{info.scope}` via "
                        f"{_chain(info, path, graph)} "
                        f"({helper.ctx.path}:{call.lineno}): "
                        "stalls the event loop — run the chain in "
                        "an executor or heal the hop",
                    )
                    if f:
                        findings.append(f)
        return findings


class HotReachRule(ProjectRule):
    """CP-HOTREACH: ``# cpcheck: hotpath`` propagates through the
    call graph.

    A hot function's helpers execute inside the same decode round;
    lexically they escape CP-HOTSYNC/CP-RETRACE entirely. This rule
    reaches every sync helper transitively callable from a hot root
    (no hop bound — heat is transitive; sanctioned and deferred edges
    excluded) and runs the HOTSYNC catalog and RETRACE varying-arg
    checks on the INHERITED functions, anchoring each finding at the
    violating line in the helper with the inheritance chain in the
    message. Roots themselves stay the lexical rules' business. A
    helper's existing `disable=CP-HOTSYNC` / `CP-RETRACE` pragma is
    honored for the inherited check too — one deliberate sync point
    stays one annotation."""

    rule_id = "CP-HOTREACH"

    def run_project(self, project: ProjectContext) -> List[Finding]:
        graph = project.graph
        retrace = RetraceRule()
        jit_bound_cache: Dict[str, Set[str]] = {}
        findings: List[Finding] = []
        hot_roots = [
            info for info in graph.functions.values()
            if _is_hotpath(info.node, info.ctx)
        ]
        reported: Set[Tuple[str, int]] = set()
        for root in hot_roots:
            for helper, path in graph.sync_reachable(root.key):
                if _is_hotpath(helper.node, helper.ctx):
                    continue  # its own root; lexical rules cover it
                if helper.ctx.pragmas.is_disabled(
                    self.rule_id, helper.node.lineno
                ):
                    # a disable pragma on the `def` line opts the whole
                    # function out of heat inheritance — for helpers
                    # that are deliberately cold (debug dumps, guarded
                    # slow paths) one annotation beats one per line
                    continue
                chain = _chain(root, path, graph)
                findings.extend(self._check_inherited(
                    helper, chain, retrace, jit_bound_cache, reported
                ))
        return findings

    def _check_inherited(
        self,
        helper: FunctionInfo,
        chain: str,
        retrace: RetraceRule,
        jit_bound_cache: Dict[str, Set[str]],
        reported: Set[Tuple[str, int]],
    ) -> List[Finding]:
        ctx = helper.ctx
        findings: List[Finding] = []

        def emit(node: ast.AST, message: str, shadow: str) -> None:
            # a pragma for the lexical twin rule heals the inherited
            # check too; dedupe across multiple hot roots
            if ctx.pragmas.is_disabled(shadow, node.lineno):
                return
            if (ctx.path, node.lineno) in reported:
                return
            f = self.finding_at(
                ctx, node.lineno, helper.scope, message
            )
            if f:
                reported.add((ctx.path, node.lineno))
                findings.append(f)

        for sub in _body_nodes(
            getattr(helper.node, "body", []), skip_defs=True
        ):
            if not isinstance(sub, ast.Call):
                continue
            name = dotted_name(sub.func)
            tail = name.rpartition(".")[2]
            if (
                name in HotSyncRule.BLOCKED_NAMES
                or tail in HotSyncRule.BLOCKED_ATTRS
            ):
                emit(
                    sub,
                    f"host sync `{name or tail}` in `{helper.scope}`,"
                    f" which inherits hotpath via {chain}",
                    HotSyncRule.rule_id,
                )
                continue
            if ctx.path not in jit_bound_cache:
                jit_bound_cache[ctx.path] = retrace._jit_bound(ctx)
            bound = jit_bound_cache[ctx.path]
            jitted = (
                name in bound
                or tail in bound
                or name in RetraceRule.SCAN_NAMES
            )
            if not jitted:
                continue
            for arg in list(sub.args) + [
                kw.value for kw in sub.keywords
            ]:
                reason = retrace._varying(arg)
                if reason is None:
                    continue
                emit(
                    sub,
                    f"jitted `{name}` called with {reason} in "
                    f"`{helper.scope}`, which inherits hotpath via "
                    f"{chain}: every distinct value is a silent "
                    "recompile",
                    RetraceRule.rule_id,
                )
                break
        return findings


@dataclass(frozen=True)
class _LockEdge:
    """held -> acquired, with one witness location."""

    held: str
    acquired: str
    ctx: ModuleContext
    lineno: int
    scope: str
    via: str  # "" for a direct nested acquire, else the call chain


class LockOrderRule(ProjectRule):
    """CP-LOCKORDER: a cycle in the project-wide lock acquisition-
    order graph — the static face of racecheck.

    Per function, ``with``/``async with`` acquisitions of lockish
    objects (LockPubRule's heuristic: a name containing lock/mutex,
    or an ``.acquire()`` context) are summarized; while lock A is
    held, a directly-nested acquisition of B — or a call into a
    function whose TRANSITIVE summary acquires B — adds the edge
    A -> B. Identities are qualified (``self._lock`` on a method of
    ``m.C`` is ``m.C._lock``; module globals are module-qualified;
    anything else stays function-local and can't alias). A cycle
    means two code paths can interleave into a deadlock racecheck's
    runtime tests would only catch if they happened to drive both
    orders under contention; the finding carries BOTH witness paths.
    Reentrant self-edges (A -> A) are skipped: same-lock reentry is
    RLock's business, not ordering's."""

    rule_id = "CP-LOCKORDER"

    def run_project(self, project: ProjectContext) -> List[Finding]:
        graph = project.graph
        # per-function: direct acquisitions + (held, call-edge) pairs
        direct: Dict[str, List[Tuple[str, int]]] = {}
        held_calls: Dict[
            str, List[Tuple[Tuple[str, ...], CallEdge]]
        ] = {}
        direct_edges: List[_LockEdge] = []
        for info in graph.functions.values():
            self._summarize(
                graph, info, direct, held_calls, direct_edges
            )
        # transitive acquisition summaries, memoized over the graph
        memo: Dict[str, Dict[str, str]] = {}

        def transitive(key: str, stack: Set[str]) -> Dict[str, str]:
            """lock -> display-chain of the function that acquires
            it, for every lock a call to ``key`` may take."""
            if key in memo:
                return memo[key]
            if key in stack:
                return {}
            stack.add(key)
            info = graph.functions.get(key)
            out: Dict[str, str] = {}
            for lock, _lineno in direct.get(key, ()):
                out.setdefault(lock, info.display if info else key)
            for edge in graph.edges_from.get(key, ()):
                if edge.sanctioned or edge.kind not in SYNC_KINDS:
                    continue
                for lock, via in transitive(
                    edge.callee, stack
                ).items():
                    out.setdefault(lock, via)
            stack.discard(key)
            memo[key] = out
            return out

        # build the acquisition-order graph with witnesses
        order: Dict[str, Dict[str, _LockEdge]] = {}

        def add_edge(edge: _LockEdge) -> None:
            if edge.held == edge.acquired:
                return  # reentry, not ordering
            order.setdefault(edge.held, {}).setdefault(
                edge.acquired, edge
            )

        for key, pairs in held_calls.items():
            info = graph.functions[key]
            for held_stack, item in pairs:
                callee_locks = transitive(item.callee, set())
                for lock, via in callee_locks.items():
                    for held in held_stack:
                        add_edge(_LockEdge(
                            held=held, acquired=lock,
                            ctx=info.ctx, lineno=item.lineno,
                            scope=info.scope,
                            via=via,
                        ))
        for edge in direct_edges:
            add_edge(edge)

        return self._report_cycles(order)

    def _summarize(
        self,
        graph: CallGraph,
        info: FunctionInfo,
        direct: Dict[str, List[Tuple[str, int]]],
        held_calls: Dict[
            str, List[Tuple[Tuple[str, ...], CallEdge]]
        ],
        direct_edges: List[_LockEdge],
    ) -> None:
        mod = graph.modules[info.module]
        acquired: List[Tuple[str, int]] = []
        pairs: List[Tuple[Tuple[str, ...], CallEdge]] = []
        edges_by_line: Dict[int, List[CallEdge]] = {}
        for edge in graph.edges_from.get(info.key, ()):
            edges_by_line.setdefault(edge.lineno, []).append(edge)

        def lock_id(expr: ast.AST) -> Optional[str]:
            target = expr
            if isinstance(expr, ast.Call) and isinstance(
                expr.func, ast.Attribute
            ) and expr.func.attr == "acquire":
                target = expr.func.value
            if not LockPubRule._is_lockish(expr):
                return None
            path = _expr_path(target)
            if path is None:
                return None
            head, _, rest = path.partition(".")
            if head in ("self", "cls") and info.cls and rest:
                return f"{info.module}.{info.cls}.{rest}"
            if "." not in path and path in mod.global_names:
                return f"{info.module}.{path}"
            # function-local lock: scoped so it can never alias
            return f"{info.module}.{info.scope}:{path}"

        def visit(node: ast.AST, held: Tuple[str, ...]) -> None:
            if isinstance(
                node,
                (ast.FunctionDef, ast.AsyncFunctionDef,
                 ast.ClassDef, ast.Lambda),
            ):
                return
            if isinstance(node, (ast.With, ast.AsyncWith)):
                locks = []
                for item in node.items:
                    lk = lock_id(item.context_expr)
                    if lk is not None:
                        locks.append(lk)
                        acquired.append((lk, node.lineno))
                        for h in held:
                            direct_edges.append(_LockEdge(
                                held=h, acquired=lk,
                                ctx=info.ctx, lineno=node.lineno,
                                scope=info.scope, via="",
                            ))
                inner = held + tuple(locks)
                for item in node.items:
                    visit(item.context_expr, held)
                for stmt in node.body:
                    visit(stmt, inner)
                return
            if isinstance(node, ast.Call) and held:
                for edge in edges_by_line.get(node.lineno, ()):
                    pairs.append((held, edge))
            for child in ast.iter_child_nodes(node):
                visit(child, held)

        for stmt in getattr(info.node, "body", []):
            visit(stmt, ())
        if acquired:
            direct[info.key] = acquired
        if pairs:
            held_calls[info.key] = pairs

    def _report_cycles(
        self, order: Dict[str, Dict[str, _LockEdge]]
    ) -> List[Finding]:
        findings: List[Finding] = []
        seen_cycles: Set[Tuple[str, ...]] = set()
        for a in sorted(order):
            for b in sorted(order[a]):
                path = self._find_path(order, b, a)
                if path is None:
                    continue
                cycle = [order[a][b]] + path
                locks = tuple(sorted({e.held for e in cycle}))
                if locks in seen_cycles:
                    continue
                seen_cycles.add(locks)
                witness = "; ".join(
                    f"{e.held} -> {e.acquired} at "
                    f"{e.ctx.path}:{e.lineno} in {e.scope}"
                    + (f" (via {e.via})" if e.via else "")
                    for e in cycle
                )
                anchor = cycle[0]
                f = self.finding_at(
                    anchor.ctx, anchor.lineno, anchor.scope,
                    "lock-order cycle "
                    f"{' -> '.join(locks + (locks[0],))}: two "
                    "threads driving these paths concurrently can "
                    f"deadlock — witness: {witness}",
                )
                if f:
                    findings.append(f)
        return findings

    @staticmethod
    def _find_path(
        order: Dict[str, Dict[str, _LockEdge]],
        start: str,
        goal: str,
    ) -> Optional[List[_LockEdge]]:
        """Shortest edge path start -> ... -> goal, else None."""
        queue: deque = deque([(start, [])])
        seen = {start}
        while queue:
            node, path = queue.popleft()
            if node == goal:
                return path
            for nxt in sorted(order.get(node, ())):
                if nxt in seen:
                    continue
                seen.add(nxt)
                queue.append((nxt, path + [order[node][nxt]]))
        return None


class NoteWireRule(ProjectRule):
    """CP-NOTEWIRE: the heartbeat note wire has ONE schema —
    ``fleet/notes.py`` — and nothing routes around it.

    The registry is discovered structurally (a module assigning
    ``FIELDS = (NoteField(name="...", produce=..., parse=...), ...)``)
    so the rule checks what the code SHIPS, not what this rule
    remembers. Three checks:

    1. every registered field carries both a producer and a parser
       (a field produced that nothing can read — or parsed but never
       produced — is schema drift by construction);
    2. outside the registry module, no f-string or ``"x=" +``
       concatenation emits a registered field name — that emission
       bypasses ``member_note`` and whatever encoding discipline the
       registry's producer applies;
    3. every field CONSUMED from a split note (``fields["x"]``,
       ``fields.get("x")``, ``"x" in fields`` on a name bound from
       ``split_note``/``parse_kv_note``, or a literal
       ``parse_field("x", ...)``) must be registered — parsing a
       field nothing produces is dead wire vocabulary.

    Projects with no registry module (every fixture in the test
    suite's other rules) are out of scope: the rule is silent."""

    rule_id = "CP-NOTEWIRE"

    SPLIT_TAILS = {"split_note", "parse_kv_note"}

    def run_project(self, project: ProjectContext) -> List[Finding]:
        registries = self._find_registries(project)
        if not registries:
            return []
        findings: List[Finding] = []
        names: Set[str] = set()
        registry_paths = set()
        for ctx, fields in registries:
            registry_paths.add(ctx.path)
            for fname, (node, has_produce, has_parse) in (
                fields.items()
            ):
                names.add(fname)
                if not has_produce or not has_parse:
                    missing = "producer" if not has_produce else (
                        "parser"
                    )
                    f = self.finding_at(
                        ctx, node.lineno, ctx.scope_of(node),
                        f"note field `{fname}` registered without a "
                        f"{missing}: every wire field needs both "
                        "ends",
                    )
                    if f:
                        findings.append(f)
        for ctx in project.contexts:
            if ctx.path in registry_paths:
                continue
            findings.extend(self._check_bypass(ctx, names))
            findings.extend(self._check_consumption(ctx, names))
        return findings

    def _find_registries(
        self, project: ProjectContext
    ) -> List[Tuple[ModuleContext, Dict]]:
        out = []
        for ctx in project.contexts:
            fields = {}
            for stmt in ctx.tree.body:
                value = None
                if isinstance(stmt, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == "FIELDS"
                    for t in stmt.targets
                ):
                    value = stmt.value
                elif isinstance(stmt, ast.AnnAssign) and isinstance(
                    stmt.target, ast.Name
                ) and stmt.target.id == "FIELDS":
                    value = stmt.value
                if not isinstance(value, (ast.Tuple, ast.List)):
                    continue
                for elt in value.elts:
                    if not (
                        isinstance(elt, ast.Call)
                        and dotted_name(elt.func).rpartition(".")[2]
                        == "NoteField"
                    ):
                        continue
                    kw = {k.arg: k.value for k in elt.keywords}
                    name_node = kw.get("name")
                    if not (
                        isinstance(name_node, ast.Constant)
                        and isinstance(name_node.value, str)
                    ):
                        continue
                    fields[name_node.value] = (
                        elt,
                        _non_none(kw.get("produce")),
                        _non_none(kw.get("parse")),
                    )
            if fields:
                out.append((ctx, fields))
        return out

    def _check_bypass(
        self, ctx: ModuleContext, names: Set[str]
    ) -> List[Finding]:
        findings: List[Finding] = []
        markers = {f"{n}=" for n in names}

        def emit(node: ast.AST, fname: str, how: str) -> None:
            f = self.finding_at(
                ctx, node.lineno, ctx.scope_of(node),
                f"ad-hoc `{fname}=` {how} bypasses the note-wire "
                "registry: emit through fleet/notes.py's "
                "member_note/producers",
            )
            if f:
                findings.append(f)

        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.JoinedStr):
                parts = node.values
                for i, part in enumerate(parts[:-1]):
                    if not (
                        isinstance(part, ast.Constant)
                        and isinstance(part.value, str)
                    ):
                        continue
                    if not isinstance(
                        parts[i + 1], ast.FormattedValue
                    ):
                        continue
                    for marker in markers:
                        if part.value.endswith(marker):
                            emit(node, marker[:-1], "f-string")
                            break
            elif isinstance(node, ast.BinOp) and isinstance(
                node.op, ast.Add
            ):
                for side in (node.left, node.right):
                    if (
                        isinstance(side, ast.Constant)
                        and isinstance(side.value, str)
                        and side.value.strip() in markers
                    ):
                        emit(
                            node, side.value.strip()[:-1],
                            "concatenation",
                        )
        return findings

    def _check_consumption(
        self, ctx: ModuleContext, names: Set[str]
    ) -> List[Finding]:
        findings: List[Finding] = []

        def emit(node: ast.AST, fname: str) -> None:
            f = self.finding_at(
                ctx, node.lineno, ctx.scope_of(node),
                f"field `{fname}` parsed from a heartbeat note but "
                "not registered in fleet/notes.py: nothing produces "
                "it",
            )
            if f:
                findings.append(f)

        def scan_scope(body: Sequence[ast.AST]) -> None:
            split_vars: Set[str] = set()
            nodes = list(_body_nodes(body, skip_defs=True))
            for node in nodes:
                if isinstance(node, ast.Assign) and isinstance(
                    node.value, ast.Call
                ):
                    tail = dotted_name(
                        node.value.func
                    ).rpartition(".")[2]
                    if tail in self.SPLIT_TAILS:
                        for target in node.targets:
                            if isinstance(target, ast.Name):
                                split_vars.add(target.id)
            for node in nodes:
                fname = _literal_field_use(node, split_vars)
                if fname is not None and fname not in names:
                    emit(node, fname)

        scan_scope(ctx.tree.body)
        for node in ast.walk(ctx.tree):
            if isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef)
            ):
                scan_scope(node.body)
        return findings


def _non_none(node: Optional[ast.AST]) -> bool:
    return node is not None and not (
        isinstance(node, ast.Constant) and node.value is None
    )


def _literal_field_use(
    node: ast.AST, split_vars: Set[str]
) -> Optional[str]:
    """The literal field name this node consumes from a split-note
    dict (subscript, .get, membership) or passes to parse_field."""
    if isinstance(node, ast.Subscript) and isinstance(
        node.value, ast.Name
    ) and node.value.id in split_vars and isinstance(
        node.slice, ast.Constant
    ) and isinstance(node.slice.value, str):
        return node.slice.value
    if isinstance(node, ast.Call):
        name = dotted_name(node.func)
        tail = name.rpartition(".")[2]
        if (
            tail == "get"
            and isinstance(node.func, ast.Attribute)
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id in split_vars
            and node.args
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)
        ):
            return node.args[0].value
        if (
            tail == "parse_field"
            and node.args
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)
        ):
            return node.args[0].value
    if isinstance(node, ast.Compare) and len(node.ops) == 1 and (
        isinstance(node.ops[0], (ast.In, ast.NotIn))
    ):
        left, right = node.left, node.comparators[0]
        if (
            isinstance(left, ast.Constant)
            and isinstance(left.value, str)
            and isinstance(right, ast.Name)
            and right.id in split_vars
        ):
            return left.value
    return None


PROJECT_RULES: Tuple[ProjectRule, ...] = (
    AsyncReachRule(),
    HotReachRule(),
    LockOrderRule(),
    NoteWireRule(),
)

PROJECT_RULES_BY_ID: Dict[str, ProjectRule] = {
    r.rule_id: r for r in PROJECT_RULES
}


def run_project_rules(
    project: ProjectContext,
    rules: Sequence[ProjectRule] = PROJECT_RULES,
) -> List[Finding]:
    findings: List[Finding] = []
    for rule in rules:
        findings.extend(rule.run_project(project))
    findings.sort(key=lambda f: (f.file, f.line, f.rule))
    return findings
