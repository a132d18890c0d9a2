"""cpcheck: repo-specific AST invariant analysis, the port's copy.

The port's counterpart of ``containerpilot_tpu/analysis/cpcheck.py``:
the same rules, rule ids, messages and pragma syntax, so the same
source text gives the same findings under either package's analyzer.
It imports the stdlib only (no torch: a lint must not need a card).
The rule vocabularies carry the JAX names and the torch names side by
side: ``torch.cuda.synchronize`` and the ``.cpu()`` / ``.tolist()`` /
``.numpy()`` / ``.synchronize()`` tails are host syncs (CP-HOTSYNC),
``torch.cuda.synchronize`` / ``.synchronize()`` block the event loop
(CP-ASYNCBLOCK), and a ``torch.compile`` binding specializes on Python
values the way a ``jax.jit`` one does (CP-RETRACE).

The Go supervisor keeps its concurrency honest with ``go vet`` and the
race detector; this package gets the same discipline from a
stdlib-``ast`` analyzer whose rules encode these invariants:

- **CP-HOTSYNC** — no host synchronization (``block_until_ready``,
  ``.item()``, ``.cpu()``, ``np.asarray``, ``jax.device_get``,
  ``torch.cuda.synchronize``, ``time.sleep``, blocking I/O) inside
  decode-round hot paths. Hot paths are marked
  with a ``# cpcheck: hotpath`` pragma or an ``@hotpath`` decorator;
  the ONE deliberate per-round token fetch carries an inline
  ``# cpcheck: disable=CP-HOTSYNC`` so it is explicit and auditable.
- **CP-DONATE** — a buffer donated to a jitted call must not be read
  again after the call unless the call's own assignment rebinds it
  (donation deletes the operand; a later read dies on a deleted
  array, or silently reads garbage on backends that alias).
- **CP-LOCKPUB** — no ``bus.publish(...)`` / subscriber ``.receive``
  fan-out lexically inside a ``with <lock>:`` block (ContainerPilot's
  classic deadlock: a subscriber that takes the same lock wedges the
  bus).
- **CP-SWALLOW** — no ``except``/``except Exception`` with a bare
  ``pass`` body: a supervisor thread that swallows its own death
  keeps ``/health`` green while doing nothing.
- **CP-THREAD** — every ``threading.Thread(...)`` must pass
  ``daemon=`` explicitly, forcing a decision about how the thread
  meets process shutdown.
- **CP-TOPIC** — event codes come from the ``events.events`` registry
  (``EventCode.X`` / the well-known ``GLOBAL_*`` constants), never
  inline string literals.

A second concurrency regime — the asyncio event loop under the
gateway, admission, autoscaler, mux transport, and every replica HTTP
surface — is kept honest by these rules the same way the
thread-and-device rules above keep the first:

- **CP-ASYNCBLOCK** — no blocking call (``time.sleep``, sync
  socket/file I/O, ``subprocess.run``, ``future.result()`` /
  ``thread.join()``, ``jax.device_get``/``device_put``/
  ``block_until_ready``, ``torch.cuda.synchronize``) lexically
  inside an ``async def`` body: one blocking call on the gateway loop stalls every multiplexed
  stream on the box. Wrapping the work in ``run_in_executor`` /
  ``asyncio.to_thread`` heals it.
- **CP-TASKLEAK** — ``asyncio.create_task(...)`` /
  ``ensure_future(...)`` whose return value is discarded: an
  unreferenced task is garbage-collectable mid-flight and its
  exception vanishes with it. Storing the task, awaiting it, or
  chaining a done-callback heals it (``utils/tasks.spawn`` does all
  three).
- **CP-AWAITHOLD** — ``await`` lexically inside a held
  ``threading.Lock``/``RLock`` ``with``-block: the task parks with
  the lock held, and any other task (or executor thread) that wants
  it wedges the whole loop. ``asyncio.Lock`` (``async with``) is
  exempt — that is the primitive to use here.
- **CP-RETRACE** — a locally-jitted callable invoked in a
  ``# cpcheck: hotpath`` region with arguments derived from
  Python-varying values (``len(...)``, f-strings, dynamic
  subscripts): every distinct value is a silent recompile, and a
  recompile storm is a stall no profiler names.

The runtime analog of these rules is ``analysis/loopcheck.py`` (an
event-loop lag probe + leaked-task watchdog), the way ``racecheck.py``
is the runtime analog of CP-LOCKPUB.

Each rule is a small visitor class with a ``rule_id`` and a docstring;
``scan_source``/``scan_file``/``scan_package`` drive them and return
``Finding`` records. Findings are fingerprinted by (rule, file, scope,
source-line text) — stable across unrelated edits — and compared
against ``analysis/baseline.json`` so pre-existing debt is enumerated
while anything NEW fails ``make lint-torch`` and the tier-1 gate.

Escape hatches (use sparingly, with a justification comment):

    # cpcheck: hotpath                    -> marks the next/same-line def hot
    # cpcheck: disable=CP-XXXX[,CP-YYYY]  -> suppress on this line
    # cpcheck: disable                    -> suppress every rule on this line
"""
from __future__ import annotations

import ast
import json
import os
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

PRAGMA = "cpcheck:"
DISABLE_ALL = "*"
_RULE_ID_RE = re.compile(r"^CP-[A-Z0-9]+$", re.IGNORECASE)


def hotpath(fn):
    """No-op marker decorator: ``@hotpath`` puts the function under
    CP-HOTSYNC's scrutiny, same as a ``# cpcheck: hotpath`` pragma
    (the rule matches the decorator NAME, so any import path works)."""
    return fn

# -- pragma + source bookkeeping -------------------------------------------


@dataclass(frozen=True)
class Finding:
    """One rule violation at one source location."""

    rule: str
    file: str
    line: int
    scope: str
    text: str
    message: str

    @property
    def key(self) -> Tuple[str, str, str, str]:
        """Baseline fingerprint: line numbers drift, these rarely do."""
        return (self.rule, self.file, self.scope, self.text)

    def render(self) -> str:
        return (
            f"{self.file}:{self.line}: {self.rule} [{self.scope}] "
            f"{self.message}\n    {self.text}"
        )


class _Pragmas:
    """Per-file pragma index: hotpath markers and line suppressions."""

    def __init__(self, source: str) -> None:
        self.hotpath_lines: Set[int] = set()
        self.disabled: Dict[int, Set[str]] = {}
        for lineno, line in enumerate(source.splitlines(), start=1):
            hash_idx = line.find("#")
            if hash_idx < 0:
                continue
            idx = line.find(PRAGMA, hash_idx)
            if idx < 0:
                continue
            body = line[idx + len(PRAGMA):].strip()
            directive, _, arg = body.partition("=")
            # trailing free text after the directive is a justification
            directive = directive.strip().lower().split()[0] if directive.strip() else ""
            if directive == "hotpath":
                self.hotpath_lines.add(lineno)
            elif directive == "disable":
                # `disable=CP-X,CP-Y free-text justification` — each
                # comma part's first word is a rule id; collection
                # stops at the first token NOT shaped like one, so a
                # comma inside the prose justification cannot
                # silently widen the suppression
                rules = set()
                for part in arg.split(","):
                    words = part.split()
                    if not words or not _RULE_ID_RE.match(words[0]):
                        break
                    rules.add(words[0].upper())
                self.disabled.setdefault(lineno, set()).update(
                    rules or {DISABLE_ALL}
                )

    def is_disabled(self, rule: str, line: int) -> bool:
        rules = self.disabled.get(line)
        if not rules:
            return False
        return DISABLE_ALL in rules or rule in rules


@dataclass
class ModuleContext:
    """Everything a rule needs to scan one module."""

    path: str
    tree: ast.Module
    lines: List[str]
    pragmas: _Pragmas
    scopes: Dict[ast.AST, str] = field(default_factory=dict)

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    def scope_of(self, node: ast.AST) -> str:
        return self.scopes.get(node, "<module>")


def _index_scopes(ctx: ModuleContext) -> None:
    """Annotate every node with its enclosing function qualname."""

    def walk(node: ast.AST, scope: str) -> None:
        for child in ast.iter_child_nodes(node):
            child_scope = scope
            if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
            ):
                child_scope = (
                    f"{scope}.{child.name}"
                    if scope != "<module>"
                    else child.name
                )
            ctx.scopes[child] = child_scope
            walk(child, child_scope)

    ctx.scopes[ctx.tree] = "<module>"
    walk(ctx.tree, "<module>")


def dotted_name(node: ast.AST) -> str:
    """'np.asarray' for Attribute chains, 'open' for Names, '' else.

    Subscripted/called bases collapse to their tail attribute, so
    ``self._bufs[i].block_until_ready()`` still ends with the method
    name the rules match on.
    """
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    elif parts:
        parts.append("")  # call/subscript base: keep the attr tail
    return ".".join(reversed(parts)).lstrip(".")


def _expr_path(node: ast.AST) -> Optional[str]:
    """A stable string for Name / self.attr chains, else None."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _expr_path(node.value)
        return f"{base}.{node.attr}" if base else None
    return None


def _body_nodes(nodes: Iterable[ast.AST], *, skip_defs: bool) -> Iterable[ast.AST]:
    """Walk statements recursively, optionally not descending into
    nested function/class definitions (whose bodies run later, not
    lexically here)."""
    stack = list(nodes)
    while stack:
        node = stack.pop()
        yield node
        if skip_defs and isinstance(
            node,
            (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef, ast.Lambda),
        ):
            continue  # its body runs later, not lexically here
        stack.extend(ast.iter_child_nodes(node))


# -- rule framework --------------------------------------------------------


class Rule:
    """Base class: subclasses set ``rule_id`` and implement ``run``."""

    rule_id = "CP-NONE"

    def run(self, ctx: ModuleContext) -> List[Finding]:  # pragma: no cover
        raise NotImplementedError

    def finding(
        self, ctx: ModuleContext, node: ast.AST, message: str
    ) -> Optional[Finding]:
        lineno = getattr(node, "lineno", 1)
        if ctx.pragmas.is_disabled(self.rule_id, lineno):
            return None
        return Finding(
            rule=self.rule_id,
            file=ctx.path,
            line=lineno,
            scope=ctx.scope_of(node),
            text=ctx.line_text(lineno),
            message=message,
        )


def _is_hotpath(
    fn: ast.AST, ctx: ModuleContext
) -> bool:
    """Hot iff decorated @hotpath (any dotted tail) or carrying a
    ``# cpcheck: hotpath`` pragma on the def line, a decorator line,
    or the contiguous comment block directly above the def."""
    for dec in getattr(fn, "decorator_list", []):
        target = dec.func if isinstance(dec, ast.Call) else dec
        name = dotted_name(target)
        if name.rpartition(".")[2] == "hotpath":
            return True
    first = min(
        [fn.lineno]
        + [d.lineno for d in getattr(fn, "decorator_list", [])]
    )
    # def/decorator lines up to (excluding) the first body statement
    candidates = set(range(first, getattr(fn, "body")[0].lineno))
    if candidates & ctx.pragmas.hotpath_lines:
        return True
    # the comment block immediately above the def
    lineno = first - 1
    while lineno >= 1 and ctx.line_text(lineno).startswith("#"):
        if lineno in ctx.pragmas.hotpath_lines:
            return True
        lineno -= 1
    return False


class HotSyncRule(Rule):
    """CP-HOTSYNC: host synchronization inside a decode-round hot path.

    Flags, inside functions marked hot: ``*.block_until_ready``,
    ``*.item()``, ``*.cpu()``, ``*.tolist()``, ``*.numpy()``,
    ``*.synchronize()`` (a CUDA event's or stream's),
    ``np.asarray``/``np.array``/``numpy.asarray``,
    ``jax.device_get``, ``torch.cuda.synchronize``, ``time.sleep``,
    ``print``, ``open`` and ``input``. A steady decode round should
    ship zero host->device transfers and exactly one token fetch; that
    fetch carries an inline disable pragma so every sync point in a
    hot path is visible in review.
    """

    rule_id = "CP-HOTSYNC"

    BLOCKED_NAMES = {
        "np.asarray", "np.array", "numpy.asarray", "numpy.array",
        "jax.device_get", "device_get", "time.sleep",
        "print", "open", "input",
        "torch.cuda.synchronize",
    }
    BLOCKED_ATTRS = {
        "block_until_ready", "item",
        "cpu", "tolist", "numpy", "synchronize",
    }

    def run(self, ctx: ModuleContext) -> List[Finding]:
        findings: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef)
            ):
                continue
            if not _is_hotpath(node, ctx):
                continue
            for sub in _body_nodes(node.body, skip_defs=False):
                if not isinstance(sub, ast.Call):
                    continue
                name = dotted_name(sub.func)
                tail = name.rpartition(".")[2]
                hit = (
                    name in self.BLOCKED_NAMES
                    or tail in self.BLOCKED_ATTRS
                )
                if hit:
                    f = self.finding(
                        ctx, sub,
                        f"host sync `{name or tail}` in hot path "
                        "(mark the one deliberate fetch with "
                        "`# cpcheck: disable=CP-HOTSYNC`)",
                    )
                    if f:
                        findings.append(f)
        return findings


class DonateRule(Rule):
    """CP-DONATE: reading a buffer after donating it to a jitted call.

    Donation sources: local ``x = jax.jit(f, donate_argnums=...)``
    bindings discovered in the module, plus this repo's known donating
    entry points (models/slots.py): ``insert_row``,
    ``admit_slot_state`` and ``retire_slot`` donate argument 0,
    ``decode_slots_chunk`` and ``decode_slots_window`` donate
    arguments 1 and 2. A donated operand is cleared by being a
    target of the same call's assignment (``state = step(state, x)``);
    any later *read* of a still-donated name in the same function body
    is flagged, any later rebind heals it.

    The logic and ``KNOWN_DONATORS`` are the reference's, kept for
    parity: the same source gives the same findings in both packages.
    In the port, ``admit_slot_state`` / ``retire_slot`` / ``insert_row``
    (``models/slots.py``) write the slot state in place and return the
    same dict, so a read after such a call reads an alias of the
    updated state, not a deleted buffer; the rule still asks for the
    rebind, which keeps the code's shape the reference's.
    """

    rule_id = "CP-DONATE"

    KNOWN_DONATORS: Dict[str, Tuple[int, ...]] = {
        "insert_row": (0,),
        "admit_slot_state": (0,),
        "retire_slot": (0,),
        "decode_slots_chunk": (1, 2),
        "decode_slots_window": (1, 2),
    }

    JIT_NAMES = {"jax.jit", "jit", "pjit", "jax.pjit"}

    def _module_donators(self, ctx: ModuleContext) -> Dict[str, Tuple[int, ...]]:
        """{name: donated positions} for `g = jax.jit(f, donate_argnums=..)`."""
        donators = dict(self.KNOWN_DONATORS)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Assign):
                continue
            call = node.value
            if not isinstance(call, ast.Call):
                continue
            if dotted_name(call.func) not in self.JIT_NAMES:
                continue
            positions: Tuple[int, ...] = ()
            for kw in call.keywords:
                if kw.arg != "donate_argnums":
                    continue
                try:
                    value = ast.literal_eval(kw.value)
                except ValueError:
                    continue
                if isinstance(value, int):
                    positions = (value,)
                elif isinstance(value, (tuple, list)):
                    positions = tuple(
                        v for v in value if isinstance(v, int)
                    )
            if not positions:
                continue
            for target in node.targets:
                if isinstance(target, ast.Name):
                    donators[target.id] = positions
        return donators

    @staticmethod
    def _assign_targets(stmt: ast.AST) -> Set[str]:
        targets: Set[str] = set()
        if isinstance(stmt, ast.Assign):
            nodes: List[ast.AST] = list(stmt.targets)
        elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
            nodes = [stmt.target]
        else:
            return targets
        while nodes:
            t = nodes.pop()
            if isinstance(t, (ast.Tuple, ast.List)):
                nodes.extend(t.elts)
                continue
            path = _expr_path(t)
            if path:
                targets.add(path)
        return targets

    def run(self, ctx: ModuleContext) -> List[Finding]:
        donators = self._module_donators(ctx)
        findings: List[Finding] = []
        for fn in ast.walk(ctx.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            findings.extend(self._scan_function(ctx, fn, donators))
        return findings

    @staticmethod
    def _diverges(b1, b2) -> bool:
        """True iff the two branch paths take DIFFERENT arms of the
        same ``if`` — i.e. the code locations are mutually exclusive."""
        for (id1, arm1), (id2, arm2) in zip(b1, b2):
            if id1 != id2:
                return False  # different nesting, not exclusive
            if arm1 != arm2:
                return True
        return False

    def _scan_function(
        self,
        ctx: ModuleContext,
        fn: ast.AST,
        donators: Dict[str, Tuple[int, ...]],
    ) -> List[Finding]:
        # Event positions model execution at line resolution: a
        # donating call taints at its END line (its own argument
        # loads happen before the donation), the enclosing
        # assignment's store heals after the call returns, and a load
        # is flagged only strictly after the donation completed.
        # Sort priority breaks same-position ties: load < donate < store.
        # Every event carries its if/else branch path, so a donation
        # in one arm never taints a read in the sibling arm, and a
        # heal in an arm divergent from the read never absolves it.
        PRIO = {"load": 0, "donate": 1, "store": 2}
        events: List[Tuple[int, int, str, ast.AST, object, tuple]] = []

        def classify(node: ast.AST, branch: tuple) -> None:
            if isinstance(node, ast.Call):
                name = dotted_name(node.func)
                tail = name.rpartition(".")[2]
                positions = donators.get(name) or donators.get(tail)
                if positions:
                    pos = getattr(node, "end_lineno", node.lineno)
                    events.append(
                        (pos, PRIO["donate"], "donate", node, positions,
                         branch)
                    )
            elif isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                pos = getattr(node, "end_lineno", node.lineno)
                for path in self._assign_targets(node):
                    events.append(
                        (pos, PRIO["store"], "store", node, path, branch)
                    )
            elif isinstance(node, (ast.Name, ast.Attribute)) and isinstance(
                getattr(node, "ctx", None), ast.Load
            ):
                path = _expr_path(node)
                if path:
                    events.append(
                        (node.lineno, PRIO["load"], "load", node, path,
                         branch)
                    )

        def collect(node: ast.AST, branch: tuple) -> None:
            if isinstance(
                node,
                (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef,
                 ast.Lambda),
            ):
                return  # runs later, not lexically here
            if isinstance(node, ast.If):
                collect(node.test, branch)
                for child in node.body:
                    collect(child, branch + ((id(node), 0),))
                for child in node.orelse:
                    collect(child, branch + ((id(node), 1),))
                return
            classify(node, branch)
            for child in ast.iter_child_nodes(node):
                collect(child, branch)

        for stmt in fn.body:
            collect(stmt, ())
        events.sort(key=lambda e: (e[0], e[1]))

        findings: List[Finding] = []
        donations: Dict[str, List[Tuple[int, tuple]]] = {}
        stores: Dict[str, List[Tuple[int, tuple]]] = {}
        for position, _prio, kind, node, payload, branch in events:
            if kind == "store":
                stores.setdefault(payload, []).append((position, branch))
            elif kind == "donate":
                call: ast.Call = node
                for arg_pos in payload:
                    if arg_pos < len(call.args):
                        path = _expr_path(call.args[arg_pos])
                        if path:
                            donations.setdefault(path, []).append(
                                (position, branch)
                            )
            else:  # load
                live = donations.get(payload)
                if not live:
                    continue
                for i, (d_pos, d_branch) in enumerate(live):
                    if position <= d_pos:
                        continue
                    if self._diverges(d_branch, branch):
                        continue  # sibling arm: can't both execute
                    healed = any(
                        d_pos <= s_pos <= position
                        and not self._diverges(s_branch, branch)
                        for s_pos, s_branch in stores.get(payload, [])
                    )
                    if healed:
                        continue
                    f = self.finding(
                        ctx, node,
                        f"`{payload}` read after being donated at "
                        f"line {d_pos}",
                    )
                    if f:
                        findings.append(f)
                    del live[i]  # one report per donation
                    break
        return findings


class LockPubRule(Rule):
    """CP-LOCKPUB: event fan-out lexically inside a held lock.

    Inside any ``with`` block whose context manager expression names a
    lock (its dotted path contains "lock" or "mutex", or it is an
    ``acquire()`` call), flags calls to ``*.publish`` and subscriber
    ``*.receive``. Fan-out is synchronous here: a subscriber that
    takes the same lock deadlocks the publisher — ContainerPilot's
    classic bus deadlock shape (reference: events/bus.go,
    jobs/jobs.go:23). Nested ``def`` bodies are skipped (they run
    later, not under the lock).
    """

    rule_id = "CP-LOCKPUB"

    FANOUT_TAILS = {"publish", "receive"}

    @staticmethod
    def _is_lockish(expr: ast.AST) -> bool:
        if isinstance(expr, ast.Call):
            name = dotted_name(expr.func)
            if name.rpartition(".")[2] == "acquire":
                return True
            expr_name = name
        else:
            expr_name = dotted_name(expr) or ""
        lowered = expr_name.lower()
        return "lock" in lowered or "mutex" in lowered

    def run(self, ctx: ModuleContext) -> List[Finding]:
        findings: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, (ast.With, ast.AsyncWith)):
                continue
            if not any(
                self._is_lockish(item.context_expr) for item in node.items
            ):
                continue
            for sub in _body_nodes(node.body, skip_defs=True):
                if not isinstance(sub, ast.Call):
                    continue
                tail = dotted_name(sub.func).rpartition(".")[2]
                if tail in self.FANOUT_TAILS:
                    f = self.finding(
                        ctx, sub,
                        f"`{dotted_name(sub.func)}` fan-out while "
                        "holding a lock: snapshot under the lock, "
                        "deliver outside it",
                    )
                    if f:
                        findings.append(f)
        return findings


class SwallowRule(Rule):
    """CP-SWALLOW: a broad except whose entire body is ``pass``.

    ``except:``, ``except Exception:``, ``except BaseException:`` (or
    a tuple containing either) with a bare ``pass`` body silently eats
    the failure that should have crashed or logged — the supervisor
    keeps reporting healthy while a worker thread is already dead.
    Narrow exception types (``except ValueError: pass``) are allowed:
    they encode an explicit, bounded decision.
    """

    rule_id = "CP-SWALLOW"

    BROAD = {"Exception", "BaseException"}

    def _is_broad(self, handler: ast.ExceptHandler) -> bool:
        t = handler.type
        if t is None:
            return True
        names: List[ast.AST] = (
            list(t.elts) if isinstance(t, ast.Tuple) else [t]
        )
        return any(
            dotted_name(n).rpartition(".")[2] in self.BROAD for n in names
        )

    def run(self, ctx: ModuleContext) -> List[Finding]:
        findings: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if not self._is_broad(node):
                continue
            if len(node.body) == 1 and isinstance(node.body[0], ast.Pass):
                f = self.finding(
                    ctx, node,
                    "broad except swallows the error: log it, narrow "
                    "the type, or re-raise",
                )
                if f:
                    findings.append(f)
        return findings


class ThreadRule(Rule):
    """CP-THREAD: ``threading.Thread(...)`` without an explicit
    ``daemon=``.

    A thread that defaults to non-daemon silently blocks interpreter
    exit; one that should be joined on shutdown needs an owner. The
    rule forces the decision to be written down: pass ``daemon=True``
    for fire-and-forget monitors, ``daemon=False`` (and join it in the
    shutdown path) for workers holding state.
    """

    rule_id = "CP-THREAD"

    THREAD_NAMES = {"threading.Thread", "Thread"}

    def run(self, ctx: ModuleContext) -> List[Finding]:
        findings: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            if dotted_name(node.func) not in self.THREAD_NAMES:
                continue
            if any(kw.arg == "daemon" for kw in node.keywords):
                continue
            f = self.finding(
                ctx, node,
                "Thread without explicit daemon=: decide (and write "
                "down) how this thread meets shutdown",
            )
            if f:
                findings.append(f)
        return findings


class TopicRule(Rule):
    """CP-TOPIC: event codes must come from the events registry.

    ``Event("exitSuccess", ...)`` (a string literal where an
    ``EventCode`` belongs) bypasses the registry in
    ``events/events.py`` — a typo'd code silently never matches any
    subscriber's dispatch. Construct events with ``EventCode.X`` or
    the well-known ``GLOBAL_*`` constants; parse config strings
    through ``code_from_string`` (the registry accessor), never
    inline.
    """

    rule_id = "CP-TOPIC"

    EVENT_NAMES = {"Event", "events.Event"}

    def run(self, ctx: ModuleContext) -> List[Finding]:
        findings: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            if dotted_name(node.func) not in self.EVENT_NAMES:
                continue
            code_arg: Optional[ast.AST] = None
            if node.args:
                code_arg = node.args[0]
            for kw in node.keywords:
                if kw.arg == "code":
                    code_arg = kw.value
            if isinstance(code_arg, ast.Constant) and isinstance(
                code_arg.value, str
            ):
                f = self.finding(
                    ctx, node,
                    f"inline event code {code_arg.value!r}: use "
                    "EventCode.* from the events registry",
                )
                if f:
                    findings.append(f)
        return findings


class AsyncBlockRule(Rule):
    """CP-ASYNCBLOCK: a blocking call lexically inside an ``async
    def`` body.

    The event loop is cooperative: one ``time.sleep``, sync
    socket/file I/O, ``subprocess.run``, ``future.result()`` /
    ``thread.join()``, or host-synchronizing device transfer
    (``device_get``/``device_put``/``block_until_ready``,
    ``torch.cuda.synchronize`` or an event's ``.synchronize()``) on
    the gateway loop stalls every co-resident request, stream, heartbeat
    and poll on the box — the exact failure the supervisor exists to
    prevent. Nested ``def``/``lambda`` bodies are skipped (they run
    later, usually on an executor thread), and a call lexically
    wrapped in ``loop.run_in_executor(...)`` / ``asyncio.to_thread(...)``
    arguments is healed: that is the sanctioned escape, and the fix
    this rule is pushing toward.

    ``.result()``/``.join()`` are matched by dataflow, not name alone
    (``"".join(...)`` and an awaited asyncio future are innocent):
    only receivers bound from ``executor.submit(...)`` /
    ``threading.Thread(...)`` in the same function — or chained
    directly off them — are flagged.
    """

    rule_id = "CP-ASYNCBLOCK"

    BLOCKED_NAMES = {
        "time.sleep",
        "subprocess.run", "subprocess.call", "subprocess.check_call",
        "subprocess.check_output", "subprocess.getoutput",
        "os.system", "os.waitpid",
        "socket.create_connection", "urllib.request.urlopen",
        "open", "input",
        "jax.device_get", "jax.device_put", "jax.block_until_ready",
        "torch.cuda.synchronize",
    }
    BLOCKED_TAILS = {
        "block_until_ready", "device_get", "device_put", "synchronize",
    }
    #: calls whose argument subtrees are the sanctioned escape hatch
    EXECUTOR_TAILS = {"run_in_executor", "to_thread"}
    #: receivers born from these tails make .result()/.join() blocking
    FUTURE_SOURCES = {"submit"}
    THREAD_SOURCES = {"Thread"}

    def _scan_async_fn(
        self, ctx: ModuleContext, fn: ast.AsyncFunctionDef
    ) -> List[Finding]:
        findings: List[Finding] = []
        # names bound from executor.submit(...) / threading.Thread(...)
        future_names: Set[str] = set()
        thread_names: Set[str] = set()

        def source_kind(call: ast.Call) -> Optional[str]:
            tail = dotted_name(call.func).rpartition(".")[2]
            if tail in self.FUTURE_SOURCES:
                return "future"
            if tail in self.THREAD_SOURCES:
                return "thread"
            return None

        for node in _body_nodes(fn.body, skip_defs=True):
            if isinstance(node, ast.Assign) and isinstance(
                node.value, ast.Call
            ):
                kind = source_kind(node.value)
                if kind:
                    for target in node.targets:
                        path = _expr_path(target)
                        if path:
                            (future_names if kind == "future"
                             else thread_names).add(path)

        def visit(node: ast.AST) -> None:
            if isinstance(
                node,
                (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef,
                 ast.Lambda),
            ):
                return  # runs later, not on this loop iteration
            if isinstance(node, ast.Call):
                name = dotted_name(node.func)
                tail = name.rpartition(".")[2]
                if tail in self.EXECUTOR_TAILS:
                    # run_in_executor/to_thread arguments are the
                    # escape hatch; don't descend into them
                    visit(node.func)
                    return
                hit = (
                    name in self.BLOCKED_NAMES
                    or tail in self.BLOCKED_TAILS
                )
                why = f"blocking `{name or tail}`"
                if not hit and tail in ("result", "join"):
                    recv = node.func.value if isinstance(
                        node.func, ast.Attribute
                    ) else None
                    recv_path = _expr_path(recv) if recv is not None else None
                    if recv_path in future_names or (
                        isinstance(recv, ast.Call)
                        and source_kind(recv) == "future"
                    ):
                        hit, why = True, f"`{recv_path or '...'}.result()` blocks on a concurrent future"
                    elif recv_path in thread_names or (
                        isinstance(recv, ast.Call)
                        and source_kind(recv) == "thread"
                    ):
                        hit, why = True, f"`{recv_path or '...'}.join()` blocks on a thread"
                if hit:
                    f = self.finding(
                        ctx, node,
                        f"{why} in async def `{fn.name}` stalls the "
                        "event loop: move it to run_in_executor / "
                        "asyncio.to_thread",
                    )
                    if f:
                        findings.append(f)
            for child in ast.iter_child_nodes(node):
                visit(child)

        for stmt in fn.body:
            visit(stmt)
        return findings

    def run(self, ctx: ModuleContext) -> List[Finding]:
        findings: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.AsyncFunctionDef):
                findings.extend(self._scan_async_fn(ctx, node))
        return findings


class TaskLeakRule(Rule):
    """CP-TASKLEAK: ``asyncio.create_task(...)`` (or
    ``ensure_future``) whose return value is discarded.

    The event loop holds only a weak reference to running tasks: a
    task nobody stores can be garbage-collected mid-flight, and an
    exception it raises is silently dropped on the floor — the
    asyncio face of CP-SWALLOW, with the added insult that the
    watchdog/relay the task implemented just stops existing. Storing
    the task (``self._task = ...``, a pending set), awaiting it, or
    chaining ``.add_done_callback(...)`` heals the finding;
    ``utils/tasks.spawn`` packages the full discipline (reference +
    logging done-callback) in one call.
    """

    rule_id = "CP-TASKLEAK"

    SPAWN_TAILS = {"create_task", "ensure_future"}

    def run(self, ctx: ModuleContext) -> List[Finding]:
        findings: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Expr):
                continue
            call = node.value
            if not isinstance(call, ast.Call):
                continue
            name = dotted_name(call.func)
            if name.rpartition(".")[2] not in self.SPAWN_TAILS:
                continue
            f = self.finding(
                ctx, call,
                f"`{name}` result discarded: an unreferenced task is "
                "GC-cancellable and swallows its exception — store "
                "it (utils/tasks.spawn), await it, or chain "
                "add_done_callback",
            )
            if f:
                findings.append(f)
        return findings


class AwaitHoldRule(Rule):
    """CP-AWAITHOLD: ``await`` lexically inside a held
    ``threading.Lock``/``RLock`` ``with``-block.

    A coroutine that awaits while holding a *thread* lock parks with
    the lock held. Any other task that wants the lock then blocks the
    whole event loop when it tries to acquire (thread locks don't
    yield), and an executor thread contending for it can deadlock
    against the loop outright — a loop-wide stall with no stack trace
    pointing at the cause. ``async for`` and ``async with`` suspend
    the same way (at ``__anext__``/``__aenter__``) and are flagged
    too. ``asyncio.Lock`` is exempt by shape: the *outer* lock being
    held must be a sync ``with`` (an ``AsyncWith`` there is exactly
    the primitive to use around awaits). Nested ``def`` bodies are
    skipped (they run later, not under the lock).
    """

    rule_id = "CP-AWAITHOLD"

    #: nodes that suspend the coroutine: an explicit await, or the
    #: implicit ones inside `async for` / `async with`
    SUSPENDS = (ast.Await, ast.AsyncFor, ast.AsyncWith)

    def run(self, ctx: ModuleContext) -> List[Finding]:
        findings: List[Finding] = []
        for node in ast.walk(ctx.tree):
            # sync `with` only: `async with asyncio.Lock()` is the fix
            if not isinstance(node, ast.With):
                continue
            if not any(
                LockPubRule._is_lockish(item.context_expr)
                for item in node.items
            ):
                continue
            for sub in _body_nodes(node.body, skip_defs=True):
                if isinstance(sub, self.SUSPENDS):
                    f = self.finding(
                        ctx, sub,
                        "await while holding a thread lock: the task "
                        "parks mid-critical-section and wedges the "
                        "loop — narrow the lock or use asyncio.Lock",
                    )
                    if f:
                        findings.append(f)
        return findings


class RetraceRule(Rule):
    """CP-RETRACE: a jitted callable invoked in a hot path with
    Python-varying arguments — the static face of a recompile storm.

    ``jax.jit`` specializes on argument shapes and static values, and
    a ``torch.compile`` callable guards on them the same way:
    passing ``len(batch)``, an f-string, or a dict lookup keyed on
    request state means every distinct value silently compiles a new
    executable, billing seconds of compile time to a request that
    expected milliseconds (the exact trap the chaos warmup had to
    pre-compile its way around). Inside ``# cpcheck: hotpath``
    regions, calls to locally-bound ``jax.jit``/``pjit``/
    ``torch.compile`` objects — and direct ``lax.scan``/
    ``lax.while_loop`` calls (the fused decode window's shape) — are
    checked: any argument whose
    expression tree contains ``len(...)``, an f-string
    (``JoinedStr``), or a subscript with a non-constant key is
    flagged. Pad/bucket the value (the warmup's bucket set exists for
    this) or hoist it out of the hot region.
    """

    rule_id = "CP-RETRACE"

    JIT_NAMES = {"jax.jit", "jit", "pjit", "jax.pjit", "torch.compile"}
    # direct structured-control-flow entry points: a lax.scan OR a
    # lax.while_loop step program called with Python-varying operands
    # retraces the same way a jit-bound callable does (the fused
    # decode window is a while_loop — its rounds/chunk/slots must be
    # padded/bucketed, never derived from request state)
    SCAN_NAMES = {
        "lax.scan", "jax.lax.scan",
        "lax.while_loop", "jax.lax.while_loop",
    }
    VARYING_CALLS = {"len"}

    def _jit_bound(self, ctx: ModuleContext) -> Set[str]:
        bound: Set[str] = set()
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Assign):
                continue
            if not isinstance(node.value, ast.Call):
                continue
            if dotted_name(node.value.func) not in self.JIT_NAMES:
                continue
            for target in node.targets:
                path = _expr_path(target)
                if path:
                    bound.add(path)
        return bound

    @staticmethod
    def _static_index(node: ast.AST) -> bool:
        """True when a subscript's index is a compile-time constant:
        ``b[0]``, ``b[-1]``, ``shapes[1, 0]`` — literal_eval folds
        them all; anything it can't fold varies at runtime."""
        try:
            ast.literal_eval(node)
        except (ValueError, TypeError, SyntaxError, MemoryError):
            return False
        return True

    def _varying(self, arg: ast.AST) -> Optional[str]:
        """The first Python-varying subexpression in ``arg``, as a
        human-readable reason, or None when the argument is stable."""
        for node in ast.walk(arg):
            if isinstance(node, ast.Call) and dotted_name(
                node.func
            ) in self.VARYING_CALLS:
                return "len(...)"
            if isinstance(node, ast.JoinedStr):
                return "an f-string"
            if isinstance(node, ast.Subscript) and not self._static_index(
                node.slice
            ):
                return "a dynamic subscript"
        return None

    def run(self, ctx: ModuleContext) -> List[Finding]:
        bound = self._jit_bound(ctx)
        findings: List[Finding] = []
        for fn in ast.walk(ctx.tree):
            if not isinstance(
                fn, (ast.FunctionDef, ast.AsyncFunctionDef)
            ):
                continue
            if not _is_hotpath(fn, ctx):
                continue
            for sub in _body_nodes(fn.body, skip_defs=False):
                if not isinstance(sub, ast.Call):
                    continue
                name = dotted_name(sub.func)
                jitted = (
                    name in bound
                    or name.rpartition(".")[2] in bound
                    or name in self.SCAN_NAMES
                )
                if not jitted:
                    continue
                for arg in list(sub.args) + [
                    kw.value for kw in sub.keywords
                ]:
                    reason = self._varying(arg)
                    if reason is None:
                        continue
                    f = self.finding(
                        ctx, sub,
                        f"jitted `{name}` called with {reason} in a "
                        "hot path: every distinct value is a silent "
                        "recompile — pad/bucket it or hoist it out",
                    )
                    if f:
                        findings.append(f)
                    break  # one report per call site
        return findings


ALL_RULES: Tuple[Rule, ...] = (
    HotSyncRule(),
    DonateRule(),
    LockPubRule(),
    SwallowRule(),
    ThreadRule(),
    TopicRule(),
    AsyncBlockRule(),
    TaskLeakRule(),
    AwaitHoldRule(),
    RetraceRule(),
)

RULES_BY_ID: Dict[str, Rule] = {r.rule_id: r for r in ALL_RULES}


# -- drivers ---------------------------------------------------------------


def _default_project_rules(
    rules: Sequence[Rule], project_rules
) -> Sequence:
    """The interprocedural rules a scan runs: an explicit sequence
    wins; by default they ride along only with the full lexical
    catalog (a caller scanning with a hand-picked rule subset is
    asking for exactly those rules, nothing extra)."""
    if project_rules is not None:
        return project_rules
    if rules is ALL_RULES:
        from .callgraph import PROJECT_RULES

        return PROJECT_RULES
    return ()


def scan_source(
    source: str,
    path: str = "<string>",
    rules: Sequence[Rule] = ALL_RULES,
    project_rules=None,
) -> List[Finding]:
    """Scan one module's source text; returns findings sorted by
    (file, line, rule). Interprocedural rules see a single-module
    project — enough for same-file reachability fixtures."""
    tree = ast.parse(source, filename=path)
    ctx = ModuleContext(
        path=path,
        tree=tree,
        lines=source.splitlines(),
        pragmas=_Pragmas(source),
    )
    _index_scopes(ctx)
    findings: List[Finding] = []
    for rule in rules:
        findings.extend(rule.run(ctx))
    project_rules = _default_project_rules(rules, project_rules)
    if project_rules:
        from .callgraph import ProjectContext, run_project_rules

        findings.extend(
            run_project_rules(ProjectContext([ctx]), project_rules)
        )
    findings.sort(key=lambda f: (f.file, f.line, f.rule))
    return findings


def scan_file(
    path: str,
    relative_to: Optional[str] = None,
    rules: Sequence[Rule] = ALL_RULES,
    project_rules=None,
) -> List[Finding]:
    with open(path, "r", encoding="utf-8") as fh:
        source = fh.read()
    rel = (
        os.path.relpath(path, relative_to) if relative_to else path
    ).replace(os.sep, "/")
    return scan_source(source, rel, rules, project_rules)


def iter_package_files(root: str) -> List[str]:
    out: List[str] = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(
            d for d in dirnames if d != "__pycache__"
        )
        for name in sorted(filenames):
            if name.endswith(".py"):
                out.append(os.path.join(dirpath, name))
    return out


def scan_project(
    project,
    rules: Sequence[Rule] = ALL_RULES,
    project_rules=None,
) -> List[Finding]:
    """Run lexical rules over every module in a prebuilt
    ProjectContext, then the interprocedural rules once over the
    whole forest. The project's parsed ASTs are shared by every rule
    — each file is parsed exactly once per scan."""
    findings: List[Finding] = []
    for ctx in project.contexts:
        for rule in rules:
            findings.extend(rule.run(ctx))
    project_rules = _default_project_rules(rules, project_rules)
    if project_rules:
        from .callgraph import run_project_rules

        findings.extend(run_project_rules(project, project_rules))
    findings.sort(key=lambda f: (f.file, f.line, f.rule))
    return findings


def scan_package(
    root: str,
    relative_to: Optional[str] = None,
    rules: Sequence[Rule] = ALL_RULES,
    project_rules=None,
) -> List[Finding]:
    """Scan every .py under ``root``; paths are reported relative to
    ``relative_to`` (default: root's parent, so
    'containerpilot_tpu_torch/...' for the port's package)."""
    from .callgraph import build_project_from_paths

    base = relative_to or os.path.dirname(os.path.abspath(root))
    project = build_project_from_paths(iter_package_files(root), base)
    return scan_project(project, rules, project_rules)


# -- baseline --------------------------------------------------------------


def baseline_path() -> str:
    return os.path.join(os.path.dirname(__file__), "baseline.json")


def load_baseline(path: Optional[str] = None) -> List[dict]:
    path = path or baseline_path()
    if not os.path.exists(path):
        return []
    with open(path, "r", encoding="utf-8") as fh:
        data = json.load(fh)
    return list(data.get("entries", []))


def write_baseline(
    findings: Sequence[Finding], path: Optional[str] = None
) -> str:
    path = path or baseline_path()
    # regeneration keeps hand-written "reason" annotations for entries
    # that survive
    reasons: Dict[Tuple[str, str, str, str], str] = {}
    for old in load_baseline(path):
        if "reason" in old:
            reasons[_entry_key(old)] = old["reason"]
    entries = []
    for f in findings:
        entry = {
            "rule": f.rule,
            "file": f.file,
            "scope": f.scope,
            "text": f.text,
        }
        reason = reasons.get(f.key)
        if reason:
            entry["reason"] = reason
        entries.append(entry)
    payload = {
        "comment": (
            "cpcheck baseline: pre-existing findings enumerated, not "
            "hidden. Regenerate with `make lint-torch-baseline`; shrink "
            "it, never grow it."
        ),
        "version": 1,
        "entries": entries,
    }
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(payload, fh, indent=2, sort_keys=True)
        fh.write("\n")
    return path


def _entry_key(entry: dict) -> Tuple[str, str, str, str]:
    return (
        entry.get("rule", ""),
        entry.get("file", ""),
        entry.get("scope", ""),
        entry.get("text", ""),
    )


def diff_against_baseline(
    findings: Sequence[Finding], entries: Sequence[dict]
) -> Tuple[List[Finding], List[dict]]:
    """(new findings not in the baseline, stale entries no longer seen).

    Multiset semantics: two identical findings need two baseline
    entries, so a copy-pasted second violation cannot hide behind the
    first one's entry.
    """
    budget: Dict[Tuple[str, str, str, str], int] = {}
    for entry in entries:
        key = _entry_key(entry)
        budget[key] = budget.get(key, 0) + 1
    new: List[Finding] = []
    for f in findings:
        if budget.get(f.key, 0) > 0:
            budget[f.key] -= 1
        else:
            new.append(f)
    stale: List[dict] = []
    for entry in entries:
        key = _entry_key(entry)
        if budget.get(key, 0) > 0:
            budget[key] -= 1
            stale.append(entry)
    return new, stale


def explain_stale(
    new: Sequence[Finding], stale: Sequence[dict]
) -> List[str]:
    """One human-readable line per stale baseline entry, saying WHY
    it went stale. The fingerprint includes line text, so an
    unrelated edit to a baselined line silently drops its
    suppression and the finding resurfaces as 'new' — pair each
    stale entry with any new finding at the same (rule, file, scope)
    so the failure tells the developer what actually happened instead
    of presenting two disconnected lists."""
    out: List[str] = []
    for entry in stale:
        match = next(
            (
                f for f in new
                if f.rule == entry.get("rule")
                and f.file == entry.get("file")
                and f.scope == entry.get("scope")
            ),
            None,
        )
        where = (
            f"{entry.get('file')} [{entry.get('scope')}] "
            f"{entry.get('rule')}"
        )
        if match is not None:
            out.append(
                f"{where}: line text drifted — baseline pinned "
                f"{entry.get('text')!r} but the scan now sees "
                f"{match.text!r} (line {match.line}); an edit to a "
                "baselined line drops its suppression — fix the "
                "finding or re-run `make lint-torch-baseline` after "
                "review"
            )
        else:
            out.append(
                f"{where}: finding no longer present — it was fixed;"
                " run `make lint-torch-baseline` to shrink the ledger"
            )
    return out
