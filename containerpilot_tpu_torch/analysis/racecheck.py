"""racecheck: a runtime lock-order / publish-discipline harness.

The port's counterpart of ``containerpilot_tpu/analysis/racecheck.py``,
pure ``threading``: ``wrap_bus`` instruments the port's
``events.EventBus`` (or any object with a ``publish``).

The Go supervisor leans on ``go test -race`` to keep its bus and job
state machine honest; this is the Python analog for the two hazards a
synchronous fan-out bus actually has:

- **Lock-order inversion.** Thread A takes L1 then L2 while thread B
  takes L2 then L1 — no deadlock *this* run, but the cycle in the
  acquisition-order graph proves one is reachable. The harness hands
  out instrumented locks (``RaceCheck.lock``/``rlock``) that record,
  per thread, every held->acquired edge; ``assert_clean()`` fails on
  any cycle, naming the locks and the threads that witnessed each
  edge.
- **Publish-while-held.** ``EventBus.publish`` fans out to
  subscribers synchronously; publishing while holding an application
  lock hands every subscriber callback that lock's scope
  (ContainerPilot's classic bus deadlock — the shape CP-LOCKPUB
  catches lexically, checked here dynamically through
  ``RaceCheck.wrap_bus``).

Opt-in and test-oriented: nothing in the production path imports this
module. Typical use::

    rc = RaceCheck()
    table_lock = rc.lock("replica-table")
    rc.wrap_bus(bus)
    ... run the scenario ...
    rc.assert_clean()

Violations are recorded, not raised at the faulting site, so a test
exercises its whole scenario and then reports every hazard at once.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Set, Tuple


@dataclass
class Violation:
    """One recorded hazard."""

    kind: str  # "lock-order-cycle" | "publish-while-held"
    detail: str

    def __str__(self) -> str:  # pragma: no cover - trivial
        return f"{self.kind}: {self.detail}"


@dataclass
class _Edge:
    """held -> acquired, with the thread that witnessed it."""

    held: str
    acquired: str
    thread: str


class CheckedLock:
    """A named Lock/RLock recording acquisition order into a harness.

    Supports the context-manager protocol and explicit
    ``acquire``/``release``, like the lock it wraps. Re-entrant
    acquisition of the same RLock adds no edge (it cannot deadlock
    against itself).
    """

    def __init__(
        self, harness: "RaceCheck", name: str, reentrant: bool
    ) -> None:
        self._harness = harness
        self.name = name
        self._inner: Any = (
            threading.RLock() if reentrant else threading.Lock()
        )

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        self._harness._note_acquire(self.name)
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._harness._note_acquired(self.name)
        return got

    def release(self) -> None:
        self._inner.release()
        self._harness._note_released(self.name)

    def __enter__(self) -> "CheckedLock":
        self.acquire()
        return self

    def __exit__(self, *exc: object) -> None:
        self.release()

    def __repr__(self) -> str:  # pragma: no cover - trivial
        return f"CheckedLock({self.name!r})"


class RaceCheck:
    """Collects lock-order edges and publish-discipline violations."""

    def __init__(self) -> None:
        self._state_lock = threading.Lock()
        self._tls = threading.local()
        self._edges: List[_Edge] = []
        self._edge_set: Set[Tuple[str, str]] = set()
        self._violations: List[Violation] = []
        self._wrapped: List[Tuple[Any, Any]] = []  # (bus, orig publish)

    # -- lock factory ---------------------------------------------------

    def lock(self, name: str) -> CheckedLock:
        return CheckedLock(self, name, reentrant=False)

    def rlock(self, name: str) -> CheckedLock:
        return CheckedLock(self, name, reentrant=True)

    # -- per-thread held stack ------------------------------------------

    def _held(self) -> List[str]:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
        return held

    def _note_acquire(self, name: str) -> None:
        """Record edges BEFORE blocking on the lock: the hazard exists
        whether or not this particular acquisition waits."""
        held = self._held()
        thread = threading.current_thread().name
        with self._state_lock:
            for h in held:
                if h == name:  # re-entrant same-lock: no self-edge
                    continue
                if (h, name) not in self._edge_set:
                    self._edge_set.add((h, name))
                    self._edges.append(_Edge(h, name, thread))

    def _note_acquired(self, name: str) -> None:
        self._held().append(name)

    def _note_released(self, name: str) -> None:
        held = self._held()
        # release order may not mirror acquisition; drop the LAST match
        for i in range(len(held) - 1, -1, -1):
            if held[i] == name:
                del held[i]
                break

    # -- bus instrumentation --------------------------------------------

    def wrap_bus(self, bus: Any) -> Any:
        """Instrument ``bus.publish`` to record a violation whenever a
        publish happens while the calling thread holds ANY of this
        harness's locks. Returns the same bus for chaining."""
        orig = bus.publish

        def checked_publish(event: Any, _orig=orig) -> None:
            held = list(self._held())
            if held:
                with self._state_lock:
                    self._violations.append(
                        Violation(
                            "publish-while-held",
                            f"publish({event}) on thread "
                            f"{threading.current_thread().name!r} while "
                            f"holding {held}",
                        )
                    )
            _orig(event)

        bus.publish = checked_publish
        self._wrapped.append((bus, orig))
        return bus

    def unwrap(self) -> None:
        """Restore every wrapped bus's original publish."""
        while self._wrapped:
            bus, orig = self._wrapped.pop()
            bus.publish = orig

    # -- reporting ------------------------------------------------------

    def _find_cycle(self, edges: List[_Edge]) -> Optional[List[str]]:
        graph: Dict[str, List[str]] = {}
        for edge in edges:
            graph.setdefault(edge.held, []).append(edge.acquired)
        WHITE, GRAY, BLACK = 0, 1, 2
        color: Dict[str, int] = {}
        stack_path: List[str] = []

        def visit(node: str) -> Optional[List[str]]:
            color[node] = GRAY
            stack_path.append(node)
            for nxt in graph.get(node, []):
                state = color.get(nxt, WHITE)
                if state == GRAY:
                    return stack_path[stack_path.index(nxt):] + [nxt]
                if state == WHITE:
                    cycle = visit(nxt)
                    if cycle:
                        return cycle
            stack_path.pop()
            color[node] = BLACK
            return None

        for node in list(graph):
            if color.get(node, WHITE) == WHITE:
                cycle = visit(node)
                if cycle:
                    return cycle
        return None

    def violations(self) -> List[Violation]:
        """All recorded violations, including lock-order cycles found
        in the accumulated acquisition graph."""
        with self._state_lock:
            out = list(self._violations)
            edges = list(self._edges)
        cycle = self._find_cycle(edges)
        if cycle:
            witnesses = [
                f"{e.held}->{e.acquired} (thread {e.thread})"
                for e in edges
                if e.held in cycle and e.acquired in cycle
            ]
            out.append(
                Violation(
                    "lock-order-cycle",
                    " -> ".join(cycle)
                    + "; witnessed: "
                    + "; ".join(witnesses),
                )
            )
        return out

    def assert_clean(self) -> None:
        """Raise AssertionError listing every recorded hazard."""
        found = self.violations()
        if found:
            raise AssertionError(
                "racecheck found %d violation(s):\n%s"
                % (len(found), "\n".join(f"  - {v}" for v in found))
            )

    # -- context manager -------------------------------------------------

    def __enter__(self) -> "RaceCheck":
        return self

    def __exit__(self, exc_type: object, *exc: object) -> None:
        self.unwrap()
        if exc_type is None:
            self.assert_clean()
