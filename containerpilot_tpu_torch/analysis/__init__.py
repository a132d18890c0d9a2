"""The port's invariant checking (counterpart of
``containerpilot_tpu/analysis/``).

``python -m containerpilot_tpu_torch.analysis`` is the ``make
lint-torch`` body: it byte-compiles the port's package and runs the
cpcheck AST rules (``cpcheck.py``) and the call-graph rules
(``callgraph.py``) over every module, comparing findings against the
committed ``analysis/baseline.json``. New findings exit non-zero; the
baseline enumerates pre-existing, justified debt instead of hiding it.
The rules match torch's host syncs beside JAX's, so the same source
gives the same findings under either package's analyzer.

``racecheck.py`` is the opt-in runtime lock-order/publish-discipline
harness tests use, and ``loopcheck.py`` is its event-loop sibling:
the lag probe (``LoopLagProbe``) a replica's and the gateway's
``/metrics`` read, and the leaked-task watchdog (``TaskWatchdog``) the
chaos harness gates on. Everything here is stdlib only.
"""
from .callgraph import (
    PROJECT_RULES,
    PROJECT_RULES_BY_ID,
    CallGraph,
    ProjectContext,
    build_project,
    build_project_from_paths,
    run_project_rules,
)
from .cpcheck import (
    ALL_RULES,
    Finding,
    RULES_BY_ID,
    baseline_path,
    diff_against_baseline,
    explain_stale,
    hotpath,
    load_baseline,
    scan_file,
    scan_package,
    scan_project,
    scan_source,
    write_baseline,
)
from .loopcheck import LoopLagProbe, TaskWatchdog
from .racecheck import CheckedLock, RaceCheck, Violation

__all__ = [
    "LoopLagProbe",
    "TaskWatchdog",
    "ALL_RULES",
    "RULES_BY_ID",
    "PROJECT_RULES",
    "PROJECT_RULES_BY_ID",
    "CallGraph",
    "ProjectContext",
    "build_project",
    "build_project_from_paths",
    "run_project_rules",
    "Finding",
    "scan_source",
    "scan_file",
    "scan_package",
    "scan_project",
    "baseline_path",
    "load_baseline",
    "write_baseline",
    "diff_against_baseline",
    "explain_stale",
    "RaceCheck",
    "CheckedLock",
    "Violation",
    "hotpath",
]
