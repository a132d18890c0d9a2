"""The port's lint gate against the reference's.

``test_analysis_case`` runs every in-process case of
``tests/test_analysis.py`` (each rule's firing and clean fixtures, the
call-graph rules, pragmas, the baseline workflow, racecheck and
loopcheck) once on each package (``tests/torch_twins.py``); the port
spells its baseline target ``make lint-torch-baseline``. The cases that
run the CLI are twinned the same way in
``tests/test_torch_analysis_cli.py``. The two cases tied to the reference's own
tree get port counterparts: the port's baseline equals a fresh scan of
``containerpilot_tpu_torch/``, and ``make lint-torch`` passes. On top:
both analyzers give the same findings over the reference's source; over
the port's source (its disable pragmas blanked) the port's analyzer
finds what the reference's does plus hits on the torch names only; each
torch name fires where its rule looks and its pragma silences it; the
port's seven hot paths are hot roots; racecheck watches the port's bus
and fleet member as the reference's tests watch theirs; and the CLI
runs with the JAX package unimportable."""
import ast
import collections
import os
import re
import shutil
import subprocess
import sys
import textwrap

import pytest

import torch_twins
from containerpilot_tpu.analysis import cpcheck as ref_cpcheck
from containerpilot_tpu.analysis.callgraph import (
    build_project as ref_build_project,
)
from containerpilot_tpu_torch.analysis import (
    ALL_RULES,
    PROJECT_RULES,
    build_project,
    cpcheck,
    diff_against_baseline,
    load_baseline,
    scan_package,
    scan_project,
    scan_source,
)
from containerpilot_tpu_torch.analysis.cpcheck import _is_hotpath

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "containerpilot_tpu_torch")
REF = os.path.join(REPO, "containerpilot_tpu")

#: the reference's cases tied to its own package root and `make lint`
TIED = ("test_baseline_matches_fresh_scan", "test_make_lint_target")


def reference_cases(cli: bool):
    """The reference's cases, but the tied ones: those that run its CLI
    (call ``_run_cli``) or those that do not."""
    with open(os.path.join(REPO, "tests", "test_analysis.py")) as fh:
        tree = ast.parse(fh.read())
    return tuple(
        node.name for node in tree.body
        if isinstance(node, ast.FunctionDef)
        and node.name.startswith("test_") and node.name not in TIED
        and cli == any(isinstance(sub, ast.Name) and sub.id == "_run_cli"
                       for sub in ast.walk(node)))


CASES = reference_cases(cli=False)

#: the names the port adds to the reference's vocabularies
TORCH_NAMES = {"torch.cuda.synchronize"}
TORCH_TAILS = {"cpu", "tolist", "numpy", "synchronize"}

#: the port's hot roots, each the counterpart of a reference mark
HOT_ROOTS = {
    "containerpilot_tpu_torch.models.stepprog.PlainStepProgram.dispatch",
    "containerpilot_tpu_torch.models.stepprog.PlainStepProgram.tokens",
    "containerpilot_tpu_torch.models.speculative."
    "SpeculativeStepProgram.dispatch",
    "containerpilot_tpu_torch.models.speculative."
    "SpeculativeStepProgram.tokens",
    "containerpilot_tpu_torch.workload.serve_slots.SlotEngine._run",
    "containerpilot_tpu_torch.workload.serve_dist._SlotMirror.run_chunk",
    "containerpilot_tpu_torch.workload.serve_dist._apply_round",
}


def load_twins():
    return {pkg: torch_twins.load(
        "test_analysis", pkg,
        replace=[("make lint-baseline", "make lint-torch-baseline")])
        for pkg in torch_twins.PACKAGES}


@pytest.fixture(scope="module")
def twins():
    return load_twins()


@pytest.mark.parametrize("package", torch_twins.PACKAGES)
@pytest.mark.parametrize("case", CASES)
def test_analysis_case(case, package, twins, run, tmp_path, caplog):
    fn = getattr(twins[package], case)
    fn(**torch_twins.case_args(
        fn, {"run": run, "tmp_path": tmp_path, "caplog": caplog}))


# -- the port's own tree ------------------------------------------------


def _sources(root, blank_disables=False):
    """{repo-relative path: text} of every module under ``root``;
    ``blank_disables`` turns each ``cpcheck: disable`` into a comment
    the pragma parser ignores."""
    out = {}
    for path in cpcheck.iter_package_files(root):
        with open(path, encoding="utf-8") as fh:
            text = fh.read()
        if blank_disables:
            text = text.replace("cpcheck: disable", "cpcheck: blanked")
        out[os.path.relpath(path, REPO).replace(os.sep, "/")] = text
    return out


def test_port_baseline_matches_fresh_scan():
    """The port's committed baseline mirrors a fresh scan of the port:
    no new findings and no stale entries, each entry with a reason."""
    entries = load_baseline()
    new, stale = diff_against_baseline(
        scan_package(PORT, relative_to=REPO), entries)
    assert new == [], "new findings:\n" + "\n".join(
        f.render() for f in new)
    assert stale == [], "stale entries (make lint-torch-baseline):\n" + \
        "\n".join(str(e) for e in stale)
    assert entries and all(e.get("reason") for e in entries)
    assert all(e["file"].startswith("containerpilot_tpu_torch/")
               for e in entries)


def test_make_lint_torch_target():
    """`make lint-torch` is wired to the port's analyzer and passes."""
    if shutil.which("make") is None:
        pytest.skip("make not available")
    proc = subprocess.run(
        ["make", "lint-torch"], cwd=REPO, capture_output=True, text=True,
        timeout=180,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "cpcheck: clean" in proc.stdout


def test_port_hot_roots_are_marked():
    project = build_project(_sources(PORT))
    roots = {info.display for info in project.graph.functions.values()
             if _is_hotpath(info.node, info.ctx)}
    assert HOT_ROOTS <= roots, sorted(HOT_ROOTS - roots)


def test_seeded_cpu_fetch_in_port_hot_path_is_found():
    """A ``toks.cpu()`` seeded into the port's window fetch is a new
    CP-HOTSYNC finding."""
    path = os.path.join(PORT, "models", "stepprog.py")
    with open(path, encoding="utf-8") as fh:
        text = fh.read()
    anchor = "        rounds_run = int(handle.run) if handle.window else 1\n"
    assert text.count(anchor) == 1
    seeded = text.replace(anchor, anchor + "        handle.toks.cpu()\n")
    rel = "containerpilot_tpu_torch/models/stepprog.py"
    found = [f for f in scan_source(seeded, rel) if f.rule == "CP-HOTSYNC"]
    assert [(f.scope, f.text) for f in found] == [
        ("PlainStepProgram.tokens", "handle.toks.cpu()")]
    assert not [f for f in scan_source(text, rel)
                if f.rule == "CP-HOTSYNC"]


# -- the two analyzers side by side ---------------------------------------


def _keyed(findings, with_message=True):
    return collections.Counter(
        (f.rule, f.file, f.scope, f.text, f.line)
        + ((f.message,) if with_message else ()) for f in findings)


def test_reference_source_same_findings_under_both_analyzers():
    sources = _sources(REF)
    port = scan_project(build_project(sources))
    ref = ref_cpcheck.scan_project(ref_build_project(sources))
    assert _keyed(port) == _keyed(ref)
    assert port  # the reference's own baselined debt


def _named(finding):
    """The called name a finding reports (its first backticked word)."""
    match = re.search(r"`([^`]+)`", finding.message)
    return match.group(1) if match else ""


def test_port_source_differs_only_by_torch_names():
    """With every disable pragma blanked, the port's analyzer over the
    port finds all the reference analyzer finds, and the rest are hits
    on the torch names it adds."""
    sources = _sources(PORT, blank_disables=True)
    findings = scan_project(build_project(sources))
    port = _keyed(findings, False)
    ref = _keyed(ref_cpcheck.scan_project(ref_build_project(sources)),
                 False)
    assert not ref - port
    extra = port - ref
    assert extra  # the pinned reads and the speculative fetch, at least
    by_key = {(f.rule, f.file, f.scope, f.text, f.line): f
              for f in findings}
    for key in extra:
        finding = by_key[key]
        name = _named(finding)
        compiled = re.search(rf"\b{re.escape(name)}\s*=\s*torch\.compile\(",
                             sources[finding.file])
        assert (name in TORCH_NAMES
                or name.rpartition(".")[2] in TORCH_TAILS
                or compiled), (key, name)


# -- the torch vocabulary ---------------------------------------------------

HOT_CALLS = ("torch.cuda.synchronize()", "toks.cpu()", "toks.tolist()",
             "toks.numpy()", "event.synchronize()")
ASYNC_CALLS = ("torch.cuda.synchronize()", "event.synchronize()")


def _rules(src, rule):
    return [f for f in scan_source(textwrap.dedent(src), "fixture.py")
            if f.rule == rule]


@pytest.mark.parametrize("call", HOT_CALLS)
def test_torch_hotsync_names(call):
    fired = _rules(f"""
    # cpcheck: hotpath
    def round(toks, event):
        {call}
    """, "CP-HOTSYNC")
    assert [f.scope for f in fired] == ["round"]
    assert not _rules(f"""
    # cpcheck: hotpath
    def round(toks, event):
        {call}  # cpcheck: disable=CP-HOTSYNC the round's one fetch
    """, "CP-HOTSYNC")
    reached = _rules(f"""
    def fetch(toks, event):
        return {call}
    # cpcheck: hotpath
    def round(toks, event):
        return fetch(toks, event)
    """, "CP-HOTREACH")
    assert [f.scope for f in reached] == ["fetch"]
    # the reference's vocabulary has none of them
    assert not [f for f in ref_cpcheck.scan_source(textwrap.dedent(f"""
    # cpcheck: hotpath
    def round(toks, event):
        {call}
    """), "fixture.py") if f.rule == "CP-HOTSYNC"]


@pytest.mark.parametrize("call", ASYNC_CALLS)
def test_torch_asyncblock_names(call):
    fired = _rules(f"""
    async def handler(event):
        {call}
    """, "CP-ASYNCBLOCK")
    assert [f.scope for f in fired] == ["handler"]
    assert not _rules(f"""
    async def handler(event):
        {call}  # cpcheck: disable=CP-ASYNCBLOCK measured at shutdown
    """, "CP-ASYNCBLOCK")
    reached = _rules(f"""
    def settle(event):
        {call}
    async def handler(event):
        settle(event)
    """, "CP-ASYNCREACH")
    assert [f.scope for f in reached] == ["handler"]


def test_torch_compile_binding_retraces():
    src = """
    import torch
    step = torch.compile(decode)
    # cpcheck: hotpath
    def round(batch):
        return step(len(batch)){pragma}
    """
    fired = _rules(src.format(pragma=""), "CP-RETRACE")
    assert [f.scope for f in fired] == ["round"]
    assert not _rules(src.format(
        pragma="  # cpcheck: disable=CP-RETRACE bucketed upstream"),
        "CP-RETRACE")


def test_rule_catalogs_extend_the_reference():
    pairs = {r.rule_id: r for r in ALL_RULES}
    for ref_rule in ref_cpcheck.ALL_RULES:
        rule = pairs[ref_rule.rule_id]
        for table in ("BLOCKED_NAMES", "BLOCKED_ATTRS", "BLOCKED_TAILS",
                      "JIT_NAMES", "SCAN_NAMES", "KNOWN_DONATORS"):
            if hasattr(ref_rule, table):
                assert set(getattr(ref_rule, table)) <= set(
                    getattr(rule, table)), (rule.rule_id, table)
    assert {r.rule_id for r in PROJECT_RULES} == {
        "CP-ASYNCREACH", "CP-HOTREACH", "CP-LOCKORDER", "CP-NOTEWIRE"}


# -- racecheck on the port's bus and fleet member -------------------------

RACE_CASES = (
    ("test_events", "test_fanout_delivers_outside_bus_lock"),
    ("test_fleet", "test_member_drain_cycle_racecheck_clean"),
)


@pytest.mark.parametrize("package", torch_twins.PACKAGES)
@pytest.mark.parametrize("name,case", RACE_CASES)
def test_racecheck_mirror(name, case, package, run, tmp_path):
    module = torch_twins.load(name, package)
    fn = getattr(module, case)
    fn(**torch_twins.case_args(fn, {"run": run, "tmp_path": tmp_path}))


# -- the CLI stands alone ----------------------------------------------------

#: run the CLI with jax and the JAX package unimportable
BLOCKED = (
    "import runpy, sys\n"
    "class Block:\n"
    "    def find_spec(self, name, path=None, target=None):\n"
    "        if name.split('.')[0] in ('jax', 'jaxlib', "
    "'containerpilot_tpu'):\n"
    "            raise ImportError(name)\n"
    "sys.meta_path.insert(0, Block())\n"
    "sys.argv = ['analysis', '--list-rules']\n"
    "runpy.run_module('containerpilot_tpu_torch.analysis', "
    "run_name='__main__')\n"
)


def test_cli_lists_rules_without_the_jax_package():
    proc = subprocess.run(
        [sys.executable, "-c", BLOCKED], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    listed = [line.split(":")[0] for line in proc.stdout.splitlines()]
    assert listed == [r.rule_id for r in (*ALL_RULES, *PROJECT_RULES)]
