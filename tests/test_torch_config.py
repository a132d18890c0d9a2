"""The port's config pipeline against the reference's: its own JSON5
reader (``containerpilot_tpu_torch/config/json5_reader.py``) against the
``json5`` package, and its template renderer and loader against
``containerpilot_tpu/config``. Every ``examples/*.json5``, the port's own
examples, and the valid and invalid configs of the reference's loader,
validation and template tests go through both: the results are equal
structures, or the same error text (a JSON5 parse error: the same
marked line).
"""
import enum
import glob
import math
import os
import re

import json5
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from containerpilot_tpu.config import loader as ref_loader
from containerpilot_tpu.config import template as ref_template
from containerpilot_tpu_torch.config import loader as port_loader
from containerpilot_tpu_torch.config import template as port_template
from containerpilot_tpu_torch.config.json5_reader import JSON5Error, loads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = sorted(glob.glob(os.path.join(REPO, "examples", "*.json5")))
PORT_EXAMPLES = sorted(glob.glob(os.path.join(
    REPO, "containerpilot_tpu_torch", "examples", "*.json5")))


def same(a, b) -> bool:
    """Equal values and types, NaN equal to NaN, -0.0 apart from 0.0,
    and dict keys in the same order."""
    if type(a) is not type(b):
        return False
    if isinstance(a, float):
        if math.isnan(a):
            return math.isnan(b)
        return a == b and math.copysign(1, a) == math.copysign(1, b)
    if isinstance(a, dict):
        return list(a) == list(b) and all(same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return a == b


# --- the JSON5 reader -------------------------------------------------------

@pytest.mark.parametrize("path", EXAMPLES + PORT_EXAMPLES,
                         ids=lambda p: os.path.relpath(p, REPO))
def test_reader_reads_every_example_as_json5_does(path):
    with open(path) as fh:
        text = port_template.apply_template(fh.read(), {})
    assert same(loads(text), json5.loads(text))


VALID_DOCUMENTS = [
    '/* x */ {a: [1, {b: "c",},],} // end',
    "{'single': 'quo\\'ted', \"dq\": \"a\\tb\", $d_1: null}",
    "[0x1F, -0X10, +7, -0, -0.0, .5, 5., 1e3, 2E-2, +Infinity, -NaN]",
    '{null: 1, true: 2, Infinity: 3, ä_x: 4, \\u0061b: 5}',
    '"line \\\ncontinued, \\x41\\u0042 \\0 \\q"',
    '{a: 1, a: 2, b: 3}',
    ' \ufeff {\r\n a : 1 , } ',
    '[[], {}, [[]], {"": ""}]',
]


@pytest.mark.parametrize("text", VALID_DOCUMENTS)
def test_reader_reads_json5_extensions_as_json5_does(text):
    assert same(loads(text), json5.loads(text))


INVALID_DOCUMENTS = [
    "{a:1,,}", "{\n a: 1\n b: 2}", "[1,2", '{"a":}', "{a:01}", "0x",
    '"abc', "{a:1}x", '"\\01"', "[,]", "00", "Infinity1", "0x1g",
    '"\\u00"', "[1 2]", "{a b}", "-", "1a", "{a:1 /* open",
    '{\n  jobs: [\n    { name: }\n  ]\n}', '"a\nb"', "nul",
]


@pytest.mark.parametrize("text", INVALID_DOCUMENTS)
def test_reader_refuses_what_json5_refuses_on_the_same_line(text):
    with pytest.raises(ValueError) as ref:
        json5.loads(text)
    with pytest.raises(JSON5Error) as port:
        loads(text)
    ref_line = re.search(r"<string>:(\d+)", str(ref.value)).group(1)
    assert re.search(r"line (\d+)", str(port.value)).group(1) == ref_line


def test_reader_refuses_the_empty_document_as_json5_does():
    with pytest.raises(ValueError) as ref:
        json5.loads("")
    with pytest.raises(JSON5Error, match=re.escape(str(ref.value))):
        loads("")


_KEYS = st.text(alphabet="abcXYZ_$09 -'\"\\é", min_size=0, max_size=6)
_STRINGS = st.text(min_size=0, max_size=12)
_SCALARS = (st.none() | st.booleans()
            | st.integers(min_value=-(1 << 40), max_value=1 << 40)
            | st.floats(allow_nan=True, allow_infinity=True) | _STRINGS)
_VALUES = st.recursive(
    _SCALARS,
    lambda inner: (st.lists(inner, max_size=4)
                   | st.dictionaries(_KEYS, inner, max_size=4)),
    max_leaves=12,
)
_STYLE = st.fixed_dictionaries({
    "quote": st.sampled_from(['"', "'"]),
    "bare_keys": st.booleans(),
    "trailing": st.booleans(),
    "comment": st.sampled_from(["", " // c\n", " /* c */ "]),
    "hex": st.booleans(),
    "plus": st.booleans(),
    "space": st.sampled_from(["", " ", "\n  ", "\t", "\r\n"]),
})
_BARE_KEY = re.compile(r"^[A-Za-z_$][A-Za-z0-9_$]*$")


def _string(s: str, quote: str) -> str:
    out = []
    for ch in s:
        if ch == "\\":
            out.append("\\\\")
        elif ch == quote:
            out.append("\\" + ch)
        elif ch == "\n":
            out.append("\\n")
        elif ch == "\r":
            out.append("\\r")
        elif ord(ch) < 0x20 or ch in "\u2028\u2029":
            out.append(f"\\u{ord(ch):04x}")
        else:
            out.append(ch)
    return quote + "".join(out) + quote


def _write(value, style) -> str:
    """One JSON5 text for ``value`` in the given style."""
    sp, com = style["space"], style["comment"]
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        if style["hex"] and value != 0:
            return ("-" if value < 0 else "") + hex(abs(value))
        return ("+" if style["plus"] and value > 0 else "") + str(value)
    if isinstance(value, float):
        if math.isnan(value):
            return "NaN"
        if math.isinf(value):
            return "Infinity" if value > 0 else "-Infinity"
        return repr(value)
    if isinstance(value, str):
        return _string(value, style["quote"])
    if isinstance(value, list):
        items = [_write(v, style) for v in value]
        tail = "," if style["trailing"] and items else ""
        return "[" + sp + ("," + sp + com).join(items) + tail + sp + "]"
    members = []
    for key, val in value.items():
        k = key if style["bare_keys"] and _BARE_KEY.match(key) else (
            _string(key, style["quote"]))
        members.append(f"{k}{sp}:{sp}{_write(val, style)}")
    tail = "," if style["trailing"] and members else ""
    return "{" + com + sp + ("," + sp).join(members) + tail + sp + "}"


@settings(max_examples=150, deadline=None)
@given(value=_VALUES, style=_STYLE)
def test_reader_agrees_with_json5_on_generated_documents(value, style):
    text = _write(value, style)
    want = json5.loads(text)
    assert same(loads(text), want), text


# --- the template renderer --------------------------------------------------

TEMPLATE_ENV = {"NAME": "world", "EMPTY": "", "CSV": "a,b,c",
                "HOST": "10.0.0.5:8080", "COUNT": "3", "TIER": "front"}
TEMPLATES = [
    "no actions here { } ", "hello {{ .NAME }}!", "[{{ .NOPE }}]",
    '{{ .NOPE | default "fallback" }}', '{{ .EMPTY | default "fb" }}',
    '{{ default "fb" .NOPE }}', '{{ .CSV | split "," | join ";" }}',
    '{{ .HOST | replaceAll ":8080" "" }}',
    '{{ .HOST | regexReplaceAll ":([0-9]+)$" "-$1" }}',
    "{{ range loop 3 }}x{{ end }}", "{{ range loop 1 4 }}{{ . }} {{ end }}",
    "{{ range loop 3 1 }}{{ . }}{{ end }}",
    "{{ range loop 0 .COUNT }}y{{ end }}",
    "{{ if .NAME }}yes{{ else }}no{{ end }}", "{{ if .NOPE }}yes{{ end }}",
    '{{ join "," (split "," .CSV) }}',
    '{{ if eq .TIER "front" "edge" }}front{{ end }}',
    '{{ if ne .COUNT "2" }}three{{ end }}', '{{ env "NAME" }}',
    '{{ "a\\\\n\\"b" }}', "{{ nosuch .NAME }}", "{{ if .NAME }}open",
    "{{ end }}", "{{ else }}", '{{ if eq .COUNT 3 }}x{{ end }}',
    "{{ if eq 1 1.0 }}x{{ end }}", "{{ loop 1 2 3 }}", "{{ .NAME | ( }}",
]


def _render(module, src):
    try:
        return ("ok", module.apply_template(src, dict(TEMPLATE_ENV)))
    except Exception as exc:  # noqa: BLE001 - the error is the result
        return ("error", type(exc).__name__, str(exc))


@pytest.mark.parametrize("src", TEMPLATES)
def test_template_renders_as_the_reference_does(src, monkeypatch):
    monkeypatch.setenv("NAME", "from-env")
    assert _render(port_template, src) == _render(ref_template, src)


# --- the loader ---------------------------------------------------------------

def _summary(obj):
    """A config object as plain data, for comparison across packages:
    public attributes by class name; metric collectors by kind, name
    and help."""
    if obj is None or isinstance(obj, (str, int, float, bool)):
        return obj
    if isinstance(obj, enum.Enum):
        return obj.value
    if isinstance(obj, dict):
        return {str(k): _summary(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple, set, frozenset)):
        return [_summary(v) for v in obj]
    kind = type(obj).__name__
    if kind in ("Counter", "Gauge", "Histogram", "Summary"):
        return {"metric": kind,
                "name": getattr(obj, "_name", None) or obj.name,
                "help": getattr(obj, "_documentation", None)
                or obj.documentation}
    if hasattr(obj, "__dict__"):
        return {"class": kind, **{k: _summary(v)
                                  for k, v in sorted(vars(obj).items())
                                  if not k.startswith("_")
                                  and not callable(v)}}
    return kind


GOOD_CONFIG = """
{
  // JSON5: comments and trailing commas are fine
  consul: "none",
  logging: { level: "DEBUG", format: "default", output: "stdout" },
  stopTimeout: "2s",
  jobs: [
    { name: "app", exec: "sleep 1", restarts: 1, },
    {
      name: "web-svc",
      exec: "sleep 1",
      port: 8080,
      interfaces: ["static:203.0.113.9"],
      health: { exec: "true", interval: 5, ttl: 15 },
    },
  ],
  watches: [ { name: "upstream", interval: 5 }, ],
  telemetry: {
    port: 9099,
    interfaces: ["static:127.0.0.1"],
    metrics: [
      { name: "zz_loader_sensor", help: "a sensor", type: "gauge" },
      { namespace: "ns", subsystem: "sub", name: "zz_steps_total",
        type: "counter" },
      { name: "zz_latency", help: "lat", type: "histogram" },
      { name: "zz_size", help: "size", type: "summary" },
    ],
  },
}
"""


def _job(**fields) -> str:
    import json

    return json.dumps({"jobs": [{"name": "app", "exec": "true", **fields}]})


HEALTH = {"exec": "true", "interval": 5, "ttl": 15}
ADVERTISED = {"port": 80, "interfaces": ["static:10.0.0.1"],
              "health": HEALTH}
CONFIGS = {
    "good": GOOD_CONFIG,
    "default_stop_timeout": '{ jobs: [{name: "a", exec: "true"}] }',
    "template_env": '{ jobs: [{ name: "app", exec: "{{ .APP_EXEC }}" }] }',
    "file_catalog": '{ consul: "file:/tmp/cp-test-catalog", '
                    'jobs: [{name: "a", exec: "true"}] }',
    "consul_uri": '{ consul: "127.0.0.1:8500", jobs: [] }',
    "name_from_exec": '{ jobs: [{ exec: "/bin/true --flag" }] }',
    "stop_dependency": '{ jobs: [{name: "main", exec: "sleep 1"}, '
                       '{name: "prestop", exec: "true", '
                       'when: {once: "stopping", source: "main"}}] }',
    "weak_numbers": _job(port="8080", interfaces=["static:10.0.0.1"],
                         health={"exec": "true", "interval": "5",
                                 "ttl": "15"}),
    "float_port": _job(port=8080.0, interfaces=["static:10.0.0.1"],
                       health=HEALTH),
    "service": _job(name="web-app", port=8080, tags=["v1"],
                    interfaces=["static:203.0.113.5"], health=HEALTH),
    "signal_source": _job(when={"source": "SIGHUP"}),
    "interval": _job(when={"interval": "5s"}),
    "restarts_never": _job(restarts="never"),
    "restarts_unlimited": _job(restarts="unlimited"),
    "restarts_string": _job(restarts="3"),
    "restarts_float": _job(restarts=1.2),
    "watch_weak": '{ consul: "none", watches: [{name: "backend", '
                  'interval: "7"}] }',
    "logging_json": '{ logging: {level: "warn", format: "json", '
                    'output: "stderr"}, jobs: [] }',
    "control": '{ control: {socket: "/tmp/cp-test.sock"}, jobs: [] }',
    # invalid
    "unknown_top_level": "{ bogus: 1, jobs: [] }",
    "parse_error": "{\n  jobs: [\n    { name: }\n  ]\n}",
    "not_an_object": "[1, 2]",
    "bad_stop_timeout": '{ stopTimeout: "5x", jobs: [] }',
    "when_exclusive": _job(when={"interval": "5s", "once": "healthy"}),
    "interval_too_small": _job(when={"interval": "100us"}),
    "each_unlimited": _job(restarts="unlimited",
                           when={"each": "changed",
                                 "source": "watch.backend"}),
    "restarts_word": _job(restarts="sometimes"),
    "restarts_negative": _job(restarts=-1),
    "restarts_bool": _job(restarts=True),
    "restarts_list": _job(restarts=[]),
    "port_without_health": _job(port=80),
    "health_without_interval": _job(port=80, health={"exec": "true",
                                                     "ttl": 5}),
    "health_without_ttl": _job(port=80, health={"exec": "true",
                                                "interval": 5}),
    "bad_service_name": _job(**{**ADVERTISED, "name": "Bad_Name"}),
    "unknown_job_key": _job(bogus=1),
    "initial_status": _job(**ADVERTISED, initial_status="bogus"),
    "port_word": _job(port="eighty"),
    "health_logging": _job(health={"exec": "x", "interval": 1, "ttl": 1,
                                   "logging": [1]}),
    "logging_unknown": '{ logging: {colour: "red"}, jobs: [] }',
    "logging_level": '{ logging: {level: "LOUD"}, jobs: [] }',
    "control_unknown": '{ control: {port: 1}, jobs: [] }',
    "telemetry_unknown": '{ telemetry: {bogus: 1}, jobs: [] }',
    "metric_type": '{ telemetry: {interfaces: ["static:127.0.0.1"], '
                   'metrics: [{name: "m", type: "meter"}]}, jobs: [] }',
    "bad_interface": _job(**{**ADVERTISED, "interfaces": ["nosuch[7]"]}),
    "bad_consul": '{ consul: {address: 1}, jobs: [] }',
    "template_error": '{ jobs: [{ name: "{{ nosuch }}", exec: "true" }] }',
}


def _load(module, path):
    try:
        return ("ok", _summary(module.load_config(path)))
    except Exception as exc:  # noqa: BLE001 - the error is the result
        return ("error", type(exc).__name__, str(exc))


def _marked_line(text: str) -> str:
    return re.search(r"^>>> (\d+):", text, re.M).group(1)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_loader_gives_what_the_reference_gives(name, tmp_path, monkeypatch):
    monkeypatch.setenv("APP_EXEC", "sleep 9")
    path = tmp_path / "cp.json5"
    path.write_text(CONFIGS[name])
    port, ref = _load(port_loader, str(path)), _load(ref_loader, str(path))
    if ref[0] == "error" and "parse error" in ref[2]:
        # the port's reader words its parse errors itself; both mark the
        # same line of the rendered config
        assert port[:2] == ref[:2]
        assert _marked_line(port[2]) == _marked_line(ref[2])
    else:
        assert port == ref


@pytest.mark.parametrize("path", EXAMPLES + PORT_EXAMPLES,
                         ids=lambda p: os.path.relpath(p, REPO))
def test_loader_reads_every_example_as_the_reference_does(path):
    assert _load(port_loader, path) == _load(ref_loader, path)
    assert _load(port_loader, path)[0] == "ok"


def test_port_examples_serve_and_train_with_the_ports_own_clis():
    """The port's examples exec the port's CLIs and check health with
    python3 alone (no curl)."""
    execs = {}
    for path in PORT_EXAMPLES:
        cfg = port_loader.load_config(path)
        for job in cfg.jobs:
            if job.exec is not None:
                execs[job.name] = [job.exec.exec] + job.exec.args
            if job.health_check_exec is not None:
                assert job.health_check_exec.exec == "python3", job.name
    assert {os.path.basename(p) for p in PORT_EXAMPLES} == {
        "serving-pod.json5", "training-pod.json5"}
    assert execs["inference"][:3] == [
        "python3", "-m", "containerpilot_tpu_torch.workload.serve"]
    assert execs["trainer"][:3] == [
        "python3", "-m", "containerpilot_tpu_torch.workload.train"]
    # the serving example's model is the flagship config
    argv = execs["inference"]
    flags = {argv[i]: argv[i + 1] for i in range(3, len(argv) - 1, 2)}
    assert {k: flags[k] for k in ("--vocab", "--d-model", "--n-heads",
                                  "--n-layers", "--d-ff")} == {
        "--vocab": "32768", "--d-model": "2048", "--n-heads": "16",
        "--n-layers": "16", "--d-ff": "8192"}


def test_serve_cli_and_pod_server_share_d_ff():
    """The serving example's ``--d-ff`` means the same to the serve CLI
    and to the pod server: one flag helper, one ``model_config``; 0
    derives the width from --d-model as the reference CLIs do."""
    from containerpilot_tpu_torch.workload import serve_cli, serve_dist
    from containerpilot_tpu_torch.workload.modelcfg import derive_d_ff

    pod = ["--process-id", "0", "--num-processes", "1", "--catalog",
           "file:/nonexistent"]
    for parser, extra in ((serve_cli.build_arg_parser(), []),
                          (serve_dist.build_arg_parser(), pod)):
        flagship = parser.parse_args(
            [*extra, "--d-model", "2048", "--d-ff", "8192"])
        derived = parser.parse_args([*extra, "--d-model", "2048"])
        assert serve_cli.model_config(flagship).d_ff == 8192
        assert serve_cli.model_config(derived).d_ff == derive_d_ff(2048)
    args = serve_dist.build_arg_parser().parse_args(
        [*pod, "--n-heads", "4", "--d-ff", "8190"])
    with pytest.raises(SystemExit, match="must divide --d-ff 8190"):
        serve_dist._refuse(args, 4)


def test_render_subcommand_output_matches(tmp_path):
    """``-template`` renders the same text through both packages."""
    from containerpilot_tpu_torch.config.loader import (
        render_config_template as port_render,
    )

    for path in EXAMPLES + PORT_EXAMPLES:
        assert port_render(path, {"SERVE_PORT": "8100"}) == (
            ref_loader.render_config_template(path, {"SERVE_PORT": "8100"}))
