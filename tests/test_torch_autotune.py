"""The port's flash crossover table (``containerpilot_tpu_torch/ops/
tuning.py``, ``ops/autotune.py``) against the reference's: ``build_table``
on the same hand-built results, and ``pick_blocks``/``resolve_min_seq``/
``flash_eligible`` through one table installed in both. On the CPU the
port finds no table (its platform is ``cpu``) and keeps the untuned
defaults; the committed H100 table loads with the card's name and power
limit in it; the TPU's table is never read."""
import json
import os

import pytest

from containerpilot_tpu.models import transformer as ref_tf
from containerpilot_tpu.ops import autotune as ref_autotune
from containerpilot_tpu.ops import tuning as ref_tuning
from containerpilot_tpu_torch.models import transformer as port_tf
from containerpilot_tpu_torch.ops import autotune, tuning

H100_TABLE = os.path.join(os.path.dirname(tuning.__file__), "tuned",
                          "nvidia-h100-80gb-hbm3.json")


@pytest.fixture(autouse=True)
def rediscover():
    yield
    for module in (tuning, ref_tuning):
        module.set_table(None)


def _entry(plain_fwd, plain_train, pairs):
    return {"xla_fwd_ms": plain_fwd, "xla_train_ms": plain_train,
            "flash": {f"{bq}x{bk}": {"fwd_ms": f, "train_ms": t}
                      for (bq, bk), (f, t) in pairs.items()}}


RESULTS = {
    "flash_everywhere": {
        str(s): _entry(1.0, 2.0, {(128, 128): (0.1, 0.5)})
        for s in (128, 512, 1024)},
    "crossover_at_512": {
        "128": _entry(0.1, 0.2, {(128, 128): (0.2, 0.4)}),
        "512": _entry(0.5, 1.0, {(128, 128): (0.3, 0.9)}),
        "1024": _entry(2.0, 4.0, {(128, 128): (0.6, 1.2)}),
    },
    "flash_never": {
        "256": _entry(0.1, 0.2, {(128, 128): (0.2, 0.4)}),
        "1024": _entry(0.5, 1.0, {(128, 128): (0.7, 1.1)}),
    },
    "loses_in_the_middle": {
        "128": _entry(1.0, 1.0, {(128, 128): (0.5, 0.5)}),
        "256": _entry(0.1, 0.1, {(128, 128): (0.5, 0.5)}),
        "512": _entry(1.0, 1.0, {(128, 128): (0.5, 0.5)}),
    },
    "tuned_pairs": {
        "1024": _entry(1.0, 2.0, {(128, 128): (0.4, 0.8),
                                  (256, 128): (0.3, 0.9),
                                  (128, 256): (0.45, 0.7)}),
        "2048": _entry(3.0, 6.0, {(128, 128): (0.5, 1.0),
                                  (256, 256): (0.5, 1.0)}),
    },
    "no_default_pair": {
        "2048": _entry(3.0, 6.0, {(256, 256): (0.5, 1.0)}),
    },
}


@pytest.mark.parametrize("name", sorted(RESULTS))
def test_build_table_equals_the_reference(name):
    results = json.loads(json.dumps(RESULTS[name]))
    assert autotune.build_table(results, "card") == (
        ref_autotune.build_table(json.loads(json.dumps(results)), "card"))


TABLES = [
    {"platform": "t", "flash_min_seq": {"train": 2048, "fwd": 1024},
     "blocks": {"train": {"2048": [256, 128], "8192": [512, 256]},
                "fwd": {"1024": [128, 128]}}},
    ref_autotune.build_table(RESULTS["tuned_pairs"], "t"),
    ref_autotune.build_table(RESULTS["crossover_at_512"], "t"),
]


@pytest.mark.parametrize("table", TABLES, ids=["sample", "tuned", "512"])
def test_lookups_through_one_table_agree(table):
    """pick_blocks, auto_min_seq, resolve_min_seq and the model's
    flash_eligible give the same answers in both packages."""
    tuning.set_table(table)
    ref_tuning.set_table(table)
    for kind in ("train", "fwd"):
        assert tuning.auto_min_seq(kind) == ref_tuning.auto_min_seq(kind)
        for configured in (tuning.AUTO, 0, 512, 4096):
            assert tuning.resolve_min_seq(configured, kind) == (
                ref_tuning.resolve_min_seq(configured, kind))
        for seq in (128, 256, 384, 512, 1024, 2048, 2176, 4096, 8192):
            assert tuning.pick_blocks(kind, seq) == (
                ref_tuning.pick_blocks(kind, seq))
    port_cfg = port_tf.TransformerConfig(vocab_size=64, d_model=32,
                                         n_heads=2, n_layers=1, d_ff=64)
    ref_cfg = ref_tf.TransformerConfig(vocab_size=64, d_model=32,
                                       n_heads=2, n_layers=1, d_ff=64)
    for seq in range(64, 4097, 64):
        for kind in ("train", "fwd"):
            assert port_tf.flash_eligible(port_cfg, seq, kind) == (
                ref_tf.flash_eligible(ref_cfg, seq, kind)), (seq, kind)


def test_cpu_keeps_the_untuned_defaults(monkeypatch):
    monkeypatch.delenv("CONTAINERPILOT_FLASH_TABLE", raising=False)
    assert tuning.platform_slug() == "cpu"
    tuning.set_table(None)
    assert tuning._table_path() is None
    assert tuning.resolve_min_seq(tuning.AUTO, "fwd") == 1024
    assert tuning.resolve_min_seq(tuning.AUTO, "train") == 1024
    assert tuning.pick_blocks("train", 4096) == (128, 128)


def test_the_tpu_table_is_never_read(monkeypatch):
    """A platform named like the TPU finds nothing: the port looks only
    in its own tuned/ directory."""
    monkeypatch.delenv("CONTAINERPILOT_FLASH_TABLE", raising=False)
    monkeypatch.setattr(tuning, "platform_slug",
                        lambda device="cuda": "tpu-v5-lite")
    tuning.set_table(None)
    assert tuning._table_path() is None
    assert tuning.auto_min_seq("train") == tuning.DEFAULT_MIN_SEQ
    assert os.listdir(os.path.dirname(H100_TABLE)) == [
        os.path.basename(H100_TABLE)]


def test_committed_h100_table_resolves_on_its_card(monkeypatch):
    monkeypatch.delenv("CONTAINERPILOT_FLASH_TABLE", raising=False)
    with open(H100_TABLE) as fh:
        table = json.load(fh)
    assert {"platform", "flash_min_seq", "blocks", "speedup_vs_default",
            "measurements"} <= set(table)
    assert table["platform"] == tuning.slug("NVIDIA H100 80GB HBM3")
    assert table["card"] and all(line.startswith("NVIDIA H100")
                                 and line.endswith(" W")
                                 for line in table["card"])
    seqs = {int(s) for s in table["measurements"]}
    assert {128, 512, 896, 1024, 8192} <= seqs
    # the table is build_table's own answer to its measurements
    rebuilt = ref_autotune.build_table(table["measurements"],
                                       table["platform"])
    assert rebuilt["flash_min_seq"] == table["flash_min_seq"]
    assert rebuilt["blocks"] == table["blocks"]
    monkeypatch.setattr(tuning, "platform_slug",
                        lambda device="cuda": table["platform"])
    tuning.set_table(None)
    assert tuning._table_path() == H100_TABLE
    for kind in ("fwd", "train"):
        assert tuning.resolve_min_seq(tuning.AUTO, kind) == (
            table["flash_min_seq"][kind])


def test_the_table_follows_the_tensors_device(monkeypatch):
    """On a host whose card has a committed table, a CPU run still keeps
    the untuned defaults and never asks CUDA for the card's name: the
    platform comes from the device the attention's tensors are on."""
    import torch

    monkeypatch.delenv("CONTAINERPILOT_FLASH_TABLE", raising=False)
    with open(H100_TABLE) as fh:
        table = json.load(fh)
    names = []

    def device_name(device=None):
        names.append(device)
        return "NVIDIA H100 80GB HBM3"

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", device_name)
    tuning.set_table(None)
    cfg = port_tf.TransformerConfig(vocab_size=64, d_model=32, n_heads=2,
                                    n_layers=1, d_ff=64, max_seq_len=512)
    for kind in ("fwd", "train"):
        assert tuning.resolve_min_seq(tuning.AUTO, kind, device="cpu") == (
            tuning.DEFAULT_MIN_SEQ)
        assert not port_tf.flash_eligible(cfg, 256, kind, device="cpu")
    params = port_tf.init_params(0, cfg, device="cpu")
    with torch.no_grad():
        port_tf.forward(params, torch.zeros((1, 256), dtype=torch.long),
                        cfg)
    assert names == []
    assert tuning.platform_slug("cpu") == "cpu"
    for kind in ("fwd", "train"):
        assert tuning.resolve_min_seq(tuning.AUTO, kind, device="cuda") == (
            table["flash_min_seq"][kind])
    assert port_tf.flash_eligible(cfg, 256, "fwd", device="cuda") == (
        256 >= table["flash_min_seq"]["fwd"])
    assert names and tuning._table_path("cuda") == H100_TABLE


def test_env_override_names_the_table(tmp_path, monkeypatch):
    path = tmp_path / "table.json"
    path.write_text(json.dumps(TABLES[0]))
    monkeypatch.setenv("CONTAINERPILOT_FLASH_TABLE", str(path))
    tuning.set_table(None)
    assert tuning.auto_min_seq("train") == 2048
    assert tuning.pick_blocks("train", 8192) == (512, 256)


def test_measure_runs_both_kinds_through_flash_and_plain(monkeypatch):
    """The measurement's path on the CPU's plain versions (the timer
    replaced: device times come from the card only): both kinds of both
    paths run, and the results have the reference's schema."""
    calls = []

    def fake_time(fn, n=5, reps=3):
        fn()
        calls.append(fn)
        return float(len(calls))

    monkeypatch.setattr(autotune, "_time_ms", fake_time)
    results = autotune.measure([128, 256], batch=1, heads=2, head_dim=16,
                               device="cpu")
    assert len(calls) == 8
    for entry in results.values():
        assert set(entry) == {"xla_fwd_ms", "xla_train_ms", "flash"}
        assert set(entry["flash"]) == {"128x128"}
        assert set(entry["flash"]["128x128"]) == {"fwd_ms", "train_ms"}
    table = autotune.build_table(results, "cpu")
    assert table == ref_autotune.build_table(results, "cpu")


def test_measure_needs_a_card():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        autotune.measure([128])
