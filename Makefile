# Build/test entry points (reference: makefile — build, lint, test,
# integration tiers).

PYTHON ?= python

.PHONY: all build test test-fast test-workload integration fleet-smoke trace-smoke chaos chaos-smoke bench bench-host bench-gateway bench-reuse bench-goodput bench-coldstart bench-disagg bench-migrate lint lint-baseline lint-torch lint-torch-baseline lint-diff clean image

all: build test

build: bin/cpsup

bin/cpsup: native/sup.cpp
	$(MAKE) -C native cpsup
	mkdir -p bin
	cp native/cpsup bin/cpsup

# the tier-1 suite: everything except slow-marked chaos marathons
# (`make chaos` runs those; the tier-1 wall-time cap stays honest)
test:
	$(PYTHON) -m pytest tests/ -q -m 'not slow'

# supervisor tier only (~2 min): all host-side packages, no JAX compiles
test-fast:
	$(PYTHON) -m pytest tests/ -q -m supervisor

# the JAX models/ops/parallel tier (dominates full-suite wall time)
test-workload:
	$(PYTHON) -m pytest tests/ -q -m workload

# the integration-grade scenarios only (real CLI, real processes)
integration: build
	$(PYTHON) -m pytest tests/test_integration.py tests/test_app.py -q

# the inference-fleet scenarios (gateway routing units + the
# two-replica drain-mid-traffic integration test) on the CPU backend
fleet-smoke:
	JAX_PLATFORMS=cpu $(PYTHON) -m pytest tests/test_fleet.py -q

# cross-hop tracing proof on a live 2-replica fleet: a buffered and
# an SSE request over cp-mux/1, each stitched (gateway + replica
# spans under one trace id) with non-overlapping stage accounting
# (docs/90-observability.md)
trace-smoke:
	JAX_PLATFORMS=cpu $(PYTHON) scripts/trace_smoke.py

# trace-driven load + fault injection against a real fleet, scored on
# SLO-goodput (docs/80-chaos.md). chaos-smoke: the quick seeded
# scenarios (the same invariants tier-1 gates on — including the
# burst suite: burst_10x admission shedding and the autoscaled
# kill-under-burst) with the JSON goodput report; chaos: the full
# registry including the slow-marked compound marathons, plus the
# chaos test module end to end.
chaos-smoke:
	JAX_PLATFORMS=cpu $(PYTHON) -m containerpilot_tpu.chaos \
		--suite quick --json chaos-report.json
chaos:
	JAX_PLATFORMS=cpu $(PYTHON) -m containerpilot_tpu.chaos \
		--suite full --json chaos-report.json
	JAX_PLATFORMS=cpu $(PYTHON) -m pytest tests/test_chaos.py -q

bench:
	$(PYTHON) bench.py

# the decode loop's host-overhead + dispatch-count story on this box:
# legacy vs device-resident engine per-round host ms, plus the fused
# multi-round sweep (K in {1,4,8} rounds per dispatch) with
# dispatches/token per K; meets_target pins overhead <= 0.5x legacy
# AND K=8 dispatches/token <= 0.3x K=1
bench-host:
	JAX_PLATFORMS=cpu $(PYTHON) -c "import json, bench; \
		print(json.dumps(bench.host_overhead_bench(), indent=2))"

# the gateway hop's mux-vs-pooled-vs-per-dial cost on this box, plus
# the concurrency-per-socket probe (host-side number; the CPU backend
# is representative)
bench-gateway:
	JAX_PLATFORMS=cpu $(PYTHON) -c "import json, bench; \
		print(json.dumps(bench.gateway_overhead_bench(), indent=2))"

# fleet-wide KV reuse vs the session-sticky baseline on the same
# multi-turn chat trace: tokens_reused/prompt token + shed-free TTFT
# p50 per arm; meets_target pins reuse strictly above baseline
bench-reuse:
	JAX_PLATFORMS=cpu $(PYTHON) -c "import json, bench; \
		print(json.dumps(bench.prefix_reuse_bench(), indent=2))"

# disaggregated prefill/decode vs the same-size mixed fleet (docs/60):
# decode-pool TPOT p99, per-transfer KV handoff cost, and per-role
# productive fraction; meets_target pins the decode tail strictly
# under mixed with handoffs completed and the decode pool's ledger
# fraction at or above the mixed arm's
bench-disagg:
	JAX_PLATFORMS=cpu $(PYTHON) -c "import json, bench; \
		print(json.dumps(bench.disagg_bench(), indent=2))"

# the drain-migration yardstick (docs/60 § drain runbook): next-turn
# latency for a session whose replica drains — warm ceiling vs
# migrated-over-the-wire vs the re-prefill baseline; meets_target
# pins migrated strictly below re-prefill and near warm, with bytes
# moved and zero counted fallbacks
bench-migrate:
	JAX_PLATFORMS=cpu $(PYTHON) -c "import json, bench; \
		print(json.dumps(bench.migration_bench(), indent=2))"

# the device-time ledger's accounting bench (docs/90): every replica
# wall-second attributed (|sum(stages) - uptime| <= 2%) plus the
# dispatches/token trajectory the megakernel work must drive down
bench-goodput:
	JAX_PLATFORMS=cpu $(PYTHON) -c "import json, bench; \
		print(json.dumps(bench.goodput_ledger_bench(), indent=2))"

# the cold-start collapse yardstick (docs/60 § cold-start runbook):
# cold launch vs standby promotion vs peer weight-transfer launch,
# TTFRT + per-stage ledger breakdown from /v1/goodput; meets_target
# pins promoted <= 0.25x cold
bench-coldstart:
	JAX_PLATFORMS=cpu $(PYTHON) -c "import json, bench; \
		print(json.dumps(bench.cold_start_bench(), indent=2))"

# cpcheck (AST invariant rules vs analysis/baseline.json) + compileall;
# see docs/70-static-analysis.md. Non-zero on any non-baselined finding.
lint:
	$(PYTHON) -m containerpilot_tpu.analysis

# regenerate the committed baseline (shrink it, never grow it);
# reports which entries were added/removed and why they went stale
lint-baseline:
	$(PYTHON) -m containerpilot_tpu.analysis --write-baseline

# the port's gate: the same rules (plus torch's host syncs) over
# containerpilot_tpu_torch/ vs containerpilot_tpu_torch/analysis/baseline.json
lint-torch:
	$(PYTHON) -m containerpilot_tpu_torch.analysis

# regenerate the port's baseline (shrink it, never grow it)
lint-torch-baseline:
	$(PYTHON) -m containerpilot_tpu_torch.analysis --write-baseline

# cpcheck findings for files changed since $(SINCE) (default HEAD:
# staged + unstaged + untracked). Full call graph, findings filtered
# to the diff — a few-seconds loop, not a substitute for `make lint`.
lint-diff:
	scripts/cpcheck_diff.sh --since $(or $(SINCE),HEAD)

# release tarball (reference: makefile release target); VERSION expands
# lazily so only the release target pays the interpreter startup
VERSION = $(shell $(PYTHON) -c "from containerpilot_tpu.version import VERSION; print(VERSION)")
release: build
	mkdir -p release
	tar -czf release/containerpilot-tpu-$(VERSION).tar.gz \
		--exclude='__pycache__' --exclude='*.pyc' \
		--exclude='native/cpsup' \
		containerpilot_tpu bin/cpsup docs examples README.md \
		CHANGELOG.md pyproject.toml Makefile native

# container image with cpsup as the PID-1 entrypoint (reference:
# Dockerfile, makefile build-in-container targets)
IMAGE ?= containerpilot-tpu:latest
image:
	docker build -t $(IMAGE) .

clean:
	$(MAKE) -C native clean
	rm -rf bin release __pycache__ */__pycache__
