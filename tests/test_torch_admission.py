"""The port's admission controller, autoscaler and standby launcher
against the reference's: the cases of ``tests/test_admission.py`` (the
controller's queue, priorities, deadlines, token buckets and honest
``Retry-After``; the gateway's 429/504 answers over stub replicas; the
autoscaler's scale log over the reference's fake launchers) and the
``StandbyLauncher`` cases of ``tests/test_standby.py`` (promotions, cold
launches, refills with backoff), each run once on each package
(``tests/torch_twins.py``) with the same stubs, seeds and assertions.
The reference's mux client runs with its upgraded socket's writer held
(CPython 3.12 closes a dropped ``StreamWriter``); the port's keeps it."""
import pytest

import torch_twins
from torch_twins import keep_mux_writer  # noqa: F401 (a fixture)

ADMISSION_CASES = (
    "test_token_bucket_rate_and_refill",
    "test_admission_fast_path_then_queue_then_grant",
    "test_priority_ordering_and_sheds_under_full_queue",
    "test_deadline_expires_queued_request",
    "test_grant_racing_cancellation_leaks_no_slot",
    "test_session_bucket_raises_with_refill_hint",
    "test_retry_after_tracks_observed_drain_rate",
    "test_drain_rate_decays_down_when_wedged_not_merely_idle",
    "test_depth_one_queue_constructs_and_session_hint_is_capped",
    "test_pick_counts_admission_queued_work",
    "test_deadline_504_without_upstream_dispatch",
    "test_batch_sheds_while_interactive_admitted_under_full_queue",
    "test_gateway_graceful_drain_mid_traffic",
    "test_autoscaler_scale_up_needs_sustained_pressure_then_cools",
    "test_autoscaler_scales_down_least_loaded_to_min",
    "test_autoscaler_repairs_below_min_immediately",
    "test_autoscaler_launch_failures_backoff_then_converge",
    "test_autoscaler_stamps_launch_mode_from_standby_launcher",
    "test_autoscaler_flapping_signal_causes_no_thrash",
)

LAUNCHER_CASES = (
    "test_standby_launcher_promotes_then_refills",
    "test_standby_launcher_promote_race_single_winner",
    "test_standby_launcher_dead_standby_falls_back_cold",
    "test_standby_crash_mid_refill_retries_with_backoff",
)


@pytest.fixture(scope="module")
def twins():
    return {
        "test_admission": {
            pkg: torch_twins.load("test_admission", pkg)
            for pkg in torch_twins.PACKAGES},
        # the launcher cases use none of the compile-cache helpers the
        # file imports from workload/modelcfg.py (the port has its own)
        "test_standby": {
            pkg: torch_twins.load(
                "test_standby", pkg,
                drop_imports=("containerpilot_tpu.workload.modelcfg",))
            for pkg in torch_twins.PACKAGES},
    }


@pytest.mark.parametrize("package", torch_twins.PACKAGES)
@pytest.mark.parametrize(
    "module,case",
    [("test_admission", c) for c in ADMISSION_CASES]
    + [("test_standby", c) for c in LAUNCHER_CASES])
def test_admission_case(module, case, package, twins, run, tmp_path,
                        keep_mux_writer):
    fn = getattr(twins[module][package], case)
    fn(**torch_twins.case_args(fn, {"run": run, "tmp_path": tmp_path}))
