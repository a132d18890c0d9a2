"""Runtime health probes of the port (counterpart of
``containerpilot_tpu/analysis/``): the event-loop lag probe
(``loopcheck.LoopLagProbe``) a replica's and the gateway's ``/metrics``
read, and the leaked-task watchdog (``loopcheck.TaskWatchdog``) the
chaos harness gates on; the static checkers are repo tooling, not part
of a replica."""
from .loopcheck import LoopLagProbe, TaskWatchdog

__all__ = ["LoopLagProbe", "TaskWatchdog"]
