"""Runtime health probes of the port (counterpart of
``containerpilot_tpu/analysis/``): only the event-loop lag probe
(``loopcheck.LoopLagProbe``) a replica's ``/metrics`` reads; the static
checkers are repo tooling, not part of a replica."""
