"""KV tiering (counterpart of ``containerpilot_tpu/kvtier/``): only the
prefix digest so far (``digest.py``); the host spill tier and the
handoff wire are not ported yet (ROADMAP.md queue 1)."""
