"""Fleet wire of the port (counterpart of ``containerpilot_tpu/fleet/``):
only the client half of cp-mux/1 (``pool.MuxConnection``) so far; the
gateway, its pool and fleet membership are not ported (ROADMAP.md
queue 1)."""
