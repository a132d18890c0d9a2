"""The replica's side of the fleet (counterpart of
``containerpilot_tpu/fleet/``): cp-mux/1's client half and the
connection pool (``pool.py``), the heartbeat note schema (``notes.py``),
membership and drain (``member.py``) and the warm standby's weight
transfer (``standby.py``). The gateway, admission and the autoscaler
run a replica from outside and stay with the reference."""
from .member import FleetMember

__all__ = ["FleetMember"]
