"""Version metadata: the port's own copy of ``containerpilot_tpu/version.py``
(``cp_build_info{version}`` must read the same on a JAX and a torch
replica of one release)."""

VERSION = "0.7.0"
GIT_HASH = "dev"
