"""Jobs: the supervisor's core domain actor (reference: jobs/ package).

The port's own copy of ``containerpilot_tpu/jobs/__init__.py``.
"""
from .config import UNLIMITED, JobConfig, JobConfigError, new_job_configs
from .jobs import Job, from_configs
from .status import JobStatus

__all__ = [
    "Job",
    "JobConfig",
    "JobConfigError",
    "JobStatus",
    "UNLIMITED",
    "from_configs",
    "new_job_configs",
]
