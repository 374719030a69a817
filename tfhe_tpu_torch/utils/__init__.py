"""Auxiliary subsystems: serialization, restartable jobs, telemetry and
profiling."""

from . import jobs
from . import profiling
from . import serialization
from . import telemetry

__all__ = ["jobs", "profiling", "serialization", "telemetry"]
