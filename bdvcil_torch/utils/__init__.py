"""Host-side utilities of the port. ``meters``: the throughput meter of the
train loop."""

from .meters import Throughput

__all__ = ["Throughput"]
