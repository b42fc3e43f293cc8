"""Support utilities of the port: structured logging, stage timers and
the torch.profiler trace (copied from ``dryv_tpu/utils``; the DPB
checkpoint helpers are not, since nothing in the port uses them)."""
from .obs import StageTimers, logger, trace_device

__all__ = ["StageTimers", "logger", "trace_device"]
