"""Support utilities of the port: structured logging, stage timers, the
torch.profiler trace and the DPB checkpoint helpers (copied from
``dryv_tpu/utils``)."""
from .ckpt import restore_dpb, snapshot_dpb
from .obs import StageTimers, enable_debug_log, logger, trace_device

__all__ = ["StageTimers", "logger", "enable_debug_log", "trace_device",
           "snapshot_dpb", "restore_dpb"]
