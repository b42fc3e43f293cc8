"""The least time a hand kernel's launch can take, for the per-layer
roofline metrics.  Each launch's bytes and int32 operations are frozen
per pool picture in its configuration's ``work.json``, written once by
``tools/kernel_work.py`` (operations by ``chip_smoke.py``'s ``b2_ops`` and
``b3_ops``, counted from ``csrc/intra_wavefront.cu`` and
``csrc/deblock.cu``), so that no later change to the program moves the
yardstick."""


def launch_bound_s(nbytes, ops, peak) -> float:
    """Least seconds a launch that moves `nbytes` (each input read once,
    each output written once) and does `ops` int32 operations can take:
    the larger of the two at the card's peak rates (``peaks.PEAKS``)."""
    return max(nbytes / peak["hbm_bytes_per_s"],
               ops / peak["int32_ops_per_s"])
