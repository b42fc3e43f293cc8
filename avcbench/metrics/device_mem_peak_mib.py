"""device_mem_peak_mib: torch.cuda.max_memory_reserved() once the window
has closed, in MiB: the caching allocator's peak, graph pools and planes
included.  Nothing to read without a card."""


def read(run):
    if run.mem_peak_bytes is None:
        return None
    return run.mem_peak_bytes / 2 ** 20
