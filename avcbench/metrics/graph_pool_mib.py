"""graph_pool_mib: MiB of card memory in the CUDA graph pools of the
path's step cache (``StepCache.pool_mib()``, summed over its cards) once
the window has closed.  Nothing to read where no graph was captured."""


def read(run):
    return sum(run.pool_mib.values()) if run.pool_mib else None
