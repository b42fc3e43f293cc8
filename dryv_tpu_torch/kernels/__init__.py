"""Device stages of the port: kernels B1 (densify), B2 (intra
wavefront), B3 (deblock), B4 (motion compensation), B5 (stage A) and B6
(deblock parameters), each beside its plain PyTorch version."""

# the decode steps' device work outside the hand kernels, each part in a
# torch.profiler range of this name (``record_function``), so that a
# device trace of an eager step sums its time by part (the I/P/B step's
# coded flags per 4x4 block come out of B5, so no "nz4" range is left)
RANGES = ("wire_syntax", "dense_rows_fixes", "stage_a", "recon_inputs",
          "deblock_params")
