"""Device stages of the port: kernels B1 (densify), B2 (intra
wavefront), B3 (deblock), B4 (motion compensation), B5 (stage A) and B6
(deblock parameters), each beside its plain PyTorch version."""

# the decode steps' device work outside the hand kernels, each part in a
# torch.profiler range of this name (``record_function``), so that a
# device trace of an eager step sums its time by part
RANGES = ("wire_syntax", "dense_rows_fixes", "stage_a", "recon_inputs",
          "nz4", "deblock_params")
