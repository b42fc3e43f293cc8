"""Device stages of the port: plain PyTorch stage A, and kernels B1
(densify), B2 (intra wavefront), B3 (deblock) and B4 (motion
compensation), each beside its plain PyTorch version."""

