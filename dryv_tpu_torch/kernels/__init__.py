"""Device stages of the port: plain PyTorch stage A, and kernels B1
(densify), B2 (intra wavefront) and B3 (deblock), each beside its plain
PyTorch version."""
