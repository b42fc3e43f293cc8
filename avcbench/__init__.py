"""avcbench: the benchmark of dryv_tpu_torch, the PyTorch and CUDA H.264
decoder.  ``python3 -m avcbench --help``; ``run.py`` says how a run
goes."""
