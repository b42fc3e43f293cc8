"""The PyTorch port imports without jax and triton, builds nothing at
import, and never falls back to the CPU on its own."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
MODULES = ("dryv_tpu_torch", "dryv_tpu_torch.gop_pipeline",
           "dryv_tpu_torch.video", "dryv_tpu_torch.cli",
           "dryv_tpu_torch.tables", "dryv_tpu_torch.device",
           "dryv_tpu_torch._build", "dryv_tpu_torch.kernels.geometry",
           "dryv_tpu_torch.kernels.transform",
           "dryv_tpu_torch.kernels.densify",
           "dryv_tpu_torch.kernels.wavefront",
           "dryv_tpu_torch.kernels.deblock", "dryv_tpu_torch.pipeline",
           "dryv_tpu_torch.syntax", "dryv_tpu_torch.parallel",
           "dryv_tpu_torch.parallel.mesh", "dryv_tpu_torch.parallel.gop",
           "dryv_tpu_torch.parallel.bands")


def _run(code):
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_import_with_jax_and_triton_blocked():
    _run("import sys\n"
         "sys.modules['jax'] = None\n"
         "sys.modules['triton'] = None\n"
         + "".join(f"import {m}\n" for m in MODULES))


def test_import_leaves_no_jax():
    _run("import sys\n"
         + "".join(f"import {m}\n" for m in MODULES)
         + "bad = [m for m in sys.modules if m.split('.')[0] in "
           "('jax', 'jaxlib', 'triton')]\n"
           "assert not bad, bad\n"
           "import dryv_tpu_torch._build as b\n"
           "assert b._lib is None\n")


def test_cuda_requested_without_cuda_raises(monkeypatch):
    import torch

    from dryv_tpu_torch.device import resolve_device
    from dryv_tpu_torch.gop_pipeline import decode_annexb_gop_pipelined

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        decode_annexb_gop_pipelined(b"", device="cuda")
    assert resolve_device("cpu").type == "cpu"


def test_cpu_tensors_take_the_plain_versions():
    """A wrapper given CPU tensors runs its plain twin: no build, no
    launch counted."""
    import torch

    from dryv_tpu_torch import _build
    from dryv_tpu_torch.kernels.densify import densify

    before = densify.launches
    bmp = torch.zeros((1, 128, 51), dtype=torch.uint8)
    vals = torch.zeros((1, 128, 32), dtype=torch.int8)
    out = densify(bmp, vals)
    assert out.dtype == torch.int16 and not out.any()
    assert densify.launches == before
    assert _build._lib is None
    np.testing.assert_array_equal(out.numpy(), 0)
