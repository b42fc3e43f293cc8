"""The PyTorch port imports without jax, triton and the JAX package
``dryv_tpu``, decodes without them, builds nothing at import, and never
falls back to the CPU on its own."""
import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "dryv_tpu_torch"
# every module of the port (the host-layer copies included), by its file
MODULES = tuple(sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts[:-1]
             if p.name == "__init__.py" else
             p.relative_to(ROOT).with_suffix("").parts)
    for p in PORT.rglob("*.py")
    if p.name != "__main__.py" and "build" not in p.relative_to(PORT).parts))


def _run(code):
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    return r.stdout


def test_import_with_jax_and_triton_blocked():
    _run("import sys\n"
         "sys.modules['jax'] = None\n"
         "sys.modules['triton'] = None\n"
         + "".join(f"import {m}\n" for m in MODULES))


def test_modules_cover_the_host_copies():
    for m in ("dryv_tpu_torch.native.full", "dryv_tpu_torch.native.build",
              "dryv_tpu_torch.cabac.syntax", "dryv_tpu_torch.decoder",
              "dryv_tpu_torch.encoder.intra_encoder",
              "dryv_tpu_torch.testing.sources", "dryv_tpu_torch.utils.obs",
              "dryv_tpu_torch.kernels.pred_tables",
              "dryv_tpu_torch.container.atoms", "dryv_tpu_torch.video",
              "dryv_tpu_torch.device_ipb_packed",
              "dryv_tpu_torch.kernels.inter", "dryv_tpu_torch.graphs",
              "dryv_tpu_torch.utils.ckpt"):
        assert m in MODULES


def _imported_roots(path):
    """Top-level package of every absolute import in a source file."""
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_nothing_of_dryv_tpu(path):
    """No module of the port, and not chip_smoke.py, imports the JAX
    package (``dryv_tpu_torch`` is the port itself) or jax."""
    assert not _imported_roots(path) & {"dryv_tpu", "jax", "jaxlib"}


def test_decode_with_dryv_tpu_and_jax_blocked(tmp_path):
    """In a process where ``dryv_tpu`` and jax cannot load, every port
    module imports and a fixture decodes on the CPU through the batched
    and the per-picture paths, equal to the libavcodec golden."""
    from dryv_tpu.testing.fixtures import get_fixture

    stream, golden, _, _ = get_fixture("mix_qp26")
    (tmp_path / "s.264").write_bytes(stream)
    _run("import sys\n"
         "sys.modules['dryv_tpu'] = None\n"
         "sys.modules['jax'] = None\n"
         + "".join(f"import {m}\n" for m in MODULES)
         + "import numpy as np\n"
           "from dryv_tpu_torch.gop_pipeline import "
           "decode_annexb_gop_pipelined\n"
           "from dryv_tpu_torch.pipeline import decode_annexb_fast\n"
           f"s = open({str(tmp_path / 's.264')!r}, 'rb').read()\n"
           "out = {}\n"
           "for k, fn in (('gop', decode_annexb_gop_pipelined),\n"
           "              ('fast', decode_annexb_fast)):\n"
           "    f, = fn(s, device='cpu')\n"
           "    out.update({f'{k}_y': f.y, f'{k}_cb': f.cb, f'{k}_cr': f.cr})\n"
           "assert decode_annexb_fast.host_calls == 0\n"
           "assert decode_annexb_gop_pipelined.fallback_calls == 0\n"
           f"np.savez({str(tmp_path / 'out.npz')!r}, **out)\n"
           "bad = [m for m, v in sys.modules.items() if v is not None "
           "and m.split('.')[0] in ('dryv_tpu', 'jax', 'jaxlib')]\n"
           "assert not bad, bad\n")
    got = np.load(tmp_path / "out.npz")
    for k in ("gop", "fast"):
        for plane, g in zip(("y", "cb", "cr"), golden):
            np.testing.assert_array_equal(got[f"{k}_{plane}"], g)


def test_ipb_decode_with_dryv_tpu_and_jax_blocked(tmp_path):
    """An encoder-made I/P/B stream (in-loop filter on) decodes through
    the packed device path on the CPU in a process where ``dryv_tpu`` and
    jax cannot load, equal to the libavcodec oracle."""
    from dryv_tpu.testing.oracle import decode_annexb

    stream = _ipb_stream()
    (tmp_path / "s.264").write_bytes(stream)
    _run("import sys\n"
         "sys.modules['dryv_tpu'] = None\n"
         "sys.modules['jax'] = None\n"
         "import numpy as np\n"
         "from dryv_tpu_torch.device_ipb_packed import "
         "decode_annexb_device_packed as d\n"
         f"s = open({str(tmp_path / 's.264')!r}, 'rb').read()\n"
         "fr = sorted(d(s, device='cpu'), key=lambda f: f.poc)\n"
         "assert d.host_calls == 0\n"
         f"np.savez({str(tmp_path / 'out.npz')!r}, "
         "**{f'{p}{i}': getattr(f, p) for i, f in enumerate(fr) "
         "for p in ('y', 'cb', 'cr')})\n"
         "bad = [m for m, v in sys.modules.items() if v is not None "
         "and m.split('.')[0] in ('dryv_tpu', 'jax', 'jaxlib')]\n"
         "assert not bad, bad\n")
    got = np.load(tmp_path / "out.npz")
    ref = decode_annexb(stream)
    assert len(got.files) == 3 * len(ref) == 9
    for i, planes in enumerate(ref):
        for p, r in zip(("y", "cb", "cr"), planes):
            np.testing.assert_array_equal(got[f"{p}{i}"], r)


def test_entry_with_dryv_tpu_and_jax_blocked():
    """``pipeline.entry`` (the counterpart of ``__graft_entry__.entry``)
    builds its picture and runs its step on the CPU in a process where
    ``dryv_tpu`` and jax cannot load, equal to the native C++ decode, and
    raises without CUDA unless given device="cpu"."""
    _run("import sys\n"
         "sys.modules['dryv_tpu'] = None\n"
         "sys.modules['jax'] = None\n"
         "import numpy as np, pytest, torch\n"
         "from dryv_tpu_torch.native.full import decode_annexb_native\n"
         "from dryv_tpu_torch.parallel import _tiny_stream\n"
         "from dryv_tpu_torch.pipeline import entry\n"
         "fn, args = entry(device='cpu')\n"
         "(ref,) = decode_annexb_native(_tiny_stream(1))\n"
         "for g, r in zip(fn(*args), (ref.y, ref.cb, ref.cr)):\n"
         "    np.testing.assert_array_equal(g.numpy(), r)\n"
         "torch.cuda.is_available = lambda: False\n"
         "with pytest.raises(RuntimeError, match='cuda'):\n"
         "    entry()\n"
         "bad = [m for m, v in sys.modules.items() if v is not None "
         "and m.split('.')[0] in ('dryv_tpu', 'jax', 'jaxlib')]\n"
         "assert not bad, bad\n")


def _ipb_stream():
    """I, P and B pictures of 6x4 MBs from the JAX package's encoder, the
    in-loop filter on (tests/test_device_ipb_packed.py's sequence)."""
    from dryv_tpu.encoder import default_sps_pps
    from dryv_tpu.encoder.p_frame import SequenceEncoder
    from dryv_tpu.encoder.slices import encode_sequence_annexb

    from test_device_ipb import _sources

    frame_at = _sources(31, 6, 4)
    sps, pps = default_sps_pps(6, 4, qp=28, poc_type=0, max_refs=2)
    se = SequenceEncoder(sps, pps, 28, deblock=True)
    frames = [
        (se.encode_idr(*frame_at(0), poc=0), 7, True, 0, 0, 3),
        (se.encode_p(*frame_at(4), poc=8), 5, False, 1, 8, 3),
        (se.encode_b(*frame_at(2), poc=4), 6, False, 2, 4, 0),
    ]
    return encode_sequence_annexb(sps, pps, frames, deblock_disable=0)


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
    from dryv_tpu_torch.device_ipb_packed import decode_annexb_device_packed
    with pytest.raises(RuntimeError, match="cuda"):
        decode_annexb_device_packed(b"", device="cuda")
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


def test_trace_device_writes_a_torch_profiler_trace(tmp_path):
    """utils.obs.trace_device traces with torch.profiler (CPU activity
    here) and writes a Chrome trace."""
    import json

    import torch

    from dryv_tpu_torch.utils.obs import trace_device

    with trace_device(str(tmp_path)) as prof:
        torch.ones(8).add_(1)
    assert any("add_" in e.name for e in prof.events())
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert trace["traceEvents"]
