"""The port's CLI and ``TorchVideo.decode_frames`` route by backend
(``--backend torch|device-ipb|native|scalar``, as ``dryv_tpu/cli.py``
does): an encoder-made I/P/B stream in an MP4 decodes on the CPU through
each, equal to the libavcodec oracle, and "device-ipb" takes the packed
device path."""
import numpy as np
import pytest

from dryv_tpu.avc import NalUnitType, split_annexb
from dryv_tpu.avc.nal import to_avcc_sample
from dryv_tpu.container import write_mp4
from dryv_tpu.testing.oracle import decode_annexb
from dryv_tpu_torch import cli
from dryv_tpu_torch.device_ipb_packed import (PackedPictureDecoder,
                                              decode_annexb_device_packed)
from dryv_tpu_torch.pipeline import decode_annexb_fast
from dryv_tpu_torch.video import BACKENDS, TorchVideo

from test_torch_import import _ipb_stream


@pytest.fixture(scope="module")
def ipb_mp4(tmp_path_factory):
    """The I, P, B pictures (6x4 MBs, in-loop filter on), one sample each,
    and the oracle's planes in display order."""
    stream = _ipb_stream()
    nals = list(split_annexb(stream))
    sps = next(n for n in nals if n.type == NalUnitType.SPS).to_bytes()
    pps = next(n for n in nals if n.type == NalUnitType.PPS).to_bytes()
    samples = [to_avcc_sample([n]) for n in nals
               if n.type in (NalUnitType.IDR_SLICE,
                             NalUnitType.NON_IDR_SLICE)]
    path = tmp_path_factory.mktemp("cli") / "ipb.mp4"
    write_mp4(path, samples, sps, pps, 96, 64)
    return path, decode_annexb(stream)


@pytest.mark.parametrize("backend", BACKENDS)
def test_cli_backend(backend, ipb_mp4, tmp_path, monkeypatch, capsys):
    path, ref = ipb_mp4
    pictures = []
    forward = PackedPictureDecoder.forward

    def counted(self, *args):
        pictures.append(args[5])
        return forward(self, *args)

    monkeypatch.setattr(PackedPictureDecoder, "forward", counted)
    host = (decode_annexb_fast.host_calls,
            decode_annexb_device_packed.host_calls)
    out = tmp_path / "out.yuv"
    assert cli.main([str(path), "-o", str(out), "--frames", "0",
                     "--device", "cpu", "--backend", backend]) == 0
    assert "wrote 3 frame(s)" in capsys.readouterr().out
    want = b"".join(p.tobytes() for planes in ref for p in planes)
    assert out.read_bytes() == want
    # device-ipb decodes I, P and B on the device path; torch hands the
    # inter stream to the host decoder, as the JAX package's "jax" does
    assert pictures == ([0, 1, 2] if backend == "device-ipb" else [])
    assert (decode_annexb_fast.host_calls - host[0],
            decode_annexb_device_packed.host_calls - host[1]) == \
        ((1, 0) if backend == "torch" else (0, 0))


def test_decode_frames_rejects_an_unknown_backend(ipb_mp4):
    with pytest.raises(ValueError, match="device-ipb"):
        TorchVideo.open(ipb_mp4[0]).decode_frames(backend="jax")
