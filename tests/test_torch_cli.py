"""The port's CLI and ``TorchVideo.decode_frames`` route by backend
(``--backend torch|device-ipb|native|scalar``, and "jax" for "torch", as
``dryv_tpu/cli.py`` does): an encoder-made I/P/B stream in an MP4
decodes on the CPU through each, equal to the libavcodec oracle, and
"device-ipb" takes the packed device path.  The CLI is a drop-in for
``python -m dryv_tpu``: the same output file, the same command lines,
and the facade's ``SeekPosition``, info properties and debug log."""
import argparse
import logging
import re
import shlex
from pathlib import Path

import numpy as np
import pytest

from dryv_tpu import cli as jax_cli
from dryv_tpu.avc import NalUnitType, split_annexb
from dryv_tpu.avc.nal import to_avcc_sample
from dryv_tpu.container import write_mp4
from dryv_tpu.testing.oracle import decode_annexb
from dryv_tpu.video import SeekPosition as JaxSeekPosition
from dryv_tpu.video import Video
from dryv_tpu_torch import cli
from dryv_tpu_torch.device_ipb_packed import (PackedPictureDecoder,
                                              decode_annexb_device_packed)
from dryv_tpu_torch.pipeline import decode_annexb_fast
from dryv_tpu_torch.video import BACKENDS, SeekPosition, TorchVideo
from dryv_tpu_torch import wire

from test_torch_import import _ipb_stream


@pytest.fixture(autouse=True)
def empty_staging_keep():
    """Each test starts from an emptied staging keep and leaves none
    (``wire.release``): a staging kept from an earlier test would start
    a decode at the caps that test grew to, not at the entry's start
    caps, and so change its steps' keys."""
    wire.release()
    yield
    wire.release()


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


@pytest.mark.parametrize("backend", BACKENDS + ("jax",))
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
                     "--device", "cpu", "--backend", backend,
                     "--all-frames"]) == 0
    assert "wrote 3 frame(s)" in capsys.readouterr().out
    want = b"".join(p.tobytes() for planes in ref for p in planes)
    assert out.read_bytes() == want
    # device-ipb decodes I, P and B on the device path; torch hands the
    # inter stream to the host decoder, as the JAX package's "jax" does
    assert pictures == ([0, 1, 2] if backend == "device-ipb" else [])
    assert (decode_annexb_fast.host_calls - host[0],
            decode_annexb_device_packed.host_calls - host[1]) == \
        ((1, 0) if backend in ("torch", "jax") else (0, 0))


def test_decode_frames_rejects_an_unknown_backend(ipb_mp4):
    with pytest.raises(ValueError, match="device-ipb"):
        TorchVideo.open(ipb_mp4[0]).decode_frames(backend="jax")


def test_cli_writes_what_the_jax_cli_writes(ipb_mp4, tmp_path, capsys):
    """Without --all-frames the port writes frames[0], byte for byte the
    JAX CLI's file, whatever --frames says."""
    path = str(ipb_mp4[0])
    ours, theirs = tmp_path / "port.yuv", tmp_path / "jax.yuv"
    args = ["--frames", "3", "--backend", "native"]
    assert cli.main([path, "-o", str(ours), *args]) == 0
    assert "wrote 1 frame(s)" in capsys.readouterr().out
    assert jax_cli.main([path, "-o", str(theirs), *args]) == 0
    assert ours.read_bytes() == theirs.read_bytes()
    assert len(ours.read_bytes()) == 96 * 64 * 3 // 2


def _skill_lines():
    """The ``python -m dryv_tpu`` command lines of the verify notes."""
    skill = Path(__file__).resolve().parent.parent / ".claude" / \
        "skills" / "verify" / "SKILL.md"
    return [shlex.split(m, comments=True) for m in re.findall(
        r"^python -m dryv_tpu (.*)$", skill.read_text(), re.M)]


def test_jax_command_lines_parse_on_the_port(monkeypatch):
    """Every ``python -m dryv_tpu`` line of the verify notes parses on the
    port's CLI, to the same output, frames, seek, debug and stats
    settings and the same backend ("jax" being the port's "torch")."""
    parse = argparse.ArgumentParser.parse_args

    class Parsed(Exception):
        pass

    def stop(self, args=None, namespace=None):
        raise Parsed(parse(self, args, namespace))

    lines = _skill_lines()
    assert len(lines) >= 3 and any("jax" in a for a in lines)
    for argv in lines + [["f.mp4", "-d", "-s", "50%", "--frames", "3"]]:
        ours = cli.parser().parse_args(argv)
        # the JAX CLI's main parses, then decodes: stop it at the parse
        with monkeypatch.context() as m:
            m.setattr(argparse.ArgumentParser, "parse_args", stop)
            with pytest.raises(Parsed) as e:
                jax_cli.main(argv)
        theirs = e.value.args[0]
        for k in ("filepath", "output", "frames", "seek", "debug", "stats"):
            assert getattr(ours, k) == getattr(theirs, k), (argv, k)
        assert ours.backend.replace("jax", "torch") == \
            theirs.backend.replace("jax", "torch"), argv


@pytest.mark.parametrize("text", ["12s", "1500ms", "50%", "1234ts", " 7s ",
                                  "0.5s", "abc", "", "ms", "12", "-3%",
                                  "1e3ms", "s%"])
def test_seek_position_parses_as_the_jax_one(text):
    ours, theirs = SeekPosition.parse(text), JaxSeekPosition.parse(text)
    assert (ours.kind, ours.value) == (theirs.kind, theirs.value)


def test_video_properties_equal_the_jax_facade(ipb_mp4):
    ours, theirs = TorchVideo.open(ipb_mp4[0]), Video.open(ipb_mp4[0])
    for k in ("width", "height", "duration_seconds", "rotation",
              "meta_tags"):
        assert getattr(ours, k) == getattr(theirs, k), k
    assert ours.info() == theirs.info()


def test_debug_writes_debug_log(ipb_mp4, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    root = logging.getLogger("dryv_tpu_torch")
    level, handlers = root.level, list(root.handlers)
    try:
        assert cli.main([str(ipb_mp4[0]), "-d", "-s", "1500ms", "-o",
                         "out.yuv", "--backend", "native"]) == 0
    finally:
        for h in root.handlers[len(handlers):]:
            h.close()
            root.removeHandler(h)
        root.setLevel(level)
    log = (tmp_path / "debug.log").read_text()
    assert "[dryv_tpu_torch.cli]" in log and "ipb.mp4" in log


@pytest.mark.parametrize("backend", ["device-ipb", "torch"])
def test_trace_writes_the_stages_as_profiler_ranges(backend, ipb_mp4,
                                                    tmp_path, capsys):
    """--trace DIR writes a torch.profiler trace of the decode holding
    its dryv.<stage> ranges; --stats prints the stages and the counters
    of the path that decoded (the torch backend's batched pipeline hands
    this inter stream on whole, under its fallback stage)."""
    import json

    out, trace = tmp_path / "out.yuv", tmp_path / "trace"
    assert cli.main([str(ipb_mp4[0]), "-o", str(out), "--frames", "0",
                     "--device", "cpu", "--backend", backend, "--stats",
                     "--trace", str(trace)]) == 0
    text = capsys.readouterr().out
    stats = json.loads(text.split("stats: ", 1)[1].splitlines()[0])
    assert f"trace: {trace / 'trace.json'}" in text
    events = json.loads((trace / "trace.json").read_text())["traceEvents"]
    ranges = {e["name"][len("dryv."):] for e in events
              if e.get("name", "").startswith("dryv.")}
    assert ranges == set(stats["stages"])
    if backend == "device-ipb":
        assert {"split", "entropy", "pack", "dispatch", "dpb"} <= ranges
        assert stats["counters"]["frames"] == 3
        assert stats["counters"]["bins"] > 0 and stats["bins_per_s"] > 0
        assert stats["counters"]["wire_bytes"] > 0
        assert stats["counters"]["epb_bytes"] >= 0
    else:
        assert ranges == {"demux", "parse", "fallback"}
