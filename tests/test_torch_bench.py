"""The port's benchmark entry point (``dryv_tpu_torch.bench``) and its
oracle digests (``dryv_tpu_torch.testing.goldens``) on the CPU: the stored
digests against the libavcodec oracle, ``goldens.check`` on the native
C++ decode and on an altered picture, every phase on small encoder-made
streams with the kernels' plain versions, the gates, the command without
CUDA, and the HBM share's base."""
import json
import os
import subprocess
import sys
from functools import lru_cache
from pathlib import Path

import numpy as np
import pytest
import torch

from dryv_tpu.testing.oracle import decode_annexb
from dryv_tpu_torch import bench
from dryv_tpu_torch.testing import goldens

ROOT = Path(__file__).resolve().parent.parent
BENCHDATA = ROOT / "benchdata"
R05_DETAIL = json.loads((ROOT / "BENCH_r05.json").read_text())[
    "parsed"]["detail"]


@pytest.mark.parametrize("name", ["bench1080p_gop16.264",
                                  "bench1080p_ipb.264"])
def test_stored_digests_equal_the_oracle(name):
    ref = decode_annexb((BENCHDATA / name).read_bytes())
    assert len(goldens.stored(name)) == len(ref) == {
        "bench1080p_gop16.264": 16, "bench1080p_ipb.264": 10}[name]
    assert goldens.stored(name) == [goldens.digest(*f) for f in ref]


@lru_cache(maxsize=None)
def _native_gop16():
    from dryv_tpu_torch.native.full import decode_annexb_native

    s = (BENCHDATA / "bench1080p_gop16.264").read_bytes()
    return [(f.y, f.cb, f.cr) for f in decode_annexb_native(s, n_threads=2)]


@pytest.mark.parametrize("pic,plane", [(0, "y"), (7, "cb"), (15, "cr")])
def test_check_passes_the_native_decode_and_names_an_altered_byte(pic,
                                                                  plane):
    frames = _native_gop16()
    goldens.check("bench1080p_gop16.264", frames)
    bad = [list(f) for f in frames]
    k = ("y", "cb", "cr").index(plane)
    bad[pic][k] = bad[pic][k].copy()
    bad[pic][k][5, 9] ^= 1
    with pytest.raises(AssertionError,
                       match=f"picture {pic} plane {plane} differs"):
        goldens.check("bench1080p_gop16.264", bad)
    with pytest.raises(AssertionError, match="15 pictures"):
        goldens.check("bench1080p_gop16.264", frames[:15])


def test_digest_covers_the_shape_and_takes_tensors():
    y = np.arange(64, dtype=np.uint8).reshape(8, 8)
    c = np.zeros((4, 4), np.uint8)
    d = goldens.digest(y, c, c)
    assert d == goldens.digest(torch.from_numpy(y), c, c)
    assert d["y"] != goldens.digest(y.reshape(4, 16), c, c)["y"]


# ---- the phases on the CPU, at a small size --------------------------------

def _intra(n_pics, deblock, qp=30, mb_w=4, mb_h=3):
    """Encoder-made CABAC intra pictures (I4/I8/I16, two slices, 8x8
    transform) of 64x48, cropped to 64x40."""
    from dryv_tpu_torch.encoder import default_sps_pps, encode_frame_annexb
    from dryv_tpu_torch.encoder.intra_encoder import IntraEncoder
    from dryv_tpu_torch.testing.sources import POLICIES, make_source

    out = b""
    for t in range(n_pics):
        sps, pps = default_sps_pps(mb_w, mb_h, qp=qp, transform_8x8=True,
                                   chroma_qp_offset=2, crop=(0, 0, 0, 4))
        enc = IntraEncoder(sps, pps, qp, mb_kind_policy=lambda a, t=t:
                           POLICIES["mix48"](a + t) if a % 3 else "i16")
        mbs = enc.encode_frame(*make_source(mb_w, mb_h, seed=t),
                               slice_bounds=[0, 2 * mb_w])
        out += encode_frame_annexb(sps, pps, 2, mbs,
                                   deblock_disable=0 if deblock else 1)
    return out


@lru_cache(maxsize=None)
def _inputs():
    from test_torch_import import _ipb_stream

    intra = _intra(1, False)
    dblk = _intra(1, True, qp=36)
    gop = _intra(4, False)
    ipb = _ipb_stream()
    digests = {k: [goldens.digest(*f) for f in decode_annexb(s)]
               for k, s in (("gop", gop), ("ipb", ipb))}
    return bench.Inputs(intra, decode_annexb(intra)[0], dblk,
                        decode_annexb(dblk)[0], gop, "gop.264",
                        digests["gop"], ipb, decode_annexb(ipb), ipb,
                        "ipb.264", digests["ipb"], {20: intra, 40: dblk})


def test_phases_on_cpu_assemble_every_detail_key():
    logged = []
    r = bench.measure(_inputs(), "cpu", "cpu", F=2, n_threads=1, copies=2,
                      runs=5, log=logged.append)
    assert r["metric"] == "1080p_avc_intra_frames_per_sec_per_chip"
    assert r["unit"] == "frames/s"
    d = r["detail"]
    assert set(R05_DETAIL) <= set(d)
    for k in ("runs", "min", "max", "best", "stage_sum_over_wall",
              "device_hbm_bytes_per_frame"):
        assert k in d
    assert d["bit_exact"] is True and d["device"] == "cpu"
    assert d["runs"] == 5 and d["gop_batch"] == 2
    assert d["min"] <= r["value"] <= d["max"] and d["best"] <= d["max"]
    assert r["vs_baseline"] == pytest.approx(
        r["value"] / d["baseline_cpu_singlethread_fps"])
    assert set(d["e2e_stage_ms_per_frame"]) >= {"parse", "entropy", "ship",
                                                "dispatch"}
    assert set(d["entropy_qp_sweep"]) == {"qp20_entropy_ms",
                                          "qp40_entropy_ms"}
    assert d["ipb_1080p_device_fps"] > 0
    # the bytes: the blob's share of 2 pictures and 64x48 + 2 x 32x24
    assert d["device_hbm_bytes_per_frame"] > 64 * 48 * 3 // 2
    assert 0 < d["device_hbm_utilization"] <= 1
    json.dumps(r)
    assert len(logged) == 3


def test_device_recon_gates_and_counts_nothing_on_the_cpu():
    inp = _inputs()
    before = bench.launches()
    r = bench.device_recon(inp.dblk, inp.dblk_golden, 3, 2, 1, "cpu",
                           rounds=1)
    assert r["deblocked"] and r["s_per_gop"] > 0
    assert r["launches"] == dict.fromkeys(before, 0)
    assert bench.launches() == before
    wrong = tuple(p.copy() for p in inp.dblk_golden)
    wrong[1][3, 4] ^= 1
    with pytest.raises(AssertionError, match="picture 0 plane cb"):
        bench.device_recon(inp.dblk, wrong, 3, 2, 1, "cpu", rounds=1)


@pytest.mark.parametrize("rows,want", [
    ("GPU-AAAA-01, 500.00 W\nGPU-bbbb-02, 700.00 W\n", "H100, 700.00 W"),
    ("GPU-aaaa-01, 500.00 W\n", None)])
def test_device_label_reads_the_limit_of_torchs_card(monkeypatch, rows,
                                                     want):
    """The limit is that of the card torch calls 0, found by its UUID
    among every card ``nvidia-smi`` lists; no such card fails."""
    from types import SimpleNamespace

    monkeypatch.setattr(subprocess, "run",
                        lambda *a, **k: SimpleNamespace(stdout=rows))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: SimpleNamespace(uuid="BBBB-02"))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i: "H100")
    if want is None:
        with pytest.raises(RuntimeError, match="no card of UUID"):
            bench.device_label()
    else:
        assert bench.device_label() == want


def test_a_timed_run_that_differs_fails(monkeypatch):
    inp = _inputs()
    calls = []
    real = bench.e2e_decode

    def e2e(stream, *a, **k):
        out = real(stream, *a, **k)
        calls.append(1)
        if len(calls) == 4:       # gated, warm, then the second timed run
            out[-1][1][0, 3, 3] ^= 1
        return out

    monkeypatch.setattr(bench, "e2e_decode", e2e)
    with pytest.raises(AssertionError, match="timed end-to-end run"):
        bench.end_to_end(inp.gop, "gop.264", inp.gop_digests, "cpu", 1,
                         copies=2, runs=3)


def test_e2e_gate_names_the_picture():
    inp = _inputs()
    d = [dict(x) for x in inp.gop_digests]
    d[2]["cr"] = "0" * 64
    with pytest.raises(AssertionError, match="gop.264: picture 2 plane cr"):
        bench.end_to_end(inp.gop, "gop.264", d, "cpu", 1, copies=1, runs=1)


def test_without_cuda_the_command_exits_nonzero_and_prints_no_value():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-m", "dryv_tpu_torch.bench"],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode != 0
    assert '"value"' not in r.stdout and not r.stdout.strip()
    assert "torch.cuda.is_available() is False" in r.stderr


def test_hbm_utilization_from_the_stated_bytes():
    b = bench.hbm_bytes_per_frame(1_000_000 * 32, 32, 120, 68)
    assert b == 1_000_000 + 1920 * 1088 + 2 * 960 * 544
    u = bench.hbm_utilization(b, 2.0)
    assert u == pytest.approx(b / 2e-3 / 3.35e12)
    assert 0 < u <= 1
    with pytest.raises(RuntimeError, match="outside"):
        bench.hbm_utilization(b, b / 3.35e12 * 1e3 / 2)
    with pytest.raises(RuntimeError, match="outside"):
        bench.hbm_utilization(0, 1.0)
