"""Encode the pool of a live-stream configuration and write it into the
configuration's folder, with each stream's SHA-256, x264 options and
slice QPs in its ``config.json``.

    python avcbench/tools/encode_live.py \
        avcbench/configs/x264-baseline-live-1080p

The recipe is a 1080p30 live stream as a WebRTC sender or an IP camera
sends it: libx264 (core 164) through the system libavcodec at ``--preset
medium``, single-threaded, 30 pictures a second, then the Constrained
Baseline profile as ``x264_param_apply_profile`` sets it (no CABAC, no
8x8 transform, no B pictures, no weighted prediction, flat scaling
lists), ``--tune zerolatency`` (no lookahead, no macroblock-tree) and CBR
at 4000 kbps with a one-second VBV buffer.  The source is ``scene``: a
slowly panned low-amplitude texture with objects moving across it.  Then
run ``goldens.py`` and ``kernel_work.py`` on the folder.  The tool runs
only where libx264 is installed; the benchmark never imports it.
``tiny`` writes the same recipe's small streams for the tests.
"""
from __future__ import annotations

import ctypes as ct
import json
import os
import statistics
import subprocess
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from avcbench.streams import sha256  # noqa: E402
from avcbench.tools import libav  # noqa: E402

W, H, FPS = 1920, 1080, 30
BASELINE = "cabac=0:8x8dct=0:bframes=0:weightp=0:cqm=flat"
ZEROLATENCY = "rc-lookahead=0:sync-lookahead=0:mbtree=0"
CBR = "bitrate=4000:vbv-maxrate=4000:vbv-bufsize=4000"
PARAMS = ":".join((BASELINE, ZEROLATENCY, CBR))
# (file, seed, pictures): each stream one 16-picture clip, IDR then P
POOL = [(f"live_s{s}.264", s, 16) for s in (21, 22, 23)]


def _smooth(rng, h, w, terms=4):
    """A sum of low-frequency cosines in [0, 1]."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    f = np.zeros((h, w))
    for _ in range(terms):
        fy, fx = rng.uniform(0.5, 3.0, 2) * 2 * np.pi / np.array([h, w])
        f += np.cos(fy * yy + fx * xx + rng.uniform(0, 2 * np.pi))
    return (f - f.min()) / (f.max() - f.min() + 1e-9)


def _texture(rng, h, w, amp):
    """Low-amplitude texture: uniform noise blurred over 2x2 samples."""
    t = rng.uniform(-1, 1, (h + 1, w + 1))
    return amp * (t[:-1, :-1] + t[1:, :-1] + t[:-1, 1:] + t[1:, 1:]) / 4


def scene(seed: int, n: int, width: int, height: int):
    """n pictures (y, cb, cr uint8, 4:2:0) of a seeded scene: a smooth
    textured background panned 2 luma samples right and 1 down a picture,
    and four textured ellipses crossing it at 3-9 samples a picture."""
    rng = np.random.RandomState(seed)
    mh, mw = height + 2 * n, width + 4 * n
    bg_y = 40 + 170 * _smooth(rng, mh, mw) + _texture(rng, mh, mw, 14)
    bg_c = [96 + 64 * _smooth(rng, mh // 2, mw // 2)
            + _texture(rng, mh // 2, mw // 2, 6) for _ in range(2)]
    objs = []
    for _ in range(4):
        ry, rx = rng.randint(height // 10, height // 4, 2)
        tex = _texture(rng, 2 * ry + 1, 2 * rx + 1, 20)
        objs.append(dict(
            r=(ry, rx), pos=rng.uniform(0, 1, 2) * (height, width),
            vel=rng.uniform(3, 9, 2) * rng.choice((-1, 1), 2),
            y=rng.uniform(30, 220) + tex, c=rng.uniform(60, 200, 2)))
    yy, xx = np.mgrid[0:height, 0:width]
    out = []
    for t in range(n):
        y = bg_y[t:t + height, 2 * t:2 * t + width].copy()
        cb, cr = (c[t // 2:t // 2 + height // 2, t:t + width // 2].copy()
                  for c in bg_c)
        for o in objs:
            cy, cx = o["pos"] + t * o["vel"]
            ry, rx = o["r"]
            y0, x0 = int(round(cy)) - ry, int(round(cx)) - rx
            inside = (((yy - y0 - ry) / ry) ** 2
                      + ((xx - x0 - rx) / rx) ** 2) <= 1
            sy, sx = np.nonzero(inside)
            y[sy, sx] = o["y"][sy - y0, sx - x0]
            ci = inside[::2, ::2]
            cb[ci], cr[ci] = o["c"]
        out.append(tuple(np.clip(np.rint(p), 0, 255).astype(np.uint8)
                         for p in (y, cb, cr)))
    return out


def encode(frames, params: str = PARAMS) -> bytes:
    """libx264 at --preset medium, one thread, FPS pictures a second,
    `params` handed to x264_param_parse (``libav.encode_x264`` with the
    time base of a 30 fps source)."""
    with tempfile.TemporaryDirectory() as td:
        src, dst = os.path.join(td, "src.npz"), os.path.join(td, "out.264")
        np.savez(src, y=np.stack([f[0] for f in frames]),
                 cb=np.stack([f[1] for f in frames]),
                 cr=np.stack([f[2] for f in frames]))
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "encode", src, dst, params],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"x264 encode failed:\n{r.stdout}{r.stderr}")
        return open(dst, "rb").read()


def _encode_here(src: str, dst: str, params: str) -> None:
    """As ``libav._encode_here``, at a time base of 1/FPS.  That one
    fixes 1/25, and an x264 ``fps=30`` does not stand in for it: x264's
    rate control spends the bits by the timestamps, so the 300-kbps
    seed-1 stream comes out at 15523 bytes instead of 13475."""
    lib = libav.SYSTEM_LIBS
    av = ct.CDLL(os.path.join(lib, "libavcodec.so.59"))
    avu = ct.CDLL(os.path.join(lib, "libavutil.so.57"))
    av.avcodec_find_encoder_by_name.restype = ct.c_void_p
    av.avcodec_alloc_context3.restype = ct.c_void_p
    av.avcodec_alloc_context3.argtypes = [ct.c_void_p]
    av.avcodec_open2.argtypes = [ct.c_void_p, ct.c_void_p, ct.c_void_p]
    av.avcodec_send_frame.argtypes = [ct.c_void_p, ct.c_void_p]
    av.avcodec_receive_packet.argtypes = [ct.c_void_p,
                                          ct.POINTER(libav._Packet)]
    av.av_packet_alloc.restype = ct.POINTER(libav._Packet)
    av.av_packet_unref.argtypes = [ct.POINTER(libav._Packet)]
    avu.av_frame_alloc.restype = ct.POINTER(libav._Frame)
    avu.av_frame_get_buffer.argtypes = [ct.POINTER(libav._Frame), ct.c_int]
    avu.av_frame_make_writable.argtypes = [ct.POINTER(libav._Frame)]
    avu.av_opt_set.argtypes = [ct.c_void_p, ct.c_char_p, ct.c_char_p,
                               ct.c_int]
    avu.av_opt_set_image_size.argtypes = [ct.c_void_p, ct.c_char_p,
                                          ct.c_int, ct.c_int, ct.c_int]
    avu.av_opt_set_pixel_fmt.argtypes = [ct.c_void_p, ct.c_char_p,
                                         ct.c_int, ct.c_int]
    children = 1                        # AV_OPT_SEARCH_CHILDREN

    data = np.load(src)
    planes = [data["y"], data["cb"], data["cr"]]
    n, h, w = planes[0].shape
    codec = av.avcodec_find_encoder_by_name(b"libx264")
    assert codec, "the system libavcodec lacks libx264"
    ctx = ct.c_void_p(av.avcodec_alloc_context3(ct.c_void_p(codec)))
    assert avu.av_opt_set_image_size(ctx, b"video_size", w, h,
                                     children) == 0
    assert avu.av_opt_set_pixel_fmt(ctx, b"pixel_format", libav.YUV420P,
                                    children) == 0
    for k, v in (("time_base", f"1/{FPS}"), ("preset", "medium"),
                 ("threads", "1"), ("x264-params", params)):
        assert avu.av_opt_set(ctx, k.encode(), v.encode(), children) == 0
    assert av.avcodec_open2(ctx, ct.c_void_p(codec), None) == 0

    frame = avu.av_frame_alloc()
    f = frame.contents
    f.width, f.height, f.format = w, h, libav.YUV420P
    assert avu.av_frame_get_buffer(frame, 0) == 0
    pkt = av.av_packet_alloc()
    out = bytearray()

    def drain():
        while True:
            rc = av.avcodec_receive_packet(ctx, pkt)
            if rc in (libav.EAGAIN, libav.EOF):
                return
            assert rc == 0, f"receive_packet: {rc}"
            out.extend(ct.string_at(pkt.contents.data, pkt.contents.size))
            av.av_packet_unref(pkt)

    for i in range(n):
        assert avu.av_frame_make_writable(frame) == 0
        f = frame.contents
        for k, plane in enumerate(planes):
            arr = np.ascontiguousarray(plane[i], dtype=np.uint8)
            base = ct.addressof(f.data[k].contents)
            for row in range(arr.shape[0]):
                ct.memmove(base + row * f.linesize[k], arr[row].ctypes.data,
                           arr.shape[1])
        f.pts = i
        assert av.avcodec_send_frame(ctx, frame) == 0
        drain()
    assert av.avcodec_send_frame(ctx, None) == 0       # flush
    drain()
    with open(dst, "wb") as fh:
        fh.write(bytes(out))


def pictures(stream: bytes) -> list:
    """(slice type, QP, bytes) of each slice, in stream order:
    the slice headers as the H.264 syntax gives them (the port's parser;
    a sandbox tool may import it)."""
    from dryv_tpu_torch.avc import split_annexb
    from dryv_tpu_torch.avc.slice_header import SliceHeader
    from dryv_tpu_torch.decoder import SyntaxDecoder, group_access_units

    sd = SyntaxDecoder()
    rest = sd.feed_parameter_sets(list(split_annexb(stream)))
    out = []
    for unit in group_access_units(rest):
        for nal in unit:
            pps = next(iter(sd.pps_map.values()))
            sps = sd.sps_map[pps.seq_parameter_set_id]
            h = SliceHeader.parse(nal.rbsp, nal, sps, pps)
            out.append((h.slice_type.name, h.slice_qp_y(pps),
                        len(nal.payload) + 5))
    return out


def profile(stream: bytes) -> dict:
    """profile_idc and constraint_set0/1 of the stream's SPS: Constrained
    Baseline is 66 with both set."""
    from avcbench.streams import SPS, nal_type, nal_units

    sps = next(n for n in nal_units(stream) if nal_type(n) == SPS)
    return {"profile_idc": sps[1], "constraint_set0": sps[2] >> 7,
            "constraint_set1": (sps[2] >> 6) & 1}


def main(folder):
    path = os.path.join(folder, "config.json")
    cfg = json.load(open(path))
    pool, opts, qps = [], set(), {}
    for fname, seed, n in POOL:
        data = encode(scene(seed, n, W, H))
        open(os.path.join(folder, fname), "wb").write(data)
        opts.add(libav.options(data))
        pics = pictures(data)
        if len(pics) != n or pics[0][0] != "I" or any(
                t != "P" for t, *_ in pics[1:]):
            raise SystemExit(f"{fname}: not one IDR then {n - 1} P "
                             f"pictures of one slice: {pics}")
        qps[fname] = pics
        pool.append({"file": fname, "sha256": sha256(data), "pictures": n,
                     "bytes": len(data),
                     "slice_qp": [q for _, q, _ in pics],
                     "picture_bytes": [b for *_, b in pics],
                     "made_by": f"avcbench/tools/encode_live.py: scene, "
                                f"seed {seed}"})
        print(fname, len(data), [q for _, q, _ in pics], flush=True)
    if len(opts) != 1:
        raise SystemExit(f"the pool's x264 options differ: {opts}")
    p_qp = [q for pics in qps.values() for t, q, _ in pics if t == "P"]
    cfg["x264_options"] = opts.pop()
    cfg["sps"] = profile(open(os.path.join(folder, POOL[0][0]), "rb").read())
    cfg["pool"] = pool
    cfg["measured"] = {
        "pool_bytes": sum(p["bytes"] for p in pool),
        "p_slice_qp_median": statistics.median(p_qp),
        "p_slice_qp_range": [min(p_qp), max(p_qp)],
        "idr_slice_qp": [pics[0][1] for pics in qps.values()],
        "idr_bytes": [pics[0][2] for pics in qps.values()],
        "p_picture_bytes_median": statistics.median(
            b for pics in qps.values() for t, _, b in pics if t == "P")}
    with open(path, "w") as f:
        json.dump(cfg, f, indent=1)
        f.write("\n")


def tiny(folder, width=320, height=192, n=8, kbps=300):
    """The recipe's small streams and their configuration, for the tests:
    `n` pictures at width x height and `kbps` (the 1080p pool's slice QPs,
    25-33), seeds 1-3; and seed 4 in 4 slices a picture, as a sliced-
    threads encoder writes it (not in the pool)."""
    rate = f"bitrate={kbps}:vbv-maxrate={kbps}:vbv-bufsize={kbps}"
    params = ":".join((BASELINE, ZEROLATENCY, rate))
    pool = []
    for fname, seed, extra in [(f"live_s{s}.264", s, "") for s in (1, 2, 3)
                               ] + [("live_slices4_s4.264", 4, ":slices=4")]:
        data = encode(scene(seed, n, width, height), params + extra)
        open(os.path.join(folder, fname), "wb").write(data)
        print(fname, len(data), [q for _, q, _ in pictures(data)])
        if not extra:
            pool.append({"file": fname, "sha256": sha256(data),
                         "pictures": n})
    with open(os.path.join(folder, "config.json"), "w") as f:
        json.dump({"name": os.path.basename(os.path.normpath(folder)),
                   "width": width, "height": height, "pool": pool}, f,
                  indent=1)
        f.write("\n")


if __name__ == "__main__" and sys.argv[1:2] == ["encode"]:
    _encode_here(sys.argv[2], sys.argv[3], sys.argv[4])
elif __name__ == "__main__" and sys.argv[1:2] == ["tiny"]:
    tiny(sys.argv[2])
elif __name__ == "__main__":
    for folder in sys.argv[1:]:
        main(folder)
