"""libavcodec through ctypes, for the sandbox tools that make the pools:
the synthetic source pictures, an x264 encode, and the reference decode
whose digests decide ``correct``.  Plain numpy and ctypes; nothing of
the program or of the JAX package is imported.

- ``encode_x264`` drives libx264 (core 164) through the system
  libavcodec (``/usr/lib/x86_64-linux-gnu``, ffmpeg 5.1) in a subprocess
  of this file, since the decoder below loads another libavcodec (the one
  in OpenCV's wheel) with RTLD_GLOBAL and the two may not share a process.
- ``decode_annexb`` decodes an Annex B stream with OpenCV's bundled
  libavcodec, one access unit a packet.

The benchmark never imports this file; it runs only where cv2 and libx264
are installed.
"""
from __future__ import annotations

import ctypes as ct
import glob
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

SYSTEM_LIBS = "/usr/lib/x86_64-linux-gnu"
YUV420P = 0
AV_CODEC_ID_H264 = 27
EAGAIN, EOF = -11, -0x20464F45       # AVERROR(EAGAIN), AVERROR_EOF


def make_source(mb_w: int, mb_h: int, seed: int):
    """A random-textured gradient of mb_w x mb_h MBs (Y, Cb, Cr int64)."""
    rng = np.random.RandomState(seed)
    W, H = mb_w * 16, mb_h * 16
    yy = np.clip(rng.randint(0, 256, (H, W)).astype(np.float64) * 0.3 +
                 np.linspace(0, 200, W)[None, :] +
                 np.linspace(0, 40, H)[:, None], 0, 255).astype(np.int64)
    cb = np.clip(rng.randint(0, 256, (H // 2, W // 2)) * 0.25 + 100,
                 0, 255).astype(np.int64)
    cr = np.clip(rng.randint(0, 256, (H // 2, W // 2)) * 0.25 + 80,
                 0, 255).astype(np.int64)
    return yy, cb, cr


def panned(seed: int, n: int, width: int, height: int):
    """n pictures of one source panned 5 luma (2 chroma) samples a
    picture, cropped to width x height."""
    y, cb, cr = make_source(width // 16, (height + 15) // 16, seed)
    return [(np.roll(y, 5 * t, axis=1)[:height].astype(np.uint8),
             np.roll(cb, 2 * t, axis=1)[:height // 2].astype(np.uint8),
             np.roll(cr, 2 * t, axis=1)[:height // 2].astype(np.uint8))
            for t in range(n)]


def stills(seed: int, n: int, width: int, height: int):
    """n unrelated pictures, the sources of seeds seed .. seed + n - 1."""
    return [panned(seed + t, 1, width, height)[0] for t in range(n)]


def options(stream: bytes) -> str:
    """The option list of the stream's x264 SEI."""
    i = stream.find(b"options: ")
    return stream[i + 9:stream.index(b"\x00", i)].decode()


# ---------------------------------------------------------------------------
# encode (system libavcodec, in a subprocess)
# ---------------------------------------------------------------------------

def encode_x264(frames, x264_params: str = "", preset: str = "medium"
                ) -> bytes:
    """Encode (y, cb, cr) uint8 4:2:0 pictures to an Annex B stream with
    libx264 at `preset`, single-threaded (so that the output is the same
    on every host), `x264_params` handed to x264_param_parse."""
    with tempfile.TemporaryDirectory() as td:
        src, dst = os.path.join(td, "src.npz"), os.path.join(td, "out.264")
        np.savez(src, y=np.stack([f[0] for f in frames]),
                 cb=np.stack([f[1] for f in frames]),
                 cr=np.stack([f[2] for f in frames]))
        spec = {"preset": preset, "x264_params": x264_params}
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "encode", src, dst, json.dumps(spec)],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"x264 encode failed:\n{r.stdout}{r.stderr}")
        return open(dst, "rb").read()


class _Frame(ct.Structure):
    # the leading fields of AVFrame (libavutil 57), through pts
    _fields_ = [("data", ct.POINTER(ct.c_uint8) * 8),
                ("linesize", ct.c_int * 8),
                ("extended_data", ct.c_void_p),
                ("width", ct.c_int), ("height", ct.c_int),
                ("nb_samples", ct.c_int), ("format", ct.c_int),
                ("key_frame", ct.c_int), ("pict_type", ct.c_int),
                ("sar_num", ct.c_int), ("sar_den", ct.c_int),
                ("pts", ct.c_int64)]


class _Packet(ct.Structure):
    # the leading fields of AVPacket
    _fields_ = [("buf", ct.c_void_p), ("pts", ct.c_int64),
                ("dts", ct.c_int64), ("data", ct.POINTER(ct.c_uint8)),
                ("size", ct.c_int)]


def _encode_here(src: str, dst: str, spec: dict) -> None:
    av = ct.CDLL(os.path.join(SYSTEM_LIBS, "libavcodec.so.59"))
    avu = ct.CDLL(os.path.join(SYSTEM_LIBS, "libavutil.so.57"))
    av.avcodec_find_encoder_by_name.restype = ct.c_void_p
    av.avcodec_alloc_context3.restype = ct.c_void_p
    av.avcodec_alloc_context3.argtypes = [ct.c_void_p]
    av.avcodec_open2.argtypes = [ct.c_void_p, ct.c_void_p, ct.c_void_p]
    av.avcodec_send_frame.argtypes = [ct.c_void_p, ct.c_void_p]
    av.avcodec_receive_packet.argtypes = [ct.c_void_p, ct.POINTER(_Packet)]
    av.av_packet_alloc.restype = ct.POINTER(_Packet)
    av.av_packet_unref.argtypes = [ct.POINTER(_Packet)]
    avu.av_frame_alloc.restype = ct.POINTER(_Frame)
    avu.av_frame_get_buffer.argtypes = [ct.POINTER(_Frame), ct.c_int]
    avu.av_frame_make_writable.argtypes = [ct.POINTER(_Frame)]
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
    assert ctx
    assert avu.av_opt_set_image_size(ctx, b"video_size", w, h,
                                     children) == 0
    assert avu.av_opt_set_pixel_fmt(ctx, b"pixel_format", YUV420P,
                                    children) == 0
    for k, v in (("time_base", "1/25"), ("preset", spec["preset"]),
                 ("threads", "1")):
        assert avu.av_opt_set(ctx, k.encode(), v.encode(), children) == 0
    if spec["x264_params"]:
        assert avu.av_opt_set(ctx, b"x264-params",
                              spec["x264_params"].encode(), children) == 0
    rc = av.avcodec_open2(ctx, ct.c_void_p(codec), None)
    assert rc == 0, f"avcodec_open2: {rc}"

    frame = avu.av_frame_alloc()
    f = frame.contents
    f.width, f.height, f.format = w, h, YUV420P
    assert avu.av_frame_get_buffer(frame, 0) == 0
    pkt = av.av_packet_alloc()
    out = bytearray()

    def drain():
        while True:
            rc = av.avcodec_receive_packet(ctx, pkt)
            if rc in (EAGAIN, EOF):
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


# ---------------------------------------------------------------------------
# decode (OpenCV's bundled libavcodec, in this process)
# ---------------------------------------------------------------------------

def _wheel_lib(stub: str) -> str:
    import cv2
    libs = os.path.join(os.path.dirname(os.path.dirname(cv2.__file__)),
                        "opencv_python.libs")
    hits = glob.glob(os.path.join(libs, f"lib{stub}-*.so*"))
    if not hits:
        raise FileNotFoundError(f"lib{stub} not found under {libs}")
    return hits[0]


_DECODER = []


def _decoder_libs():
    if not _DECODER:
        avu = ct.CDLL(_wheel_lib("avutil"), mode=ct.RTLD_GLOBAL)
        av = ct.CDLL(_wheel_lib("avcodec"), mode=ct.RTLD_GLOBAL)
        av.avcodec_find_decoder.restype = ct.c_void_p
        av.avcodec_alloc_context3.restype = ct.c_void_p
        av.avcodec_alloc_context3.argtypes = [ct.c_void_p]
        av.avcodec_open2.argtypes = [ct.c_void_p, ct.c_void_p, ct.c_void_p]
        av.av_packet_alloc.restype = ct.POINTER(_Packet)
        av.avcodec_send_packet.argtypes = [ct.c_void_p, ct.c_void_p]
        av.avcodec_receive_frame.argtypes = [ct.c_void_p,
                                             ct.POINTER(_Frame)]
        avu.av_frame_alloc.restype = ct.POINTER(_Frame)
        _DECODER[:] = [av, avu]
    return _DECODER


def access_units(stream: bytes) -> list:
    """The stream cut into access units: a slice NAL unit whose
    first_mb_in_slice is 0 starts a new one once the current one holds a
    slice; other NAL units stay with the unit before them."""
    from avcbench.streams import IDR, SLICE, first_mb, join, nal_units

    units, cur = [], []
    for nal in nal_units(stream):
        vcl = (nal[0] & 0x1F) in (SLICE, IDR)
        if vcl and first_mb(nal) == 0 and any(
                (n[0] & 0x1F) in (SLICE, IDR) for n in cur):
            units.append(join(cur))
            cur = []
        cur.append(nal)
    if cur:
        units.append(join(cur))
    return units


def decode_annexb(stream: bytes) -> list:
    """[(y, cb, cr)] uint8 cropped planes of every 4:2:0 picture of the
    stream, in output (display) order."""
    av, avu = _decoder_libs()
    codec = av.avcodec_find_decoder(AV_CODEC_ID_H264)
    assert codec, "libavcodec lacks the H.264 decoder"
    ctx = ct.c_void_p(av.avcodec_alloc_context3(ct.c_void_p(codec)))
    assert av.avcodec_open2(ctx, ct.c_void_p(codec), None) == 0
    pkt = av.av_packet_alloc()
    frame = avu.av_frame_alloc()
    pictures, keep = [], []

    def drain():
        while True:
            rc = av.avcodec_receive_frame(ctx, frame)
            if rc in (EAGAIN, EOF):
                return
            assert rc == 0, f"receive_frame: {rc}"
            f = frame.contents
            assert f.format in (0, 12), f"not 4:2:0: format {f.format}"

            def plane(i, pw, ph):
                ls = f.linesize[i]
                buf = ct.cast(f.data[i],
                              ct.POINTER(ct.c_uint8 * (ls * ph))).contents
                return np.frombuffer(buf, np.uint8).reshape(
                    ph, ls)[:, :pw].copy()

            cw, chh = (f.width + 1) // 2, (f.height + 1) // 2
            pictures.append((plane(0, f.width, f.height),
                             plane(1, cw, chh), plane(2, cw, chh)))

    for unit in access_units(stream):
        buf = ct.create_string_buffer(unit, len(unit))
        keep.append(buf)
        pkt.contents.data = ct.cast(buf, ct.POINTER(ct.c_uint8))
        pkt.contents.size = len(unit)
        rc = av.avcodec_send_packet(ctx, pkt)
        assert rc == 0, f"send_packet: {rc}"
        drain()
    av.avcodec_send_packet(ctx, None)                  # flush
    drain()
    return pictures


if __name__ == "__main__" and sys.argv[1:2] == ["encode"]:
    _encode_here(sys.argv[2], sys.argv[3], json.loads(sys.argv[4]))
