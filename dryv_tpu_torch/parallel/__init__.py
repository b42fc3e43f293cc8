"""Multi-device decode of the port (counterpart of ``dryv_tpu/parallel``):
a mesh of torch devices driven by one process, frame-parallel GOP decode
over its "gop" axis, band-parallel intra reconstruction with halo
exchange (kernel B2b) over its "band" axis, and banded P recon
(reference-row aprons between bands, kernel B4)."""
from __future__ import annotations

import numpy as np

from .bands import (make_banded_frame_fn, make_banded_gop_fn,
                    make_banded_p_recon_fn, make_banded_wavefront_fn)
from .gop import decode_gop_sharded
from .mesh import Mesh, make_mesh

__all__ = ["Mesh", "make_mesh", "decode_gop_sharded", "make_banded_frame_fn",
           "make_banded_wavefront_fn", "make_banded_gop_fn",
           "make_banded_p_recon_fn", "dryrun_multichip"]


def _tiny_stream(n_pics: int = 2) -> bytes:
    """Small all-intra CABAC pictures from the repo's own encoder: 4x4
    MBs, I16/I4/PCM, one slice per MB row, in-loop filter off (the
    geometry of the ``slices_qp28`` fixture, without its oracle)."""
    from ..encoder import default_sps_pps, encode_frame_annexb
    from ..encoder.intra_encoder import IntraEncoder
    from ..testing.sources import POLICIES, make_source

    sps, pps = default_sps_pps(4, 4, qp=28)
    out = b""
    for t in range(n_pics):
        enc = IntraEncoder(sps, pps, 28, mb_kind_policy=POLICIES["mix"])
        mbs = enc.encode_frame(*make_source(4, 4, seed=42 + t),
                               slice_bounds=list(range(0, 16, 4)))
        out += encode_frame_annexb(sps, pps, 1, mbs, deblock_disable=1)
    return out


def dryrun_multichip(n_devices: int, devices=None, stream: bytes = None,
                     n_threads: int = 0) -> dict:
    """The sharded decode on an n-device mesh, checked value by value.

    Counterpart of ``__graft_entry__.py`` ``dryrun_multichip`` :40-107:
    n factors into gop x band as there; the stream's pictures (default:
    ``_tiny_stream``) decode frame-parallel over the "gop" axis, band-
    sharded over the "band" axis, and over the 2-D mesh, and every frame
    of each must equal ``dryv_tpu.native.full.decode_annexb_native``
    (the original checks shapes only).  `devices` as for ``make_mesh``,
    which may repeat one device.  Raises on any difference; returns
    {"gop", "band", "frames"}."""
    from ..decoder import DecodedFrame
    from ..native.full import decode_annexb_native

    from ..pipeline import frames_from_stream

    stream = _tiny_stream() if stream is None else stream
    frames, sps = frames_from_stream(stream, n_threads=n_threads)
    ref = decode_annexb_native(stream, n_threads=n_threads)
    mb_w, mb_h = frames[0].mb_w, frames[0].mb_h
    band = next(c for c in (4, 2, 1) if n_devices % c == 0 and c <= mb_h)
    gop = n_devices // band

    def check(label, planes):
        if len(planes) != len(ref):
            raise RuntimeError(f"dryrun_multichip: {label} decoded "
                               f"{len(planes)} of {len(ref)} frames")
        for i, (p, r) in enumerate(zip(planes, ref)):
            f = DecodedFrame(*p).crop(sps)
            if not all(np.array_equal(a, b) for a, b in
                       zip((f.y, f.cb, f.cr), (r.y, r.cb, r.cr))):
                raise RuntimeError(f"dryrun_multichip: {label} frame {i} "
                                   f"differs from the native decode")

    if gop > 1:
        ys, cbs, crs = decode_gop_sharded(
            frames, make_mesh({"gop": gop}, devices))
        check("gop", list(zip(ys, cbs, crs)))
    if band > 1:
        fn = make_banded_frame_fn(make_mesh({"band": band}, devices),
                                  mb_w, mb_h)
        check("band", [fn(fs) for fs in frames])
    if gop > 1 and band > 1:
        fn = make_banded_frame_fn(
            make_mesh({"gop": gop, "band": band}, devices), mb_w, mb_h)
        check("gop x band", [fn(fs) for fs in frames])
    print(f"dryrun_multichip ok: {n_devices} devices (gop={gop}, "
          f"band={band}), {len(frames)} frames equal to the native decode")
    return {"gop": gop, "band": band, "frames": len(frames)}
