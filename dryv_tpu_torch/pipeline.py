"""Per-picture device path: FrameSyntax -> planes, one picture at a time.

Counterpart of ``dryv_tpu/pipeline.py``.  It reconstructs the intra
streams the batched pipeline (``gop_pipeline``) leaves out, CAVLC and
custom scaling matrices among them, and it is what
``TorchVideo.decode_frames`` runs without stage timers, as
``Video.decode_frames(backend="jax")`` does.  Per picture: the C++
entropy stage (``decode_annexb_fast``) or the Python one
(``decode_annexb_tpu``) makes a ``FrameSyntax``; on the device, stage A
(``kernels.transform``), kernel B2 with F = 1 and, for streams that
enable it, the edge parameters and kernel B3.  The JAX package's XLA
scan wavefront and deblock (``_build``) have no counterpart here: B2 and
B3 and their plain versions do that job.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .device import resolve_device
from .kernels.deblock import deblock, deblock_precompute, pack_params
from .kernels.geometry import LS4_FLAT, LS8_FLAT
from .kernels.transform import stage_a_residuals
from .kernels.wavefront import intra_recon, recon_inputs
from .syntax import stack_frames, syntax_tensors
from .tables import decoder_tables


def picture_supported(sps, pps, h) -> bool:
    """A slice the device reconstruction takes: intra, 4:2:0, frame,
    8-bit, no transform bypass, no slice groups (the test of
    ``dryv_tpu/pipeline.py`` :109-113)."""
    return (h.slice_type.is_intra and sps.chroma_array_type == 1
            and not h.field_pic_flag
            and not sps.qpprime_y_zero_transform_bypass_flag
            and not sps.bit_depth_luma_minus8
            and pps.slice_groups is None)


def _pictures(stream: bytes):
    """Yields (slice_datas, headers, sps, pps) per picture: each slice
    header parsed with its own parameter sets, and the C++ entropy
    stage's slice tuples (rbsp, bit offset, first MB, slice QP)."""
    from .avc import split_annexb
    from .avc.slice_header import SliceHeader
    from .decoder import SyntaxDecoder, group_access_units

    sd = SyntaxDecoder()
    rest = sd.feed_parameter_sets(list(split_annexb(stream)))
    for pic_nals in group_access_units(rest):
        slice_datas = []
        headers = []
        for nal in pic_nals:
            h0 = SliceHeader.parse(nal.rbsp, nal, next(iter(
                sd.sps_map.values())), next(iter(sd.pps_map.values())))
            pps = sd.pps_map[h0.pic_parameter_set_id]
            sps = sd.sps_map[pps.seq_parameter_set_id]
            h = SliceHeader.parse(nal.rbsp, nal, sps, pps)
            headers.append(h)
            bitoff = ((h.header_bit_len + 7) & ~7
                      if pps.entropy_coding_mode_flag else h.header_bit_len)
            slice_datas.append((nal.rbsp, bitoff, h.first_mb_in_slice,
                                h.slice_qp_y(pps)))
        yield slice_datas, headers, sps, pps


def frames_from_stream(stream: bytes, n_threads: int = 0):
    """Annex-B all-intra stream -> (FrameSyntax list, sps) through the C++
    entropy stage (``native.entropy.decode_picture_islices`` +
    ``coeffs.pack_from_native``), the jax-free route to the sharded
    paths' input at full size.  Those reconstruct with flat scaling
    lists and without the in-loop filter, so a picture outside that
    scope, or one ``picture_supported`` rejects, raises ValueError."""
    from .coeffs import pack_from_native
    from .native.entropy import decode_picture_islices

    frames = []
    sps = None
    for slice_datas, headers, sps, pps in _pictures(stream):
        if sps.seq_scaling_matrix_present_flag \
                or pps.pic_scaling_matrix_present_flag or not all(
                    picture_supported(sps, pps, h) and h.deblocking
                    is not None and h.deblocking.disable_idc == 1
                    for h in headers):
            raise ValueError("picture outside the scope of the sharded "
                             "paths (intra, flat scaling, no in-loop "
                             "filter)")
        out = decode_picture_islices(slice_datas, sps, pps,
                                     n_threads=n_threads)
        frames.append(pack_from_native(out, sps, pps))
    return frames, sps


def _dbctl_of(headers):
    """Per-slice deblock control rows (disable_idc, alpha_off, beta_off)."""
    return np.asarray([(1, 0, 0) if h.deblocking is not None
                       and h.deblocking.disable_idc == 1 else
                       (0, 0, 0) if h.deblocking is None else
                       (h.deblocking.disable_idc,
                        h.deblocking.alpha_c0_offset_div2 * 2,
                        h.deblocking.beta_offset_div2 * 2)
                       for h in headers], np.int32)


@lru_cache(maxsize=8)
def _cached_tables(device, ls4y, ls4cb, ls4cr, ls8y):
    return decoder_tables(device, *(np.frombuffer(b, np.int32).copy()
                                    for b in (ls4y, ls4cb, ls4cr, ls8y)))


def tables_for(device, ls4=None, ls8=None):
    """``decoder_tables`` for LevelScale lists ls4 (3 x [6,4,4]: Y, Cb,
    Cr) and ls8 ([6,8,8], Y), flat when None; cached by their content,
    so a stream builds its tables once and not for every picture."""
    ls4 = (LS4_FLAT,) * 3 if ls4 is None else ls4
    ls8 = LS8_FLAT if ls8 is None else ls8
    return _cached_tables(str(device), *(
        np.ascontiguousarray(a, np.int32).tobytes() for a in (*ls4, ls8)))


def recon_syntax(s, tables, mb_w, mb_h, halo=None):
    """Syntax tensors [F, n, ...] (``syntax.syntax_tensors``) -> uint8
    planes (y [F, 16*mb_h, 16*mb_w], cb, cr): stage A, then B2, or B2b
    with `halo`.  The body of the JAX package's ``_build`` recon (without
    its deblock) and of ``parallel/gop.py`` / ``parallel/bands.py``'s
    per-shard step."""
    y_z, c_resid = stage_a_residuals(s, tables)
    return intra_recon(*recon_inputs(s, y_z, c_resid), tables, mb_w, mb_h,
                       halo=halo)


def deblock_pre_of(fs, slice_id, headers, pps, device):
    """Edge parameters of an intra picture (the PRE_KEYS dict of
    [1, n, ...] tensors on `device`) from its syntax, the per-MB slice
    ids and the slice headers' deblock control, as
    ``dryv_tpu/pipeline.py`` :147-160 builds them."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)[None]

    ctl = _dbctl_of(headers)[slice_id]
    return deblock_precompute(
        t(fs.kind), t(fs.qp_y), t(slice_id), t(ctl[:, 0]), t(ctl[:, 1]),
        t(ctl[:, 2]), fs.mb_w, fs.mb_h, pps.chroma_qp_index_offset,
        pps.second_chroma_qp_offset, tables_for(device))


def reconstruct_frame(fs, ls4=None, ls8=None, deblock_pre=None,
                      device="cuda"):
    """One FrameSyntax -> (y, cb, cr) uint8 numpy planes (uncropped).

    Counterpart of ``reconstruct_frame_jax`` (``dryv_tpu/pipeline.py``
    :61): stage A with the tables of ls4/ls8, B2 with F = 1, then B3 when
    `deblock_pre` (``deblock_pre_of``) is given."""
    dev = resolve_device(device)
    tabs = tables_for(dev, ls4, ls8)
    y, cb, cr = recon_syntax(syntax_tensors(stack_frames([fs]), dev), tabs,
                             fs.mb_w, fs.mb_h)
    if deblock_pre is not None:
        y, cb, cr = deblock(pack_params(deblock_pre), y, cb, cr, fs.mb_w,
                            fs.mb_h)
    return y[0].cpu().numpy(), cb[0].cpu().numpy(), cr[0].cpu().numpy()


def _level_scales(sps, pps):
    """Per-list LevelScale tables of the active scaling lists: 3 x [6,4,4]
    (intra Y, Cb, Cr) and [6,8,8] (intra Y)."""
    from .refimpl.recon import dezigzag4, dezigzag8
    from .refimpl.transform import level_scale_4x4, level_scale_8x8

    sl = pps.resolve_active_scaling_lists(sps)
    ls4 = [np.asarray(level_scale_4x4(dezigzag4(sl.l4x4[i])), np.int32)
           for i in range(3)]
    return ls4, np.asarray(level_scale_8x8(dezigzag8(sl.l8x8[0])), np.int32)


def decode_annexb_fast(stream: bytes, max_frames: int = 0,
                       n_threads: int = 0, device="cuda"):
    """C++ entropy stage + device reconstruction, one picture at a time.

    Counterpart of ``decode_annexb_fast`` (``dryv_tpu/pipeline.py``
    :83-165), custom scaling lists and the in-loop filter included.  A
    stream with a picture outside the device scope (inter, non-4:2:0,
    field, lossless, FMO, high bit depth) goes whole to the native C++
    decoder (the port's ``native.full``), as there, and is counted in
    ``decode_annexb_fast.host_calls``.  Returns cropped DecodedFrames."""
    from .coeffs import pack_from_native
    from .decoder import DecodedFrame
    from .native.entropy import decode_picture_islices

    dev = resolve_device(device)
    frames = []
    for slice_datas, headers, sps, pps in _pictures(stream):
        if not all(picture_supported(sps, pps, h) for h in headers):
            from .native.full import decode_annexb_native
            decode_annexb_fast.host_calls += 1
            return decode_annexb_native(stream, max_frames,
                                        n_threads=n_threads)
        out = decode_picture_islices(slice_datas, sps, pps,
                                     n_threads=n_threads)
        fs = pack_from_native(out, sps, pps)
        ls4 = ls8 = None
        if sps.seq_scaling_matrix_present_flag \
                or pps.pic_scaling_matrix_present_flag:
            ls4, ls8 = _level_scales(sps, pps)
        pre = None
        if any(h.deblocking is None or h.deblocking.disable_idc != 1
               for h in headers):
            pre = deblock_pre_of(fs, out["slice_id"], headers, pps, dev)
        y, cb, cr = reconstruct_frame(fs, ls4, ls8, deblock_pre=pre,
                                      device=dev)
        frames.append(DecodedFrame(y, cb, cr).crop(sps))
        if max_frames and len(frames) >= max_frames:
            break
    return frames


decode_annexb_fast.host_calls = 0


def decode_annexb_tpu(stream: bytes, max_frames: int = 0, device="cuda"):
    """Python entropy stage (``SyntaxDecoder``) + device reconstruction.

    Counterpart of ``decode_annexb_tpu`` (``dryv_tpu/pipeline.py``
    :227-258): the active scaling lists always feed the tables, and a
    stream the device path does not take here (non-4:2:0, field,
    lossless, or the in-loop filter on) goes to the Python scalar decoder
    (the port's ``decoder.decode_annexb_scalar``), as there."""
    from .avc import split_annexb
    from .coeffs import pack_frame
    from .decoder import (DecodedFrame, SyntaxDecoder,
                                  decode_annexb_scalar, group_access_units)

    dev = resolve_device(device)
    sd = SyntaxDecoder()
    rest = sd.feed_parameter_sets(list(split_annexb(stream)))
    frames = []
    for pic_nals in group_access_units(rest):
        sps, pps, mbs, headers = sd.decode_picture_syntax(pic_nals)
        if sps.chroma_array_type != 1 or headers[0].field_pic_flag \
                or sps.qpprime_y_zero_transform_bypass_flag or any(
                h.deblocking is None or h.deblocking.disable_idc != 1
                for h in headers):
            return decode_annexb_scalar(stream, max_frames)
        ls4, ls8 = _level_scales(sps, pps)
        y, cb, cr = reconstruct_frame(pack_frame(mbs, sps, pps), ls4, ls8,
                                      device=dev)
        frames.append(DecodedFrame(y, cb, cr).crop(sps))
        if max_frames and len(frames) >= max_frames:
            break
    return frames
