"""Per-picture device path: FrameSyntax -> planes, one picture at a time.

Counterpart of ``dryv_tpu/pipeline.py``.  It reconstructs the intra
streams the batched pipeline (``gop_pipeline``) leaves out, CAVLC and
custom scaling matrices among them, and it is what
``TorchVideo.decode_frames`` runs without stage timers, as
``Video.decode_frames(backend="jax")`` does.  Per picture: the C++
entropy stage (``decode_annexb_fast``) or the Python one
(``decode_annexb_tpu``) makes a ``FrameSyntax``; on the device, stage A
(kernel B5), kernel B2 with F = 1 and, for streams that enable it, the
edge parameters (kernel B6, ahead of the step) and kernel B3.  The JAX
package's XLA scan wavefront and deblock (``_build``) have no
counterpart here: B2 and B3 and their plain versions do that job.  Its
jit does: the device work of a picture runs as one captured CUDA graph
per static key (``STEPS``), which takes the LevelScale lists as inputs,
as ``_build``'s recon takes them as arguments.  ``entry`` is the counterpart of the
root ``__graft_entry__.py``'s ``entry()``: that step at 4x4 MBs with
example arguments.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
from torch.profiler import record_function

from .device import resolve_device
from .graphs import StepCache
from .kernels.deblock import deblock, deblock_params
from .kernels.geometry import LS4_FLAT, LS8_FLAT
from .kernels.transform import LS_KEYS, stage_a
from .kernels.wavefront import intra_recon, recon_inputs
from .syntax import stack_frames, syntax_tensors
from .tables import decoder_tables
from .wire import dbctl_of


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
            rbsp = nal.rbsp
            h0 = SliceHeader.parse(rbsp, nal, next(iter(
                sd.sps_map.values())), next(iter(sd.pps_map.values())))
            pps = sd.pps_map[h0.pic_parameter_set_id]
            sps = sd.sps_map[pps.seq_parameter_set_id]
            h = SliceHeader.parse(rbsp, nal, sps, pps)
            headers.append(h)
            slice_datas.append((rbsp, h.data_bit_offset(pps),
                                h.first_mb_in_slice,
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


@lru_cache(maxsize=8)
def _cached_tables(device, ls4y, ls4cb, ls4cr, ls8y):
    return decoder_tables(device, *(np.frombuffer(b, np.int32).copy()
                                    for b in (ls4y, ls4cb, ls4cr, ls8y)))


def _lists_key(ls4=None, ls8=None):
    """The content of LevelScale lists ls4 and ls8 (flat when None) as a
    hashable key."""
    ls4 = (LS4_FLAT,) * 3 if ls4 is None else ls4
    ls8 = LS8_FLAT if ls8 is None else ls8
    return tuple(np.ascontiguousarray(a, np.int32).tobytes()
                 for a in (*ls4, ls8))


def tables_for(device, ls4=None, ls8=None):
    """``decoder_tables`` for LevelScale lists ls4 (3 x [6,4,4]: Y, Cb,
    Cr) and ls8 ([6,8,8], Y), flat when None; cached by their content,
    so a stream builds its tables once and not for every picture."""
    return _cached_tables(str(device), *_lists_key(ls4, ls8))


def recon_syntax(s, tables, mb_w, mb_h, halo=None):
    """Syntax tensors [F, n, ...] (``syntax.syntax_tensors``) -> uint8
    planes (y [F, 16*mb_h, 16*mb_w], cb, cr): stage A (B5), then B2, or
    B2b with `halo`.  The body of the JAX package's ``_build`` recon
    (without its deblock) and of ``parallel/gop.py`` /
    ``parallel/bands.py``'s per-shard step."""
    with record_function("stage_a"):
        yres, cres = stage_a(s, tables)
    with record_function("recon_inputs"):
        ins = recon_inputs(s, yres, cres)
    return intra_recon(*ins, tables, mb_w, mb_h, halo=halo)


def deblock_pre_of(fs, slice_id, headers, pps, device):
    """Edge parameters of an intra picture, B3's uint8 [1, n, 192] rows
    on `device` (kernel B6), from its syntax, the per-MB slice ids and
    the slice headers' deblock control, as ``dryv_tpu/pipeline.py``
    :147-160 builds them."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)) \
            .to(device)[None]

    ctl = dbctl_of(headers)[slice_id]
    with record_function("deblock_params"):
        return deblock_params(
            t(fs.kind), t(fs.qp_y), t(slice_id), t(ctl[:, 0]),
            t(ctl[:, 1]), t(ctl[:, 2]), fs.mb_w, fs.mb_h,
            pps.chroma_qp_index_offset, pps.second_chroma_qp_offset,
            tables_for(device))


# one captured step per key (device, mb_w, mb_h, deblocked, the syntax
# tensors' names, which PCM pictures extend): the counterpart of the
# jitted _build recon, which takes the LevelScale lists as arguments
STEPS = StepCache(max_keys=8)


def _recon_fn(tabs, mb_w, mb_h, names):
    """fn(*syntax tensors in `names` order, ls4y, ls4cb, ls4cr, ls8y
    (``LS_KEYS``: [6,16] and [6,64] int32 rows), B3's parameter rows if
    deblocked) -> (y, cb, cr): stage A with the LevelScale rows it is
    given and the other tables of `tabs`, B2 and B3."""
    n, m = len(names), len(names) + len(LS_KEYS)

    def fn(*xs):
        t = dict(tabs, **dict(zip(LS_KEYS, xs[n:m])))
        y, cb, cr = recon_syntax(dict(zip(names, xs)), t, mb_w, mb_h)
        if len(xs) > m:
            y, cb, cr = deblock(xs[m], y, cb, cr, mb_w, mb_h)
        return y, cb, cr
    return fn


def _run_step(dev, mb_w, mb_h, names, xs, graph=True):
    """The per-picture step on inputs `xs` (``_recon_fn``'s): loaded into
    the static inputs of its key's captured step and replayed, or with
    `graph` False run op by op on them."""
    def make():
        return _recon_fn(tables_for(dev), mb_w, mb_h, names)
    if not graph:
        return make()(*xs)
    deblocked = len(xs) > len(names) + len(LS_KEYS)
    with STEPS.hold((dev, mb_w, mb_h, deblocked, names), make, xs,
                    dev) as step:
        step.load(*xs)
        return step()


def reconstruct_frame(fs, ls4=None, ls8=None, deblock_pre=None,
                      device="cuda", graph: bool = True):
    """One FrameSyntax -> (y, cb, cr) uint8 numpy planes (uncropped).

    Counterpart of ``reconstruct_frame_jax`` (``dryv_tpu/pipeline.py``
    :61): stage A with the LevelScale lists ls4/ls8, B2 with F = 1, then
    B3 when `deblock_pre` (B3's parameter rows, ``deblock_pre_of``) is
    given.  With `graph` (the default) the syntax tensors, the lists and
    the parameter rows are copied into the static inputs of the key's
    captured step, which is replayed (one thread or stream at a time,
    ``StepCache.hold``); pictures with other lists replay the same
    step."""
    dev = resolve_device(device)
    s = syntax_tensors(stack_frames([fs]), "cpu" if graph else dev)
    names = tuple(sorted(s))
    lists = tables_for(dev, ls4, ls8)
    xs = [s[k] for k in names] + [lists[k] for k in LS_KEYS]
    if deblock_pre is not None:
        xs.append(deblock_pre)
    y, cb, cr = _run_step(dev, fs.mb_w, fs.mb_h, names, xs, graph)
    return y[0].cpu().numpy(), cb[0].cpu().numpy(), cr[0].cpu().numpy()


def entry(device="cuda"):
    """(fn, example_args): the per-picture step of a 4x4-MB picture
    without the in-loop filter, and its arguments.

    Counterpart of ``__graft_entry__.py`` ``entry()`` :26-38, which
    returns the jitted ``_build(4, 4)`` recon.  ``example_args`` are
    (s, ls4y, ls4cb, ls4cr, ls8y) on `device`: the syntax tensors
    (``syntax_tensors``) of the one picture of ``parallel._tiny_stream
    (1)``, byte for byte the ``slices_qp28`` fixture's stream the
    original decodes (4 slices, I16/I4/PCM), and the flat LevelScale
    lists ``LS4_FLAT`` x 3 and ``LS8_FLAT`` ([6,4,4], [6,8,8]).
    ``fn(s, ls4y, ls4cb, ls4cr, ls8y)`` loads them into its key's step
    in ``STEPS`` and replays it (on the CPU: runs it on the step's
    buffers), returning uint8 y [64,64], cb [32,32], cr [32,32] on
    `device`.  The lists may also come as rows ([6,16], [6,64]); other
    lists, or another 4x4 picture with the same syntax fields, replay
    the same step."""
    from .parallel import _tiny_stream

    dev = resolve_device(device)
    (fs,), _ = frames_from_stream(_tiny_stream(1))
    mb_w, mb_h = fs.mb_w, fs.mb_h

    def fn(s, ls4y, ls4cb, ls4cr, ls8y):
        names = tuple(sorted(s))
        xs = [s[k] for k in names] + [ls.reshape(6, -1) for ls in
                                      (ls4y, ls4cb, ls4cr, ls8y)]
        y, cb, cr = _run_step(dev, mb_w, mb_h, names, xs)
        return y[0], cb[0], cr[0]

    ls = torch.from_numpy(np.ascontiguousarray(LS4_FLAT)).to(dev)
    return fn, (syntax_tensors(stack_frames([fs]), dev), ls, ls, ls,
                torch.from_numpy(np.ascontiguousarray(LS8_FLAT)).to(dev))


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
                       n_threads: int = 0, device="cuda",
                       graph: bool = True):
    """C++ entropy stage + device reconstruction, one picture at a time.

    Counterpart of ``decode_annexb_fast`` (``dryv_tpu/pipeline.py``
    :83-165), custom scaling lists and the in-loop filter included.  A
    stream with a picture outside the device scope (inter, non-4:2:0,
    field, lossless, FMO, high bit depth) goes whole to the native C++
    decoder (the port's ``native.full``), as there, and is counted in
    ``decode_annexb_fast.host_calls``.  Returns cropped DecodedFrames.
    `graph` is ``reconstruct_frame``'s."""
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
                                      device=dev, graph=graph)
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
