"""Packed-wire device I/P/B decode on PyTorch: the port's inter path.

Counterpart of ``dryv_tpu/device_ipb_packed.py``.  Per picture:

1. The C++ slice-parallel entropy stage (the port's ``native.entropy``,
   full I/P/B CABAC or CAVLC syntax; the JAX path takes CABAC only).
2. C++ motion derivation in motion-only mode (``native`` recon.cc):
   MV prediction, skip and direct modes are neighbour-chained integer
   recurrences, host work like CABAC, exporting a dense per-4x4 motion
   field.
3. ONE pinned host blob (``wire``, at F = 1 with its motion segments):
   the bitmap coefficient wire of the intra pipeline extended with the
   motion field (int16 vectors, int8 stack slots and reference indices)
   and the picture's weighted-prediction tables, shipped in one
   non-blocking copy.
4. ``PackedPictureDecoder`` on the device: densify (B1, F = 1), stage A
   (B5), motion compensation over the reference stack that stays on the
   device (B4, ``kernels.inter.mc_frame``, which resolves the WP tables
   per block), inter tiles riding B2's PCM channel (F = 1), and for
   streams that enable it the general edge parameters (B6,
   ``kernels.deblock.deblock_params``: the inter boundary-strength rules
   over the shipped motion field) and B3.  It runs as one captured CUDA
   graph per static key (``STEPS``, the counterpart of the JAX path's
   ``_FN_CACHE``): a replay per picture in place of some hundred
   launches.

Reconstructed planes stay on the device as reference pictures; output is
drained in one batched copy.  The JAX module's wire helpers (``_IPB_SPEC``,
``_layout``, ``_alloc``) have their counterpart in ``wire``, held equal
to them by ``tests/test_torch_helpers.py``.
"""
from __future__ import annotations

import contextlib
import ctypes as ct

import numpy as np
import torch
from torch.profiler import record_function

from . import wire
from .coeffs import KIND_I4, KIND_I8, KIND_PCM
from .device import resolve_device
from .graphs import StepCache
from .kernels.deblock import deblock, deblock_params
from .kernels.geometry import BLK, round_up
from .kernels.inter import mc_frame
from .kernels.transform import luma_residual_raster, stage_a
from .kernels.wavefront import intra_recon, recon_inputs
from .tables import decoder_tables
from .utils.obs import StageTimers, staged

# the caps (W, ecap, ovcap) a call's staging starts at, and the quanta
# its growth rounds to
START_CAPS = (32, 1024, 256)


def _needs(caps, maxnz, nexc, novf, npad):
    """None, or the caps a picture packed at `caps` with the counts
    (maxnz, nexc, novf) asks for: a dense one (``wire.dense``) grows W to
    its per-MB max, rounded to 32 and at most 256, and counts over ecap
    or ovcap grow them, rounded to 1024 and 256.  Unlike the batched
    rule (``gop_pipeline._needs``), all three grow from the one pack's
    counts, also those taken at a W that grows with them."""
    W, ecap, ovcap = caps
    qw, qe, qo = START_CAPS
    grow_w = wire.dense(maxnz, novf, W, npad)
    if nexc <= ecap and novf <= ovcap and not grow_w:
        return None
    return (min(wire.round_cap(maxnz, qw), wire.W_MAX) if grow_w else W,
            wire.round_cap(nexc, qe) if nexc > ecap else ecap,
            wire.round_cap(novf, qo) if novf > ovcap else ovcap)


class PackedPictureDecoder(torch.nn.Module):
    """The device side of one picture: blob + reference stacks -> (y, cb,
    cr) uint8 planes [16*mb_h, 16*mb_w] / [8*mb_h, 8*mb_w], uncropped.

    Replaces ``_make_pic_fn`` of the JAX path.  Its state is the decoder's
    constant tables (``tables.decoder_tables``), held as buffers."""

    def __init__(self, mb_w, mb_h, device):
        super().__init__()
        self.mb_w, self.mb_h = mb_w, mb_h
        self.n = mb_w * mb_h
        self.npad = round_up(self.n, BLK)
        for k, v in decoder_tables(device).items():
            self.register_buffer(k, v, persistent=False)

    @property
    def tables(self):
        return dict(self.named_buffers())

    def forward(self, blob, W, ecap, ovcap, refs, nlists, wp_mode,
                deblocked, chroma_off0, chroma_off1):
        """blob: uint8 [total] on the device, laid out by ``wire.layout``
        at F = 1 with the motion segments;
        refs: (y [R,H,W], cb, cr) uint8 reference stacks in slot order
        (None for an all-intra picture); nlists 0 (all intra), 1 (P) or 2
        (B); wp_mode 0/1/2 as ``native.full.wp_tables`` gives it."""
        mb_w, mb_h, n, npad = self.mb_w, self.mb_h, self.n, self.npad
        n4 = 16 * n
        tabs = self.tables
        g = wire.split(blob, wire.layout(1, npad, n, W, ecap, ovcap,
                                         n4)[0])
        lanes = wire.dense_rows(g, npad, n)                # [1, n, 408]
        u8 = g["u8"]
        with record_function("wire_syntax"):
            s = wire.wire_syntax(lanes, u8, mb_w, mb_h, chroma_off0,
                                 chroma_off1, tabs)
            # bit 6 of the kind byte is an inter MB's transform-8x8 flag
            kind_raw = u8[..., 0].to(torch.int32)
            t8 = (kind_raw >> 6) & 1
            kind = kind_raw & 0x3F
            inter = (kind >= 4) & (kind <= 10)
            # stage A reconstructs inter residuals as I4, or I8 with t8
            s["kind"] = torch.where(inter, torch.where(
                t8 == 1, KIND_I8, KIND_I4).to(torch.int32), kind)
        with record_function("stage_a"):
            # B5 also writes the deblocked picture's coded flags per 4x4
            # block (nz4), from the densified levels: rows are exact
            # zeros for uncoded and skip blocks, and an inter MB with the
            # 8x8 transform is I8 here, so its blocks take their
            # quadrant's flag
            y_z, c_resid, *nz4 = stage_a(s, tabs,
                                         mb_w if deblocked else None)
        mv, rsri = g["mv"], g["rsri"]
        if nlists:
            wp = {"mode": wp_mode, "ri0": rsri[:, 2], "ri1": rsri[:, 3],
                  "expl": g["wp_expl"], "imp": g["wp_imp"], "misc": g["misc"]}
            b = nlists == 2
            pred_y, pred_c = mc_frame(*refs, rsri[:, 0],
                                      rsri[:, 1] if b else None, mv[:, 0],
                                      mv[:, 1] if b else None, wp, mb_w,
                                      mb_h)
            y_ras = luma_residual_raster(y_z, s["kind"])
            # inter tiles ride B2's PCM channel
            s["pcm_y"] = torch.where(inter[..., None], (
                pred_y.view(1, n, 256) + y_ras).clamp(0, 255), 0)
            s["pcm_c"] = torch.where(inter[..., None, None, None], (
                pred_c[None] + c_resid).clamp(0, 255), 0)
        s["kind"] = torch.where(inter, KIND_PCM, kind)
        with record_function("recon_inputs"):
            ins = recon_inputs(s, y_z, c_resid)
        y, cb, cr = intra_recon(*ins, tabs, mb_w, mb_h)
        if deblocked:
            with record_function("deblock_params"):
                prm = deblock_params(
                    kind, s["qp_y"], s["sid"], *wire.dbctl(u8), mb_w, mb_h,
                    chroma_off0, chroma_off1, tabs, t8, nz4[0], mv[None],
                    rsri[None])
            y, cb, cr = deblock(prm, y, cb, cr, mb_w, mb_h)
        return y[0], cb[0], cr[0]


# one captured step per key (device, mb_w, mb_h, deblocked, wp_mode, c0,
# c1, W, ecap, ovcap, nlists, R): the JAX path's _make_pic_fn key without
# `interpret`, plus R, the reference stack depth; a stream uses a few,
# and a cap growth adds one
STEPS = StepCache(max_keys=32)


def _picture_fn(model, W, ecap, ovcap, nlists, wp_mode, deblocked, c0, c1):
    """``model.forward`` with a key's Python constants bound: fn(blob,
    *refs), refs the (y, cb, cr) stacks of an inter picture."""
    def fn(blob, *refs):
        return model(blob, W, ecap, ovcap, refs or None, nlists, wp_mode,
                     deblocked, c0, c1)
    return fn


class _Meta:
    """A stored reference picture's motion field, for later pictures'
    direct modes; motion-only recon reads no host planes, so they are
    one-byte stand-ins."""

    y = cb = cr = np.zeros(1, np.uint8)


def _out_of_scope(sps, pps, h) -> bool:
    """A slice the packed path hands to the native decoder: the fallback
    set of ``dryv_tpu/device_ipb_packed.py`` :347-358 less CAVLC, which
    the JAX path hands over and this path decodes (the native CAVLC
    entropy, then the same wire, motion and step as CABAC)."""
    from .avc.slice_header import SliceType

    return bool(sps.chroma_array_type != 1
                or h.field_pic_flag
                or (not sps.frame_mbs_only_flag
                    and sps.mb_adaptive_frame_field_flag)
                or sps.bit_depth_luma_minus8
                or sps.qpprime_y_zero_transform_bypass_flag
                or pps.slice_groups is not None
                or pps.constrained_intra_pred_flag
                or h.slice_type in (SliceType.SP, SliceType.SI)
                or pps.pic_scaling_matrix_present_flag
                or sps.seq_scaling_matrix_present_flag)


def decode_annexb_device_packed(stream: bytes, max_frames: int = 0,
                                n_threads: int = 0, device_out: bool = False,
                                device="cuda", timers=None,
                                graph: bool = True):
    """Decode an Annex-B I/P/B stream with the packed-wire device path.

    Returns cropped DecodedFrames in display order (epoch, then POC); with
    device_out, (y, cb, cr, poc, sps) tuples of uncropped device planes.
    `device` is explicit: "cuda" (the default) launches the kernels and
    raises when CUDA is absent; "cpu" runs their plain versions.  CABAC
    and CAVLC streams both take the device path.  A stream with a slice
    outside the device scope (non-4:2:0, field or MBAFF, high bit depth,
    lossless, FMO, constrained intra, SP/SI, scaling matrices: the
    fallback set of the JAX path, which also hands over CAVLC) or a PCM
    MB decodes whole on the native C++ decoder (``native.full``), counted
    in ``decode_annexb_device_packed.host_calls``.  `timers` (a
    ``utils.obs.StageTimers``, or anything with its ``stage`` and
    ``count``) takes the call's host work in stages, none inside
    another: split, parse, entropy (CABAC) or cavlc, motion (derivation
    and WP tables), alloc (the pinned blobs: taken from the keep at the
    first picture, given back on return, ``wire.take``,
    ``wire.give_back``), wait (on a slot's copy, and the last drain),
    pack, hold, ship, dispatch (enqueueing ``PackedPictureDecoder``),
    dpb, harvest and fallback (``utils.obs.STAGES``); and the counters
    frames, bins (CABAC), cavlc_bits (CAVLC), wire_bytes, retries,
    epb_bytes and staging_kept (``utils.obs.COUNTERS``).  With `graph`
    (the default) each picture replays its key's captured step
    (``STEPS``): ship copies the blob and the reference planes into the
    step's static inputs, dispatch replays it and clones its planes;
    graph=False enqueues ``PackedPictureDecoder`` op by op.  The output
    is the same bytes either way.  Decodes in several threads or on
    several CUDA streams take turns at the shared steps, one picture's
    copies, replay and clones at a time (``StepCache.hold``)."""

    tm = timers if timers is not None else StageTimers()
    with tm.stage("split"):
        from .avc import split_annexb
        from .avc.dpb import DecodedPictureBuffer
        from .avc.slice_header import SliceHeader, SliceType
        from .decoder import DecodedFrame, SyntaxDecoder, group_access_units
        from .native.entropy import (_ptr, decode_picture_slices, lib,
                                     pack_frame)
        from .native.full import (_build_inter_params, _u8p,
                                  decode_annexb_native, wp_tables)

        dev = resolve_device(device)
        cuda = dev.type == "cuda"
        sd = SyntaxDecoder()
        rest = sd.feed_parameter_sets(list(split_annexb(stream)))
        access_units = group_access_units(rest)
        dpb = DecodedPictureBuffer()
        stored: dict = {}     # frame_idx -> _Meta (motion field)
        planes: dict = {}     # frame_idx -> (y, cb, cr) on the device
        frames = []
        order = []
        epoch = -1
        staging = None        # two pinned blobs, taken at the first picture
        model = None
        npad = n = n4 = 0
        cur = 0

    def to_host():
        if staging is not None:
            with tm.stage("wait"):
                staging.drain()
            with tm.stage("alloc"):
                wire.give_back(dev, staging)
        decode_annexb_device_packed.host_calls += 1
        with tm.stage("fallback"):
            return decode_annexb_native(stream, max_frames,
                                        n_threads=n_threads)

    def get_model():
        nonlocal model
        if model is None:
            model = PackedPictureDecoder(mb_w, mb_h, dev)
        return model

    def pack(again):
        """The picture's wire into the staging's slot cur (`again`: after
        a growth): None, or the caps it needs (``_needs``)."""
        staging.clear(cur, [0], again)
        maxnz, nexc, novf = pack_frame(
            out, n, staging.caps[0], ctl, *staging.views(cur, 0),
            n_threads=n_threads, inter=True)
        assert maxnz >= 0   # PCM handled above
        staging.note(cur, 0, maxnz, nexc, novf)
        return _needs(staging.caps, maxnz, nexc, novf, npad)

    for pic_nals in access_units:
        with tm.stage("parse"):
            headers = []
            slice_datas = []
            sps = pps = None
            for nal in pic_nals:
                rbsp = nal.rbsp
                tm.count("epb_bytes", len(nal.payload) - len(rbsp))
                h0p = SliceHeader.parse(
                    rbsp, nal, next(iter(sd.sps_map.values())),
                    next(iter(sd.pps_map.values())))
                pps = sd.pps_map[h0p.pic_parameter_set_id]
                sps = sd.sps_map[pps.seq_parameter_set_id]
                h = SliceHeader.parse(rbsp, nal, sps, pps)
                if _out_of_scope(sps, pps, h):
                    headers = None
                    break
                headers.append(h)
                slice_datas.append((rbsp, h.data_bit_offset(pps),
                                    h.first_mb_in_slice, h.slice_qp_y(pps),
                                    int(h.slice_type), h.cabac_init_idc,
                                    h.num_ref_idx_l0_active_minus1,
                                    h.num_ref_idx_l1_active_minus1))
            if headers is not None:
                h0 = headers[0]
                nal0 = pic_nals[0]
                if int(nal0.type) == 5:
                    epoch += 1
                poc = dpb.decode_poc(sps, h0, nal0)
                dpb.build_ref_lists(sps, h0, poc)
                mb_w, mb_h = sps.pic_width_in_mbs, sps.frame_height_in_mbs
                if not n:
                    n = mb_w * mb_h
                    n4 = n * 16
                    npad = round_up(n, BLK)
        if headers is None:
            return to_host()
        cabac = pps.entropy_coding_mode_flag
        with tm.stage("entropy" if cabac else "cavlc"):
            out = decode_picture_slices(slice_datas, sps, pps,
                                        n_threads=n_threads, reuse=True)
            tm.count("frames", 1)
            if cabac:
                tm.count("bins", int(out["bin_count"].sum()))
            else:
                tm.count("cavlc_bits", sum(len(sd[0]) * 8 - sd[1]
                                           for sd in slice_datas))
            pcm = bool((out["kind"][:n] == 3).any())
        if pcm:                                     # PCM -> native restart
            return to_host()

        with tm.stage("motion"):
            is_inter_pic = bool((out["kind"][:n] >= 4).any()
                                and not (out["kind"][:n] == 11).all())
            deblocked = any(h.deblocking is None
                            or h.deblocking.disable_idc != 1
                            for h in headers)
            off1 = pps.second_chroma_qp_index_offset
            if off1 is None:
                off1 = pps.chroma_qp_index_offset
            exp = {k: np.zeros(n4 * 2, np.int32) for k in ("mv0", "mv1")}
            for k in ("ri0", "ri1", "rk0", "rk1"):
                exp[k] = np.full(n4, -1, np.int32)
            nz4 = np.zeros(n4, np.uint8)
            wp_mode = 0
            expl = dy = dc = imp = None
            used_keys = []
            if is_inter_pic:
                ip, keep = _build_inter_params(h0, pps, poc, dpb, stored,
                                               exp, nz4)
                ip.motion_only = 1
                dummy = np.zeros(1, np.uint8)
                lib().dt_recon_picture(
                    _ptr(out["kind"]), _ptr(out["qp_y"]), _ptr(out["cbp"]),
                    _ptr(out["i16_mode"]), _ptr(out["chroma_mode"]),
                    _ptr(out["modes4"]), _ptr(out["modes8"]),
                    _ptr(out["luma4"]), _ptr(out["luma8"]),
                    _ptr(out["luma_dc"]), _ptr(out["chroma_dc"]),
                    _ptr(out["chroma_ac"]), _ptr(out["pcm_y"]),
                    _ptr(out["pcm_c"]), _ptr(out["slice_id"]),
                    _ptr(out["mb_type_code"]), _ptr(out["sub_mb_type"]),
                    _ptr(out["ref_idx"]), _ptr(out["mvd"]),
                    _ptr(out["transform8"]),
                    mb_w, mb_h, pps.chroma_qp_index_offset, off1,
                    _u8p(dummy), _u8p(dummy), _u8p(dummy), ct.byref(ip))
                l0 = dpb.ref_list0
                l1 = dpb.ref_list1 if h0.slice_type == SliceType.B else []
                used_keys = sorted({p.frame_idx for p in l0} |
                                   {p.frame_idx for p in l1})
                wp_mode, expl, dy, dc, imp = wp_tables(h0, pps, poc, l0, l1)

        if staging is None:
            with tm.stage("alloc"):
                staging = wire.take(dev, 1, npad, n, START_CAPS, tm,
                                    n4=n4, pin=cuda)
        # ---- fill the wire blob: a slot is refilled only after the
        # device copy that read it two pictures ago has completed
        staging.wait(cur, tm)
        with tm.stage("pack"):
            ctl = wire.dbctl_of(headers)
            caps = pack(False)
        retried = caps is not None
        while caps is not None:
            staging.grow(caps, tm)
            with tm.stage("pack"):
                caps = pack(True)
        with tm.stage("pack"):
            tm.count("retries", int(retried))
            v = staging.bufs[cur]
            if is_inter_pic:
                v["mv"][:, 0] = exp["mv0"].reshape(n4, 2)
                v["mv"][:, 1] = exp["mv1"].reshape(n4, 2)
                # the slot of a reference is its rank among the used keys
                slot = np.full((max(used_keys) + 2) if used_keys else 2, -1,
                               np.int64)
                for i, k in enumerate(used_keys):
                    slot[k] = i
                for col, k in ((0, "rk0"), (1, "rk1")):
                    v["rsri"][:, col] = np.where(
                        exp[k] >= 0, slot[np.clip(exp[k], 0, None)], -1)
                v["rsri"][:, 2] = np.clip(exp["ri0"], -1, 31)
                v["rsri"][:, 3] = np.clip(exp["ri1"], -1, 31)
                v["wp_expl"][:] = 0
                if wp_mode == 1 and expl is not None:
                    v["wp_expl"][:, :expl.shape[1]] = expl
                v["wp_imp"][:] = 0
                n_ref1 = 1
                if wp_mode == 2 and imp is not None:
                    flat = imp.reshape(-1, 2)[:256]
                    v["wp_imp"][:flat.shape[0]] = flat
                    n_ref1 = imp.shape[1]
                v["misc"][:] = (dy or 0, dc or 0, n_ref1, 0)
            else:
                v["mv"][:] = 0
                v["rsri"][:] = -1
                v["wp_expl"][:] = 0
                v["wp_imp"][:] = 0
                v["misc"][:] = 0
                wp_mode = 0
            nlists = (0 if not is_inter_pic else
                      2 if any(h.slice_type == SliceType.B for h in headers)
                      else 1)
            c0 = pps.chroma_qp_index_offset
            W, ecap, ovcap = staging.caps
            host = staging.blob(cur)
            refs = [[planes[k][p] for k in used_keys] for p in range(3)] \
                if used_keys else []
            key = (dev, mb_w, mb_h, deblocked, wp_mode, c0, off1, W, ecap,
                   ovcap, nlists, len(used_keys))

        with staged(tm, "hold", lambda: STEPS.hold(
                key, lambda: _picture_fn(
                    get_model(), W, ecap, ovcap, nlists, wp_mode, deblocked,
                    c0, off1), [host, *refs], dev) if graph
                else contextlib.nullcontext()) as step:
            with tm.stage("ship"):
                tm.count("wire_bytes", host.numel())
                if graph:
                    step.load(host, *refs)
                else:
                    dblob = host.to(dev, non_blocking=True) if cuda else host
                    refs = tuple(torch.stack(r) for r in refs) or None
                staging.shipped(cur, dev)
            with tm.stage("dispatch"):
                if graph:
                    y, cb, cr = step()
                else:
                    y, cb, cr = get_model()(dblob, W, ecap, ovcap, refs,
                                            nlists, wp_mode, deblocked, c0,
                                            off1)

        with tm.stage("dpb"):
            pic = dpb.mark_and_store(sps, h0, nal0, poc)
            if pic is not None:
                planes[pic.frame_idx] = (y, cb, cr)
                m = _Meta()
                m.mv0, m.mv1 = exp["mv0"].copy(), exp["mv1"].copy()
                m.ri0, m.ri1 = exp["ri0"].copy(), exp["ri1"].copy()
                m.rk0, m.rk1 = exp["rk0"].copy(), exp["rk1"].copy()
                m.list0_keys = [p.frame_idx for p in dpb.ref_list0]
                stored[pic.frame_idx] = m
                live = {p.frame_idx for p in dpb.pictures}
                stored = {k: x for k, x in stored.items() if k in live}
                planes = {k: x for k, x in planes.items() if k in live}
            frames.append((y, cb, cr, poc, sps))
            order.append((epoch, poc))
            cur ^= 1
        if max_frames and len(frames) >= max_frames + 16:
            break
    with tm.stage("dpb"):
        frames = [f for _, f in sorted(zip(order, frames),
                                       key=lambda t: t[0])]
        if max_frames:
            frames = frames[:max_frames]
    # the staging goes back to the keep once its copies drained
    if staging is not None:
        with tm.stage("wait"):
            staging.drain()
        with tm.stage("alloc"):
            wire.give_back(dev, staging)
    if device_out or not frames:
        return frames
    with tm.stage("harvest"):
        ys, cbs, crs = (torch.stack([f[p] for f in frames]).cpu().numpy()
                        for p in range(3))
        return [DecodedFrame(ys[i], cbs[i], crs[i], f[3]).crop(f[4])
                for i, f in enumerate(frames)]


decode_annexb_device_packed.host_calls = 0
