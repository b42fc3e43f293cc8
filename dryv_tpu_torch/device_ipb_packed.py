"""Packed-wire device I/P/B decode on PyTorch: the port's inter path.

Counterpart of ``dryv_tpu/device_ipb_packed.py``.  Per picture:

1. The C++ slice-parallel entropy stage (the port's ``native.entropy``,
   full I/P/B CABAC syntax).
2. C++ motion derivation in motion-only mode (``native`` recon.cc):
   MV prediction, skip and direct modes are neighbour-chained integer
   recurrences, host work like CABAC, exporting a dense per-4x4 motion
   field.
3. ONE pinned host blob (``_IPB_SPEC``): the bitmap coefficient wire of
   the intra pipeline extended with the motion field (int16 vectors, int8
   stack slots and reference indices) and the picture's weighted-
   prediction tables, shipped in one non-blocking copy.
4. ``PackedPictureDecoder`` on the device: densify (B1, F = 1), stage A,
   motion compensation over the reference stack that stays on the device
   (B4, ``kernels.inter.mc_frame``, which resolves the WP tables per
   block), inter tiles riding B2's PCM channel (F = 1), and for streams
   that enable it the general edge parameters
   (``kernels.deblock.deblock_precompute``, the inter boundary-strength
   rules over the shipped motion field) and B3.

Reconstructed planes stay on the device as reference pictures; output is
drained in one batched copy.  ``_IPB_SPEC``, ``_shapes``, ``_layout`` and
``_alloc`` are copies of the JAX module's (``_alloc`` pins its blob),
held equal to them by ``tests/test_torch_helpers.py``.
"""
from __future__ import annotations

import ctypes as ct

import numpy as np
import torch

from .coeffs import KIND_I4, KIND_I8, KIND_PCM
from .device import resolve_device
from .gop_pipeline import dense_rows, split_blob, wire_syntax
from .kernels.deblock import deblock, deblock_precompute, pack_params
from .kernels.geometry import BLK, round_up
from .kernels.inter import mc_frame
from .kernels.transform import luma_residual_raster, stage_a_residuals
from .kernels.wavefront import intra_recon, recon_inputs
from .tables import decoder_tables, index_on

_IPB_SPEC = (("bmp", np.uint8, "npad,51"),
             ("vals", np.int8, "npad,W"),
             ("exc_idx", np.int32, "ecap"),
             ("exc_delta", np.int16, "ecap"),
             ("ovf_idx", np.int32, "ovcap"),
             ("ovf_rows", np.int16, "ovcap,408"),
             ("u8", np.uint8, "n,19"),
             ("mv", np.int16, "n4,2,2"),
             ("rsri", np.int8, "n4,4"),
             ("wp_expl", np.int16, "2,32,6"),
             ("wp_imp", np.int16, "256,2"),
             ("misc", np.int32, "4"))


def _shapes(npad, n, n4, W, ecap, ovcap):
    env = dict(npad=npad, n=n, n4=n4, W=W, ecap=ecap, ovcap=ovcap)
    out = {}
    for name, dt, spec in _IPB_SPEC:
        shape = tuple(env.get(tok) or int(tok) for tok in spec.split(","))
        out[name] = (shape, dt)
    return out


def _layout(npad, n, n4, W, ecap, ovcap):
    offs = {}
    t = 0
    for name, (shape, dt) in _shapes(npad, n, n4, W, ecap, ovcap).items():
        t = (t + 63) & ~63
        offs[name] = (t, shape, dt)
        t += int(np.prod(shape)) * np.dtype(dt).itemsize
    return offs, t


def _alloc(npad, n, n4, W, ecap, ovcap, pin=False):
    """The blob (numpy, backed by a torch tensor in pinned memory when
    `pin`) and its numpy views by segment name."""
    offs, total = _layout(npad, n, n4, W, ecap, ovcap)
    blob = torch.zeros(total, dtype=torch.uint8, pin_memory=pin).numpy()
    views = {name: np.ndarray(shape, dt, buffer=blob, offset=off)
             for name, (off, shape, dt) in offs.items()}
    views["ovf_idx"][:] = npad
    return blob, views


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
        """blob: uint8 [total] on the device, laid out by ``_layout``;
        refs: (y [R,H,W], cb, cr) uint8 reference stacks in slot order
        (None for an all-intra picture); nlists 0 (all intra), 1 (P) or 2
        (B); wp_mode 0/1/2 as ``native.full.wp_tables`` gives it."""
        mb_w, mb_h, n, npad = self.mb_w, self.mb_h, self.n, self.npad
        n4 = 16 * n
        tabs = self.tables
        g = split_blob(blob, _layout(npad, n, n4, W, ecap, ovcap)[0])
        wire = {k: g[k][None] for k in ("bmp", "vals", "exc_idx",
                                        "exc_delta", "ovf_idx", "ovf_rows")}
        lanes = dense_rows(wire, npad, n)                  # [1, n, 408]
        u8 = g["u8"][None]
        s = wire_syntax(lanes, u8, mb_w, mb_h, chroma_off0, chroma_off1,
                        tabs)
        # bit 6 of the kind byte is an inter MB's transform-8x8 flag
        kind_raw = u8[..., 0].to(torch.int32)
        t8 = (kind_raw >> 6) & 1
        kind = kind_raw & 0x3F
        inter = (kind >= 4) & (kind <= 10)
        # stage A reconstructs inter residuals as I4, or I8 with t8
        s["kind"] = torch.where(inter, torch.where(t8 == 1, KIND_I8, KIND_I4),
                                kind)
        y_z, c_resid = stage_a_residuals(s, tabs)
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
        y, cb, cr = intra_recon(*recon_inputs(s, y_z, c_resid), tabs, mb_w,
                                mb_h)
        if deblocked:
            # nz per 4x4 block from the densified levels (rows are exact
            # zeros for uncoded and skip blocks); 8x8 MBs take their
            # quadrant's flag; z-scan -> raster block grid
            lv = lanes[0, :, :256]
            nz_z = torch.where(((t8 == 1) | (kind == KIND_I8))[0, :, None],
                               (lv.view(n, 4, 64) != 0).any(-1)
                               .repeat_interleave(4, 1),
                               (lv.view(n, 16, 16) != 0).any(-1))
            nz4 = nz_z[:, index_on("p2z", lv.device)] \
                .view(mb_h, mb_w, 4, 4).permute(0, 2, 1, 3) \
                .reshape(4 * mb_h, 4 * mb_w)
            grid = (1, 4 * mb_h, 4 * mb_w)
            pre = deblock_precompute(
                kind, s["qp_y"], s["sid"], u8[..., 16],
                u8[..., 17].to(torch.int32) - 12,
                u8[..., 18].to(torch.int32) - 12, mb_w, mb_h, chroma_off0,
                chroma_off1, tabs, t8, nz4.view(grid),
                mv[:, 0].view(*grid, 2), mv[:, 1].view(*grid, 2),
                rsri[:, 0].view(grid), rsri[:, 1].view(grid))
            y, cb, cr = deblock(pack_params(pre), y, cb, cr, mb_w, mb_h)
        return y[0], cb[0], cr[0]


class _Meta:
    """A stored reference picture's motion field, for later pictures'
    direct modes; motion-only recon reads no host planes, so they are
    one-byte stand-ins."""

    y = cb = cr = np.zeros(1, np.uint8)


def _out_of_scope(sps, pps, h) -> bool:
    """A slice the packed path hands to the native decoder (the fallback
    set of ``dryv_tpu/device_ipb_packed.py`` :347-358)."""
    from .avc.slice_header import SliceType

    return bool(sps.chroma_array_type != 1
                or h.field_pic_flag
                or (not sps.frame_mbs_only_flag
                    and sps.mb_adaptive_frame_field_flag)
                or sps.bit_depth_luma_minus8
                or sps.qpprime_y_zero_transform_bypass_flag
                or pps.slice_groups is not None
                or pps.constrained_intra_pred_flag
                or not pps.entropy_coding_mode_flag
                or h.slice_type in (SliceType.SP, SliceType.SI)
                or pps.pic_scaling_matrix_present_flag
                or sps.seq_scaling_matrix_present_flag)


def decode_annexb_device_packed(stream: bytes, max_frames: int = 0,
                                n_threads: int = 0, device_out: bool = False,
                                device="cuda", timers=None):
    """Decode an Annex-B I/P/B stream with the packed-wire device path.

    Returns cropped DecodedFrames in display order (epoch, then POC); with
    device_out, (y, cb, cr, poc, sps) tuples of uncropped device planes.
    `device` is explicit: "cuda" (the default) launches the kernels and
    raises when CUDA is absent; "cpu" runs their plain versions.  A
    stream with a slice outside the device scope (the fallback set of
    the JAX path: non-4:2:0, field or MBAFF, high bit depth, lossless,
    FMO, constrained intra, CAVLC, SP/SI, scaling matrices) or a PCM MB
    decodes whole on the native C++ decoder (``native.full``), counted in
    ``decode_annexb_device_packed.host_calls``.  `timers` (a
    ``utils.obs.StageTimers``) accumulates the host stages: parse,
    entropy, motion (derivation and WP tables), pack, ship, dispatch
    (enqueueing ``PackedPictureDecoder``) and harvest."""
    from .avc import split_annexb
    from .avc.dpb import DecodedPictureBuffer
    from .avc.slice_header import SliceHeader, SliceType
    from .decoder import DecodedFrame, SyntaxDecoder, group_access_units
    from .native.entropy import _ptr, decode_picture_slices, lib, pack_frame
    from .native.full import (_build_inter_params, _u8p,
                              decode_annexb_native, wp_tables)
    from .pipeline import _dbctl_of
    from .utils.obs import StageTimers

    def to_host():
        drain()
        decode_annexb_device_packed.host_calls += 1
        return decode_annexb_native(stream, max_frames, n_threads=n_threads)

    def drain():
        for ev in slot_ev:
            if ev is not None:
                ev.synchronize()

    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    tm = timers if timers is not None else StageTimers()
    sd = SyntaxDecoder()
    rest = sd.feed_parameter_sets(list(split_annexb(stream)))
    dpb = DecodedPictureBuffer()
    stored: dict = {}     # frame_idx -> _Meta (motion field)
    planes: dict = {}     # frame_idx -> (y, cb, cr) on the device
    frames = []
    order = []
    epoch = -1
    W, ecap, ovcap = 32, 1024, 256
    bufs = None           # two pinned blobs, made at the first picture
    slot_ev = [None, None]
    model = None
    npad = n = n4 = 0
    cur = 0

    for pic_nals in group_access_units(rest):
        with tm.stage("parse"):
            headers = []
            slice_datas = []
            sps = pps = None
            for nal in pic_nals:
                rbsp = nal.rbsp
                h0p = SliceHeader.parse(
                    rbsp, nal, next(iter(sd.sps_map.values())),
                    next(iter(sd.pps_map.values())))
                pps = sd.pps_map[h0p.pic_parameter_set_id]
                sps = sd.sps_map[pps.seq_parameter_set_id]
                h = SliceHeader.parse(rbsp, nal, sps, pps)
                if _out_of_scope(sps, pps, h):
                    return to_host()
                headers.append(h)
                slice_datas.append((rbsp, (h.header_bit_len + 7) & ~7,
                                    h.first_mb_in_slice, h.slice_qp_y(pps),
                                    int(h.slice_type), h.cabac_init_idc,
                                    h.num_ref_idx_l0_active_minus1,
                                    h.num_ref_idx_l1_active_minus1))
            h0 = headers[0]
            nal0 = pic_nals[0]
            if int(nal0.type) == 5:
                epoch += 1
            poc = dpb.decode_poc(sps, h0, nal0)
            dpb.build_ref_lists(sps, h0, poc)
        with tm.stage("entropy"):
            out = decode_picture_slices(slice_datas, sps, pps,
                                        n_threads=n_threads, reuse=True)
        tm.count("frames", 1)
        mb_w, mb_h = sps.pic_width_in_mbs, sps.frame_height_in_mbs
        if bufs is None:
            n = mb_w * mb_h
            n4 = n * 16
            npad = round_up(n, BLK)
            bufs = [_alloc(npad, n, n4, W, ecap, ovcap, pin=cuda)
                    for _ in range(2)]
            model = PackedPictureDecoder(mb_w, mb_h, dev)
        if bool((out["kind"][:n] == 3).any()):     # PCM -> native restart
            return to_host()
        is_inter_pic = bool((out["kind"][:n] >= 4).any()
                            and not (out["kind"][:n] == 11).all())
        deblocked = any(h.deblocking is None or h.deblocking.disable_idc != 1
                        for h in headers)
        off1 = pps.second_chroma_qp_index_offset
        if off1 is None:
            off1 = pps.chroma_qp_index_offset

        with tm.stage("motion"):
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

        # ---- fill the wire blob: a slot is refilled only after the
        # device copy that read it two pictures ago has completed
        with tm.stage("ship"):
            if slot_ev[cur] is not None:
                slot_ev[cur].synchronize()
        with tm.stage("pack"):
            blob, v = bufs[cur]
            ctl = _dbctl_of(headers)
            while True:
                v["exc_idx"][:] = 0
                v["exc_delta"][:] = 0
                v["ovf_idx"][:] = npad
                maxnz, nexc, novf = pack_frame(
                    out, n, W, ctl, v["bmp"], v["vals"],
                    np.zeros(npad, np.int32), v["u8"], v["exc_idx"],
                    v["exc_delta"], v["ovf_idx"], v["ovf_rows"],
                    n_threads=n_threads, inter=True)
                assert maxnz >= 0   # PCM handled above
                dense = maxnz > W and W < 256 and novf * 816 > npad * 32
                if nexc <= ecap and novf <= ovcap and not dense:
                    break
                if dense:
                    W = min(max(32, (maxnz + 31) & ~31), 256)
                if nexc > ecap:
                    ecap = max(1024, (nexc + 1023) & ~1023)
                if novf > ovcap:
                    ovcap = max(256, (novf + 255) & ~255)
                drain()
                bufs = [_alloc(npad, n, n4, W, ecap, ovcap, pin=cuda)
                        for _ in range(2)]
                blob, v = bufs[cur]
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

        with tm.stage("ship"):
            host = torch.from_numpy(blob)
            if cuda:
                dblob = host.to(dev, non_blocking=True)
                slot_ev[cur] = torch.cuda.Event()
                slot_ev[cur].record(torch.cuda.current_stream(dev))
            else:
                dblob = host
            refs = None
            if used_keys:
                refs = tuple(torch.stack([planes[k][p] for k in used_keys])
                             for p in range(3))
        nlists = (0 if not is_inter_pic else
                  2 if any(h.slice_type == SliceType.B for h in headers)
                  else 1)
        with tm.stage("dispatch"):
            y, cb, cr = model(dblob, W, ecap, ovcap, refs, nlists, wp_mode,
                              deblocked, pps.chroma_qp_index_offset, off1)

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
    frames = [f for _, f in sorted(zip(order, frames), key=lambda t: t[0])]
    if max_frames:
        frames = frames[:max_frames]
    if device_out or not frames:
        drain()
        return frames
    with tm.stage("harvest"):
        ys, cbs, crs = (torch.stack([f[p] for f in frames]).cpu().numpy()
                        for p in range(3))
        drain()
        return [DecodedFrame(ys[i], cbs[i], crs[i], f[3]).crop(f[4])
                for i, f in enumerate(frames)]


decode_annexb_device_packed.host_calls = 0
