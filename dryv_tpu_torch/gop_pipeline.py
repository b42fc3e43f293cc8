"""Batch-pipelined intra GOP decode on PyTorch: the port's main path.

Per batch of F pictures: the C++ slice-parallel entropy stage (the port's
copy of the JAX package's, ``native.entropy``) fills one
preallocated uint8 blob in pinned host memory; the blob goes to the
device in one non-blocking copy; ``PackedGopDecoder`` then densifies the
coefficients (kernel B1), applies the |v|>127 and heavy-MB fixes,
derives qp_c, slice availability and the intra modes, runs stage A
(inverse quantisation + IDCT, kernel B5), the intra wavefront (kernel
B2) and, for streams that enable it, the edge parameters (kernel B6) and
the in-loop filter (kernel B3).  The device work of a batch runs as one
captured CUDA graph per static key (``STEPS``, the counterpart of the
JAX pipeline's ``_PACKED_FN_CACHE``).  Work on the device is
asynchronous: while it reconstructs batch k, the host entropy-decodes
batch k+1.

Counterpart of ``dryv_tpu/gop_pipeline.py``.  That module imports jax
(through ``dryv_tpu.pipeline``), so the numpy helpers this one needs are
copies, held equal to their originals by ``tests/test_torch_helpers.py``:
``_parse_pictures``, ``_gop_supported``, ``_BLOB_SPEC``, ``_blob_layout``,
``_alloc_blob``, ``_round_cap``, ``I16_STRIDE``, ``U8_STRIDE``.
"""
from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch
from torch.profiler import record_function

from .coeffs import KIND_I8

from .device import resolve_device
from .graphs import StepCache
from .kernels.deblock import deblock, deblock_params
from .kernels.densify import densify
from .kernels.geometry import BLK, L, round_up
from .kernels.transform import stage_a
from .kernels.wavefront import intra_recon, recon_inputs
from .pipeline import _dbctl_of, decode_annexb_fast
from .tables import chroma_qp, decoder_tables

I16_STRIDE = 408    # luma_lv 256 | luma_dc 16 | chroma_dc 8 | chroma_ac 128
U8_STRIDE = 19      # kind qp_y i16_mode chroma_mode | modes4 8 (nibbles)
                    # | modes8 2 (nibbles) | sid_lo sid_hi
                    # | dis offa+12 offb+12   (entropy.cc kMetaStride)


def _parse_pictures(stream: bytes):
    from .avc import split_annexb
    from .avc.slice_header import SliceHeader
    from .decoder import SyntaxDecoder, group_access_units

    sd = SyntaxDecoder()
    rest = sd.feed_parameter_sets(list(split_annexb(stream)))
    pics = []
    sps = pps = None
    # single parameter-set streams (the common case) parse each slice
    # header once; multi-PPS streams probe with an arbitrary set first
    # to learn the pic_parameter_set_id, then re-parse with the right one
    single = len(sd.pps_map) == 1 and len(sd.sps_map) == 1
    for pic_nals in group_access_units(rest):
        headers = []
        slice_datas = []
        for nal in pic_nals:
            rbsp = nal.rbsp
            probe_pps = next(iter(sd.pps_map.values()))
            probe_sps = next(iter(sd.sps_map.values()))
            h0 = SliceHeader.parse(rbsp, nal, probe_sps, probe_pps)
            pps = sd.pps_map[h0.pic_parameter_set_id]
            sps = sd.sps_map[pps.seq_parameter_set_id]
            h = h0 if single else SliceHeader.parse(rbsp, nal, sps, pps)
            headers.append(h)
            bitoff = ((h.header_bit_len + 7) & ~7
                      if pps.entropy_coding_mode_flag else h.header_bit_len)
            slice_datas.append((rbsp, bitoff, h.first_mb_in_slice,
                                h.slice_qp_y(pps)))
        pics.append((slice_datas, headers))
    return pics, sps, pps


def _gop_supported(sps, pps, headers) -> bool:
    h = headers[0]
    return (h.slice_type.is_intra and sps.chroma_array_type == 1
            and not h.field_pic_flag
            and not sps.qpprime_y_zero_transform_bypass_flag
            and not sps.bit_depth_luma_minus8
            and pps.slice_groups is None
            and pps.entropy_coding_mode_flag
            and not sps.seq_scaling_matrix_present_flag
            and not pps.pic_scaling_matrix_present_flag)


# --- single-blob staging ----------------------------------------------------
# All seven wire arrays live in ONE contiguous uint8 blob per batch: one
# host->device copy, and dtype views of the device copy give the segments
# back (offsets are 64-byte aligned).

_BLOB_SPEC = (("bmp", np.uint8, lambda F, npad, n, W, e, o: (F, npad, 51)),
              ("vals", np.int8, lambda F, npad, n, W, e, o: (F, npad, W)),
              ("exc_idx", np.int32, lambda F, npad, n, W, e, o: (F, e)),
              ("exc_delta", np.int16, lambda F, npad, n, W, e, o: (F, e)),
              ("ovf_idx", np.int32, lambda F, npad, n, W, e, o: (F, o)),
              ("ovf_rows", np.int16,
               lambda F, npad, n, W, e, o: (F, o, I16_STRIDE)),
              ("u8", np.uint8, lambda F, npad, n, W, e, o: (F, n, U8_STRIDE)))

_TORCH_DTYPE = {np.dtype(np.uint8): torch.uint8, np.dtype(np.int8): torch.int8,
                np.dtype(np.int16): torch.int16,
                np.dtype(np.int32): torch.int32}


def _blob_layout(F, npad, n, W, ecap, ovcap):
    offs = {}
    t = 0
    for name, dt, shape_of in _BLOB_SPEC:
        t = (t + 63) & ~63
        shape = shape_of(F, npad, n, W, ecap, ovcap)
        offs[name] = (t, shape, dt)
        t += int(np.prod(shape)) * np.dtype(dt).itemsize
    return offs, t


def _alloc_blob(F, npad, n, W, ecap, ovcap, pin=False):
    """The blob (numpy, backed by a torch tensor in pinned memory when
    `pin`) and its numpy views by segment name."""
    offs, total = _blob_layout(F, npad, n, W, ecap, ovcap)
    blob = torch.zeros(total, dtype=torch.uint8, pin_memory=pin).numpy()
    views = {name: np.ndarray(shape, dt, buffer=blob, offset=off)
             for name, (off, shape, dt) in offs.items()}
    views["ovf_idx"][:] = npad
    return blob, views


def _round_cap(x, q):
    return max(q, (int(x) + q - 1) & ~(q - 1))


class BlobStaging:
    """The batched pipeline's host staging: `slots` blobs (pinned when
    `pin`) of the packed wire for batches of F pictures, which the fused
    C++ entropy + pack stage fills straight from the entropy arena.  A
    slot is refilled only after the device copy that read it has
    completed (its event in ``ev``, which the caller records).  The vals
    stride W starts at 32 and grows (sticky, like the exc/ovf caps) when
    the stream is dense enough that the 816-byte-per-MB overflow channel
    would dominate the wire; ``caps`` is (W, ecap, ovcap) now."""

    def __init__(self, F, npad, n, pin=False, slots=2):
        self.F, self.npad, self.n, self.pin = F, npad, n, pin
        self.caps = (32, 256, 64)
        self.ev = [None] * slots
        self.bufs = [self._alloc() for _ in range(slots)]

    def _alloc(self):
        blob, views = _alloc_blob(self.F, self.npad, self.n, *self.caps,
                                  pin=self.pin)
        views["cnt"] = np.zeros((self.F, self.npad), np.int32)
        views["_blob"] = blob
        return views

    def drain(self):
        for ev in self.ev:
            if ev is not None:
                ev.synchronize()

    def _grow(self, caps):
        """New blobs at `caps`, holding what the old ones held."""
        self.drain()
        W, ecap, ovcap = self.caps
        self.caps = caps
        for k, old in enumerate(self.bufs):
            nv = self._alloc()
            nv["bmp"][:] = old["bmp"]
            nv["vals"][:, :, :W] = old["vals"]
            nv["exc_idx"][:, :ecap] = old["exc_idx"]
            nv["exc_delta"][:, :ecap] = old["exc_delta"]
            nv["ovf_idx"][:, :ovcap] = old["ovf_idx"]
            nv["ovf_rows"][:, :ovcap] = old["ovf_rows"]
            nv["u8"][:] = old["u8"]
            nv["cnt"] = old["cnt"]
            self.bufs[k] = nv

    def pack(self, k, batch, sps, pps, n_threads, tm):
        """Entropy-decode and pack a batch of (slice_datas, headers) into
        slot k, growing the caps as its pictures need, and pad the tail
        by replicating the last picture.  Returns the blob as a uint8
        tensor, or None at the first picture holding PCM MBs, which the
        wire does not carry."""
        from .native.entropy import decode_pack_picture_islices

        if self.ev[k] is not None:
            with tm.stage("ship"):
                self.ev[k].synchronize()
        npad = self.npad
        b = self.bufs[k]
        for i, (slice_datas, headers) in enumerate(batch):
            with tm.stage("prep"):
                ctl = _dbctl_of(headers)
            stage = "entropy"
            while True:
                b["exc_idx"][i] = 0
                b["exc_delta"][i] = 0
                b["ovf_idx"][i] = npad
                W, ecap, ovcap = self.caps
                # fused: slice workers pack their MB ranges cache-hot
                with tm.stage(stage):
                    out, maxnz, nexc, novf = decode_pack_picture_islices(
                        slice_datas, sps, pps, W, ctl, b["bmp"][i],
                        b["vals"][i], b["cnt"][i], b["u8"][i],
                        b["exc_idx"][i], b["exc_delta"][i],
                        b["ovf_idx"][i], b["ovf_rows"][i],
                        n_threads=n_threads, reuse=True)
                if stage == "entropy":
                    tm.count("frames", 1)
                    tm.count("bins", int(out["bin_count"].sum()))
                if maxnz < 0:
                    return None
                # rare growth retries (sticky caps, typically once per
                # stream on the first picture) re-decode the picture
                if maxnz > W and W < 256 and novf * 816 > npad * 32:
                    # dense stream: grow the sticky stride to the true
                    # per-MB max instead of shipping 816-byte overflow
                    # rows; earlier slots of this batch stay valid
                    self._grow((min(_round_cap(maxnz, 32), 256), ecap,
                                ovcap))
                elif nexc > ecap:
                    self._grow((W, _round_cap(nexc, 256), ovcap))
                elif novf > ovcap:
                    self._grow((W, ecap, _round_cap(novf, 64)))
                else:
                    break
                b = self.bufs[k]
                stage = "pack"
        with tm.stage("pad"):
            last = len(batch) - 1
            for i in range(len(batch), self.F):
                for key in ("bmp", "cnt", "u8", "vals", "exc_idx",
                            "exc_delta", "ovf_idx", "ovf_rows"):
                    b[key][i] = b[key][last]
        return torch.from_numpy(b["_blob"])


def split_blob(blob, offs):
    """Typed views of a device blob's segments; offs maps each name to
    (offset, shape, numpy dtype), as ``_blob_layout`` returns them."""
    seg = {}
    for name, (off, shape, dt) in offs.items():
        nb = int(np.prod(shape)) * np.dtype(dt).itemsize
        seg[name] = blob[off:off + nb].view(_TORCH_DTYPE[np.dtype(dt)]) \
            .view(shape)
    return seg


def dense_rows(seg, npad, n):
    """Wire segments [F, ...] -> dense coefficient rows i16 [F, n, 408]:
    densify (B1), then the |v| > 127 corrections and the heavy MBs'
    whole rows."""
    F = seg["bmp"].shape[0]
    dev = seg["bmp"].device
    # one spare row at the end takes the overflow pad slots
    dense = torch.empty((F * npad + 1, L), dtype=torch.int16, device=dev)
    densify(seg["bmp"], seg["vals"], out=dense[:F * npad].view(F, npad, L))
    with record_function("dense_rows_fixes"):
        # |v| > 127 corrections: an accumulating add (pads add 0 at 0)
        fbase = torch.arange(F, device=dev)[:, None]
        dense.view(-1).index_add_(
            0, (seg["exc_idx"].long() + fbase * (npad * L)).reshape(-1),
            seg["exc_delta"].reshape(-1))
        # heavy MBs ship whole rows; pad slots (index npad) go to the
        # spare
        oi = seg["ovf_idx"].long()
        rows = torch.where(oi < npad, oi + fbase * npad, F * npad)
        dense.index_copy_(0, rows.reshape(-1),
                          seg["ovf_rows"].reshape(-1, L))
    return dense[:F * npad].view(F, npad, L)[:, :n]


class PackedGopDecoder(torch.nn.Module):
    """The device side of one batch: blob -> (y, cb, cr) uint8 planes
    [F, 16*mb_h, 16*mb_w] / [F, 8*mb_h, 8*mb_w], uncropped.

    Replaces ``_make_packed_gop_fn`` of the JAX pipeline.  Its state is
    the decoder's constant tables (``tables.decoder_tables``), held as
    buffers."""

    def __init__(self, mb_w, mb_h, F, deblocked, chroma_off0, chroma_off1,
                 device):
        super().__init__()
        self.mb_w, self.mb_h, self.F = mb_w, mb_h, F
        self.n = mb_w * mb_h
        self.npad = round_up(self.n, BLK)
        self.deblocked = deblocked
        self.c0, self.c1 = chroma_off0, chroma_off1
        for k, v in decoder_tables(device).items():
            self.register_buffer(k, v, persistent=False)

    @property
    def tables(self):
        return dict(self.named_buffers())

    def forward(self, blob, W, ecap, ovcap):
        """blob: uint8 [total] on the device, laid out by _blob_layout."""
        seg = split_blob(blob, _blob_layout(self.F, self.npad, self.n, W,
                                            ecap, ovcap)[0])
        return self.decode_rows(dense_rows(seg, self.npad, self.n),
                                seg["u8"])

    def decode_rows(self, i16, u8, pcm_y=None, pcm_c=None):
        """Dense coefficient rows i16 [F, n, 408] + per-MB bytes u8
        [F, n, 19] (+ PCM samples) -> planes."""
        mb_w, mb_h = self.mb_w, self.mb_h
        tabs = self.tables
        with record_function("wire_syntax"):
            s = wire_syntax(i16, u8, mb_w, mb_h, self.c0, self.c1, tabs)
        if pcm_y is not None:
            s["pcm_y"], s["pcm_c"] = pcm_y, pcm_c
        with record_function("stage_a"):
            yres, cres = stage_a(s, tabs)
        with record_function("recon_inputs"):
            ins = recon_inputs(s, yres, cres)
        y, cb, cr = intra_recon(*ins, tabs, mb_w, mb_h)
        if not self.deblocked:
            return y, cb, cr
        with record_function("deblock_params"):
            prm = deblock_params(s["kind"], s["qp_y"], s["sid"],
                                 *dbctl(u8), mb_w, mb_h, self.c0, self.c1,
                                 tabs)
        return deblock(prm, y, cb, cr, mb_w, mb_h)


# one captured step per key (device, mb_w, mb_h, F, deblocked, c0, c1, W,
# ecap, ovcap): the key of the JAX pipeline's make_packed_gop_fn; a
# stream uses one, and a cap growth adds one
STEPS = StepCache(max_keys=8)


def wire_syntax(i16, u8, mb_w, mb_h, c0, c1, tabs):
    """The syntax dict stage A and B2 read, from dense coefficient rows
    i16 [F, n, 408] and the wire's per-MB bytes u8 [F, n, 19] (layout of
    ``U8_STRIDE``): kind (the byte as shipped, int32), qp_y/qp_cb/qp_cr,
    sid, the intra modes, the coefficient fields and avail_a..d (a
    neighbour is available iff it exists and shares the slice)."""
    F, n = u8.shape[:2]
    qp_y = u8[..., 1].to(torch.int32)
    sid = u8[..., 14].to(torch.int32) | (u8[..., 15].to(torch.int32) << 8)
    sid2 = sid.view(F, mb_h, mb_w)
    # shifted-neighbour slice-id grids (-9 = outside the picture)
    nbs = [torch.full_like(sid2, -9) for _ in range(4)]
    nbs[0][:, :, 1:] = sid2[:, :, :-1]
    nbs[1][:, 1:, :] = sid2[:, :-1, :]
    nbs[2][:, 1:, :-1] = sid2[:, :-1, 1:]
    nbs[3][:, 1:, 1:] = sid2[:, :-1, :-1]
    m4n = u8[..., 4:12]
    m8n = u8[..., 12:14]
    s = {
        "kind": u8[..., 0].to(torch.int32),
        "qp_y": qp_y,
        "qp_cb": chroma_qp(qp_y, c0, tabs["qpc_tab"]),
        "qp_cr": chroma_qp(qp_y, c1, tabs["qpc_tab"]),
        "sid": sid,
        "i16_mode": u8[..., 2],
        "chroma_mode": u8[..., 3],
        "modes4": torch.stack([m4n & 15, m4n >> 4], -1).reshape(F, n, 16),
        "modes8": torch.stack([m8n & 15, m8n >> 4], -1).reshape(F, n, 4),
        "luma_lv": i16[..., :256],
        "luma_dc": i16[..., 256:272],
        "chroma_dc": i16[..., 272:280],
        "chroma_ac": i16[..., 280:408],
    }
    for k, g in zip(("avail_a", "avail_b", "avail_c", "avail_d"), nbs):
        s[k] = (g == sid2).reshape(F, n)
    return s


def dbctl(u8):
    """The per-MB deblock control (disable_deblocking_filter_idc,
    FilterOffsetA, FilterOffsetB) as int32 [F, n] from the wire's per-MB
    bytes u8 [F, n, 19]."""
    dis, offa, offb = u8[..., 16:19].to(torch.int32).unbind(-1)
    return dis.contiguous(), offa - 12, offb - 12


def _pcm_batch_rows(batch, sps, pps, F, n, n_threads):
    """Host rows of a batch holding PCM MBs, which the packed wire does
    not carry: dense coefficient rows [F, n, 408] int16, per-MB bytes
    [F, n, 19] in the wire's u8 layout, pcm_y [F, n, 256] and pcm_c
    [F, n, 2, 8, 8] uint8.  The tail is padded with the last picture."""
    from .native.entropy import decode_picture_islices

    i16 = np.zeros((F, n, I16_STRIDE), np.int16)
    u8 = np.zeros((F, n, U8_STRIDE), np.uint8)
    pcm_y = np.zeros((F, n, 256), np.uint8)
    pcm_c = np.zeros((F, n, 2, 8, 8), np.uint8)
    for i, (slice_datas, headers) in enumerate(batch):
        out = decode_picture_islices(slice_datas, sps, pps,
                                     n_threads=n_threads, reuse=True)
        kind = out["kind"]
        i16[i, :, :256] = np.where((kind == KIND_I8)[:, None],
                                   out["luma8"].reshape(n, 256),
                                   out["luma4"].reshape(n, 256))
        i16[i, :, 256:272] = out["luma_dc"].reshape(n, 16)
        i16[i, :, 272:280] = out["chroma_dc"][:, :, :4].reshape(n, 8)
        i16[i, :, 280:408] = out["chroma_ac"][:, :, :4, :].reshape(n, 128)
        m4, m8 = out["modes4"], out["modes8"]
        sid = out["slice_id"]
        ctl = _dbctl_of(headers)[sid]
        u8[i] = np.concatenate([
            np.stack([kind, out["qp_y"], out["i16_mode"],
                      out["chroma_mode"]], 1),
            m4[:, 0::2] | (m4[:, 1::2] << 4), m8[:, 0::2] | (m8[:, 1::2] << 4),
            np.stack([sid & 255, sid >> 8, ctl[:, 0], ctl[:, 1] + 12,
                      ctl[:, 2] + 12], 1)], 1)
        pcm_y[i] = out["pcm_y"].reshape(n, 256)
        pcm_c[i] = out["pcm_c"].reshape(n, 2, 8, 8)
    for a in (i16, u8, pcm_y, pcm_c):
        a[len(batch):] = a[len(batch) - 1]
    return i16, u8, pcm_y, pcm_c


def decode_annexb_gop_pipelined(stream: bytes, gop: int = 16,
                                n_threads: int = 0, device="cuda",
                                device_out: bool = False,
                                stacked_out: bool = False, timers=None,
                                graph: bool = True):
    """Decode an Annex-B all-intra stream with the batched device pipeline.

    Returns a list of DecodedFrame (host planes, cropped); with
    device_out=True, a list of per-frame (y, cb, cr) device tensors
    (uncropped); with stacked_out=True, a list of per-batch (y, cb, cr,
    n_frames) stacked [F, H, W] device tensors.  `device` is explicit:
    "cuda" (the default) launches the kernels and raises when CUDA is
    absent; "cpu" runs their plain PyTorch versions.  Streams outside the
    batched scope (inter, non-4:2:0, lossless, FMO, CAVLC, scaling
    matrices, high bit depth) leave it, counted in
    ``decode_annexb_gop_pipelined.fallback_calls``, for the per-picture
    path ``pipeline.decode_annexb_fast`` on the same device, as the JAX
    pipeline sends them to its own; that path hands the ones outside the
    device scope (inter, non-4:2:0, lossless, FMO, high bit depth) on to
    the native C++ decoder, counted in
    ``pipeline.decode_annexb_fast.host_calls``.  With `graph` (the
    default) each batch replays its key's captured step (``STEPS``),
    and the output tensors are clones of the step's static outputs;
    graph=False enqueues ``PackedGopDecoder`` op by op.  A batch holding
    PCM MBs (which x264 never emits, and which the JAX pipeline also
    runs apart) always goes op by op through ``decode_rows``.  Decodes
    in several threads or on several CUDA streams take turns at the
    shared steps (``StepCache.hold``)."""
    from .decoder import DecodedFrame
    from .utils.obs import StageTimers

    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    tm = timers if timers is not None else StageTimers()
    with tm.stage("parse"):
        pics, sps, pps = _parse_pictures(stream)
    if not pics or not all(_gop_supported(sps, pps, h) for _, h in pics):
        if device_out or stacked_out:
            raise ValueError("device_out/stacked_out need a stream inside "
                             "the batched all-intra scope")
        decode_annexb_gop_pipelined.fallback_calls += 1
        return decode_annexb_fast(stream, n_threads=n_threads, device=dev,
                                  graph=graph)

    mb_w, mb_h = sps.pic_width_in_mbs, sps.frame_height_in_mbs
    n = mb_w * mb_h
    npad = round_up(n, BLK)
    F = gop
    deblocked = any(h.deblocking is None or h.deblocking.disable_idc != 1
                    for _, hs in pics for h in hs)
    c0, c1 = pps.chroma_qp_index_offset, pps.second_chroma_qp_offset
    model = None

    def get_model():
        nonlocal model
        if model is None:
            model = PackedGopDecoder(mb_w, mb_h, F, deblocked, c0, c1, dev)
        return model

    results = []
    pending = None

    def to_host(r):
        """For host-frame output, enqueue the D2H copy of a batch's
        planes right behind its compute, so harvesting batch k waits for
        batch k only.  Returns (planes, event or None)."""
        if stacked_out or device_out or not cuda:
            return r, None
        hs = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
              for t in r]
        for h, t in zip(hs, r):
            h.copy_(t, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        return hs, ev

    def harvest(p):
        (r, ev), nf = p
        y, cb, cr = r
        if stacked_out:
            results.append((y, cb, cr, nf))
        elif device_out:
            results.extend(zip(y[:nf], cb[:nf], cr[:nf]))
        else:
            if ev is not None:
                ev.synchronize()
            ys, cbs, crs = y.numpy(), cb.numpy(), cr.numpy()
            for i in range(nf):
                results.append(DecodedFrame(ys[i], cbs[i], crs[i])
                               .crop(sps))

    staging = BlobStaging(F, npad, n, pin=cuda)
    batches = [pics[b0:b0 + F] for b0 in range(0, len(pics), F)]
    cur = 0
    for batch in batches:
        host = staging.pack(cur, batch, sps, pps, n_threads, tm)
        if host is None:
            # PCM samples ride their own host rows into the same device
            # path after densify (x264 never emits PCM)
            with tm.stage("pack"):
                rows = _pcm_batch_rows(batch, sps, pps, F, n, n_threads)
            with tm.stage("ship"):
                i16, u8, pcm_y, pcm_c = (torch.from_numpy(a).to(dev)
                                         for a in rows)
            with tm.stage("dispatch"):
                r = to_host(get_model().decode_rows(i16, u8, pcm_y, pcm_c))
            if pending is not None:
                with tm.stage("harvest"):
                    harvest(pending)
            pending = (r, len(batch))
            continue
        W, ecap, ovcap = staging.caps
        with (STEPS.hold(
                (dev, mb_w, mb_h, F, deblocked, c0, c1, W, ecap, ovcap),
                lambda: functools.partial(get_model(), W=W, ecap=ecap,
                                          ovcap=ovcap), [host], dev)
              if graph else contextlib.nullcontext()) as step:
            with tm.stage("ship"):
                if graph:
                    step.load(host)
                else:
                    blob = host.to(dev, non_blocking=True) if cuda else host
                if cuda:
                    staging.ev[cur] = torch.cuda.Event()
                    staging.ev[cur].record(torch.cuda.current_stream(dev))
            with tm.stage("dispatch"):
                r = to_host(step() if graph else
                            get_model()(blob, W, ecap, ovcap))
        if pending is not None:
            with tm.stage("harvest"):
                harvest(pending)
        pending = (r, len(batch))
        cur ^= 1
    if pending is not None:
        with tm.stage("harvest"):
            harvest(pending)
    # the staging blobs are freed on return: let their copies drain
    staging.drain()
    return results


decode_annexb_gop_pipelined.fallback_calls = 0
