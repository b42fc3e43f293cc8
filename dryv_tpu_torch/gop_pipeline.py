"""Batch-pipelined intra GOP decode on PyTorch: the port's main path.

Per batch of F pictures: the C++ entropy stage (the port's copy of the
JAX package's, ``native.entropy``, with a batch entry of the port's own:
the batch's pictures and their slices in parallel on the host) fills one
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
``_parse_pictures`` and ``_gop_supported`` here, the wire's layout in
``wire``.
"""
from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch
from torch.profiler import record_function

from . import wire
from .coeffs import KIND_I8
from .device import resolve_device
from .graphs import StepCache
from .kernels.deblock import deblock, deblock_params
from .kernels.geometry import BLK, round_up
from .kernels.transform import stage_a
from .kernels.wavefront import intra_recon, recon_inputs
from .pipeline import decode_annexb_fast
from .tables import decoder_tables
from .utils.obs import StageTimers, staged


def _parse_pictures(stream: bytes, timers=None):
    """(slice_datas, headers) per picture, and the last sps and pps; each
    slice's RBSP made once, its removed emulation-prevention bytes
    counted as ``epb_bytes`` into `timers` where given."""
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
    epb = 0
    for pic_nals in group_access_units(rest):
        headers = []
        slice_datas = []
        for nal in pic_nals:
            rbsp = nal.rbsp
            epb += len(nal.payload) - len(rbsp)
            probe_pps = next(iter(sd.pps_map.values()))
            probe_sps = next(iter(sd.sps_map.values()))
            h0 = SliceHeader.parse(rbsp, nal, probe_sps, probe_pps)
            pps = sd.pps_map[h0.pic_parameter_set_id]
            sps = sd.sps_map[pps.seq_parameter_set_id]
            h = h0 if single else SliceHeader.parse(rbsp, nal, sps, pps)
            headers.append(h)
            slice_datas.append((rbsp, h.data_bit_offset(pps),
                                h.first_mb_in_slice,
                                h.slice_qp_y(pps)))
        pics.append((slice_datas, headers))
    if timers is not None:
        timers.count("epb_bytes", epb)
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


# the caps (W, ecap, ovcap) a call's staging starts at, and the quanta
# its growth rounds to
START_CAPS = (32, 256, 64)


def _needs(caps, npad, todo, res):
    """The caps that the pictures `todo`, decoded at `caps` with results
    `res` (rows of maxnz, n_exc, n_ovf, bins), ask for, and the pictures
    to decode again at them.  A dense picture (``wire.dense``) grows
    the sticky vals stride W to its true per-MB max, rounded to 32 and
    at most 256; once W grows, every picture whose max exceeded the old
    W packs otherwise and is decoded again, and its exc/ovf counts at
    the old W are not needs.  The others' exception and overflow counts
    grow ecap and ovcap (rounded to 256 and 64) to the largest need.
    Unlike the I/P/B rule (``device_ipb_packed._needs``), counts taken
    at a W that then grows are dropped, not kept."""
    W, ecap, ovcap = caps
    qw, qe, qo = START_CAPS
    maxnz, nexc, novf = (res[:, j] for j in range(3))
    grow_w = wire.dense(maxnz, novf, W, npad)
    W2 = max([W] + [min(wire.round_cap(m, qw), wire.W_MAX)
                    for m in maxnz[grow_w]])
    stale = (maxnz > W) & (W2 > W)
    over_e = (nexc > ecap) & ~stale
    over_o = (novf > ovcap) & ~stale
    ecap2 = max([ecap] + [wire.round_cap(e, qe) for e in nexc[over_e]])
    ovcap2 = max([ovcap] + [wire.round_cap(o, qo) for o in novf[over_o]])
    redo = [i for i, r in zip(todo, stale | over_e | over_o) if r]
    return (W2, ecap2, ovcap2), redo


def pack_batch(st, k, batch, sps, pps, n_threads, tm):
    """Entropy-decode and pack a batch of (slice_datas, headers) into
    slot k of the ``wire.Staging`` `st`, growing its caps as the
    pictures need (``_needs``), and pad the tail by replicating the last
    picture.  Returns the blob as a uint8 tensor, or None if a picture
    holds PCM MBs, which the wire does not carry.  One native call
    (``decode_pack_batch``) decodes the whole batch on up to `n_threads`
    host threads at the current caps; if pictures need more, the caps
    grow once to the batch's largest need and one more call decodes
    those pictures again, until none exceeds them.  The blob is then the
    same as a decode of every picture at the final caps.  `tm` takes the
    work in the stages wait, prep, entropy (the first call), redecode (a
    later one), alloc and pad, and counts frames, bins, retries
    (pictures decoded again), par_pictures (the batch's pictures, if
    more than one task ran at once in its first call) and
    entropy_task_us (the native tasks' summed wall time, in every
    call)."""
    st.wait(k, tm)
    with tm.stage("prep"):
        ctls = [wire.dbctl_of(headers) for _, headers in batch]
        todo = list(range(len(batch)))
        retried = set()
    stage = "entropy"
    while True:
        with tm.stage(stage):
            from .native.entropy import decode_pack_batch

            st.clear(k, todo, again=stage == "redecode")
            res, (task_us, peak) = decode_pack_batch(
                [(batch[i][0], ctls[i]) for i in todo], sps, pps,
                st.caps[0], [st.views(k, i) for i in todo],
                n_threads=n_threads)
            tm.count("entropy_task_us", task_us)
            if stage == "entropy":
                tm.count("frames", len(batch))
                tm.count("bins", int(res[:, 3].sum()))
                if peak > 1:
                    tm.count("par_pictures", len(batch))
            pcm = bool((res[:, 0] < 0).any())
            caps, redo = (st.caps, []) if pcm else \
                _needs(st.caps, st.npad, todo, res)
            tm.count("retries", len(set(redo) - retried))
            retried.update(redo)
            if not (pcm or redo):
                for i, r in zip(todo, res):
                    st.note(k, i, *r[:3])
        if pcm:
            return None
        if not redo:
            break
        st.grow(caps, tm)
        todo = redo
        stage = "redecode"
    with tm.stage("pad"):
        b = st.bufs[k]
        last = len(batch) - 1
        for i in range(len(batch), st.F):
            for key in wire.NATIVE_VIEWS:
                b[key][i] = b[key][last]
        return st.blob(k)


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
        """blob: uint8 [total] on the device, laid out by
        ``wire.layout``."""
        seg = wire.split(blob, wire.layout(self.F, self.npad, self.n, W,
                                           ecap, ovcap)[0])
        return self.decode_rows(wire.dense_rows(seg, self.npad, self.n),
                                seg["u8"])

    def decode_rows(self, i16, u8, pcm_y=None, pcm_c=None):
        """Dense coefficient rows i16 [F, n, 408] + per-MB bytes u8
        [F, n, 19] (+ PCM samples) -> planes."""
        mb_w, mb_h = self.mb_w, self.mb_h
        tabs = self.tables
        with record_function("wire_syntax"):
            s = wire.wire_syntax(i16, u8, mb_w, mb_h, self.c0, self.c1,
                                 tabs)
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
                                 *wire.dbctl(u8), mb_w, mb_h, self.c0,
                                 self.c1, tabs)
        return deblock(prm, y, cb, cr, mb_w, mb_h)


# one captured step per key (device, mb_w, mb_h, F, deblocked, c0, c1, W,
# ecap, ovcap): the key of the JAX pipeline's make_packed_gop_fn; a
# stream uses one, and a cap growth adds one
STEPS = StepCache(max_keys=8)


def _pcm_batch_rows(batch, sps, pps, F, n, n_threads):
    """Host rows of a batch holding PCM MBs, which the packed wire does
    not carry: dense coefficient rows [F, n, 408] int16, per-MB bytes
    [F, n, 19] in the wire's u8 layout, pcm_y [F, n, 256] and pcm_c
    [F, n, 2, 8, 8] uint8.  The tail is padded with the last picture."""
    from .native.entropy import decode_picture_islices

    i16 = np.zeros((F, n, wire.I16_STRIDE), np.int16)
    u8 = np.zeros((F, n, wire.U8_STRIDE), np.uint8)
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
        ctl = wire.dbctl_of(headers)[sid]
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
    n_frames) stacked [F, H, W] device tensors; these are slices of one
    [n_batches * F, H, W] tensor per plane allocated for the decode.
    `device` is explicit:
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
    which copies its static outputs into the batch's slices (host frames
    on CUDA: into one pinned buffer per batch; on the CPU: into clones);
    graph=False enqueues ``PackedGopDecoder`` op by op.  A batch holding
    PCM MBs (which x264 never emits, and which the JAX pipeline also
    runs apart) always goes op by op through ``decode_rows``.  Decodes
    in several threads or on several CUDA streams take turns at the
    shared steps (``StepCache.hold``).  `timers` (a
    ``utils.obs.StageTimers``, or anything with its ``stage`` and
    ``count``) takes the call's host work in stages, none inside
    another: parse (NAL split and headers), alloc (the call's device
    planes, and its staging taken from and given back to the keep:
    ``wire.take``, ``wire.give_back``), those of ``pack_batch`` (wait,
    prep, entropy, redecode, alloc, pad), pack (a PCM batch's rows),
    hold, ship, dispatch, harvest, wait (the last drain) and fallback
    (``utils.obs.STAGES``); and the counters frames, bins, wire_bytes,
    retries, par_pictures, entropy_task_us, epb_bytes and staging_kept
    (``utils.obs.COUNTERS``)."""
    tm = timers if timers is not None else StageTimers()
    with tm.stage("parse"):
        from .decoder import DecodedFrame

        dev = resolve_device(device)
        cuda = dev.type == "cuda"
        pics, sps, pps = _parse_pictures(stream, tm)
        inside = bool(pics) and all(_gop_supported(sps, pps, h)
                                    for _, h in pics)
    if not inside:
        if device_out or stacked_out:
            raise ValueError("device_out/stacked_out need a stream inside "
                             "the batched all-intra scope")
        decode_annexb_gop_pipelined.fallback_calls += 1
        with tm.stage("fallback"):
            return decode_annexb_fast(stream, n_threads=n_threads,
                                      device=dev, graph=graph)

    with tm.stage("parse"):
        mb_w, mb_h = sps.pic_width_in_mbs, sps.frame_height_in_mbs
        n = mb_w * mb_h
        npad = round_up(n, BLK)
        F = gop
        deblocked = any(h.deblocking is None
                        or h.deblocking.disable_idc != 1
                        for _, hs in pics for h in hs)
        c0, c1 = pps.chroma_qp_index_offset, pps.second_chroma_qp_offset
        model = None

    def get_model():
        nonlocal model
        if model is None:
            model = PackedGopDecoder(mb_w, mb_h, F, deblocked, c0, c1, dev)
        return model

    with tm.stage("alloc"):
        results = []
        pending = None
        batches = [pics[b0:b0 + F] for b0 in range(0, len(pics), F)]
        shapes = [(F, 16 * mb_h, 16 * mb_w)] + [(F, 8 * mb_h, 8 * mb_w)] * 2
        sizes = [int(np.prod(sh)) for sh in shapes]
        if stacked_out or device_out:
            # the decode's planes on the device: one allocation per
            # plane, batch b's planes its slices.  A batch's call then
            # takes no card memory: with earlier batches' planes held,
            # the caching allocator serves a new ~50 MB block by
            # cudaMalloc, which held the call for 2-37 ms (H100,
            # chip_smoke's per-call counts)
            whole = [torch.empty((len(batches) * F, *sh[1:]),
                                 dtype=torch.uint8, device=dev)
                     for sh in shapes]
        staging = wire.take(dev, F, npad, n, START_CAPS, tm, pin=cuda)
        cur = 0

    def out_of(b):
        """The tensors batch b's planes are copied into: slices of the
        decode's device planes; for host frames on CUDA, views of one
        pinned host buffer (the D2H copy enqueued right behind the
        batch's compute, so harvesting batch k waits for batch k only);
        None for host frames on the CPU (the step's clones)."""
        if stacked_out or device_out:
            return [p[b * F:(b + 1) * F] for p in whole]
        if not cuda:
            return None
        buf = torch.empty(sum(sizes), dtype=torch.uint8, pin_memory=True)
        return [v.view(sh) for v, sh in zip(buf.split(sizes), shapes)]

    def into(r, out):
        """Planes r copied into `out` (None: r itself)."""
        if out is None:
            return r
        for o, t in zip(out, r):
            o.copy_(t, non_blocking=True)
        return out

    def copied():
        """The event after a batch's D2H copy (host frames on CUDA)."""
        if stacked_out or device_out or not cuda:
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        return ev

    def harvest(p):
        r, ev, nf = p
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

    for b, batch in enumerate(batches):
        host = pack_batch(staging, cur, batch, sps, pps, n_threads, tm)
        if host is None:
            # PCM samples ride their own host rows into the same device
            # path after densify (x264 never emits PCM)
            with tm.stage("pack"):
                rows = _pcm_batch_rows(batch, sps, pps, F, n, n_threads)
            with tm.stage("ship"):
                tm.count("wire_bytes", sum(a.nbytes for a in rows))
                i16, u8, pcm_y, pcm_c = (torch.from_numpy(a).to(dev)
                                         for a in rows)
            with tm.stage("dispatch"):
                r = into(get_model().decode_rows(i16, u8, pcm_y, pcm_c),
                         out_of(b)), copied(), len(batch)
            if pending is not None:
                with tm.stage("harvest"):
                    harvest(pending)
            pending = r
            continue
        W, ecap, ovcap = staging.caps
        with staged(tm, "hold", lambda: STEPS.hold(
                (dev, mb_w, mb_h, F, deblocked, c0, c1, W, ecap, ovcap),
                lambda: functools.partial(get_model(), W=W, ecap=ecap,
                                          ovcap=ovcap), [host], dev)
                if graph else contextlib.nullcontext()) as step:
            with tm.stage("ship"):
                tm.count("wire_bytes", host.numel())
                if graph:
                    step.load(host)
                else:
                    blob = host.to(dev, non_blocking=True) if cuda else host
                staging.shipped(cur, dev)
            with tm.stage("dispatch"):
                out = out_of(b)
                r = (step(out) if graph else
                     into(get_model()(blob, W, ecap, ovcap), out)), \
                    copied(), len(batch)
        if pending is not None:
            with tm.stage("harvest"):
                harvest(pending)
        pending = r
        cur ^= 1
    if pending is not None:
        with tm.stage("harvest"):
            harvest(pending)
    # the staging goes back to the keep once its copies drained
    with tm.stage("wait"):
        staging.drain()
    with tm.stage("alloc"):
        wire.give_back(dev, staging)
    return results


decode_annexb_gop_pipelined.fallback_calls = 0
