"""The packed wire: the blob the host packs and the card decodes, for both
decode entries, and its host staging.

One uint8 blob carries a batch of F pictures (F = 1 on the I/P/B path),
each segment at a 64-byte aligned offset:

- ``bmp`` [F, npad, 51]: one bit per coefficient lane of an MB's 408;
- ``vals`` [F, npad, W]: the MB's nonzero levels in lane order, int8;
- ``exc_idx``, ``exc_delta`` [F, ecap]: the |v| > 127 corrections;
- ``ovf_idx``, ``ovf_rows`` [F, ovcap], [F, ovcap, 408]: MBs with more
  than W nonzeros ship their whole int16 row; a pad slot holds npad;
- ``u8`` [F, n, 19]: the per-MB bytes (layout of ``U8_STRIDE``);
- on the I/P/B path (``n4``, the 4x4 blocks of a picture) the motion
  field and the weighted-prediction tables: ``mv``, ``rsri``,
  ``wp_expl``, ``wp_imp``, ``misc``.

The caps (W, ecap, ovcap) are static, part of each captured step's key.
``Staging`` holds a call's blobs; each entry starts it at its own caps
and grows it by its own rule (``gop_pipeline._needs``,
``device_ipb_packed._needs``), on the pieces here (``round_cap``,
``dense``).  A call takes its staging from the process's keep
(``take``) and gives it back on return (``give_back``), so the next call
of the same geometry, batch size and entry starts at the caps this one
grew to, unless it needed no more than the start caps (``fits``).  On
the card ``split``, ``dense_rows`` (kernel B1 and the fixes),
``wire_syntax`` and ``dbctl`` read the blob back.

The layout stands for both of the JAX package's helper sets, which
import jax: ``dryv_tpu/gop_pipeline.py``'s ``_BLOB_SPEC``,
``_blob_layout``, ``_alloc_blob``, ``_round_cap``, ``I16_STRIDE`` and
``U8_STRIDE``, and ``dryv_tpu/device_ipb_packed.py``'s ``_IPB_SPEC``,
``_layout`` and ``_alloc``; ``tests/test_torch_helpers.py`` holds
``layout`` and ``alloc`` equal to both.
"""
from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as np
import torch
from torch.profiler import record_function

from .kernels.densify import densify
from .kernels.geometry import NB, L
from .tables import chroma_qp

I16_STRIDE = L      # luma_lv 256 | luma_dc 16 | chroma_dc 8 | chroma_ac 128
U8_STRIDE = 19      # kind qp_y i16_mode chroma_mode | modes4 8 (nibbles)
                    # | modes8 2 (nibbles) | sid_lo sid_hi
                    # | dis offa+12 offb+12   (entropy.cc kMetaStride)
W_MAX = 256         # the largest vals stride

# (name, dtype, shape at (F, npad, n, W, ecap, ovcap, n4)); the first
# COEFF are every blob's, the rest the I/P/B blob's (F = 1)
SEGMENTS = (
    ("bmp", np.uint8, lambda F, npad, n, W, e, o, n4: (F, npad, NB)),
    ("vals", np.int8, lambda F, npad, n, W, e, o, n4: (F, npad, W)),
    ("exc_idx", np.int32, lambda F, npad, n, W, e, o, n4: (F, e)),
    ("exc_delta", np.int16, lambda F, npad, n, W, e, o, n4: (F, e)),
    ("ovf_idx", np.int32, lambda F, npad, n, W, e, o, n4: (F, o)),
    ("ovf_rows", np.int16,
     lambda F, npad, n, W, e, o, n4: (F, o, I16_STRIDE)),
    ("u8", np.uint8, lambda F, npad, n, W, e, o, n4: (F, n, U8_STRIDE)),
    ("mv", np.int16, lambda F, npad, n, W, e, o, n4: (n4, 2, 2)),
    ("rsri", np.int8, lambda F, npad, n, W, e, o, n4: (n4, 4)),
    ("wp_expl", np.int16, lambda F, npad, n, W, e, o, n4: (2, 32, 6)),
    ("wp_imp", np.int16, lambda F, npad, n, W, e, o, n4: (256, 2)),
    ("misc", np.int32, lambda F, npad, n, W, e, o, n4: (4,)))
COEFF = 7

# a picture's views, in the order the native pack takes them (cnt, the
# pack's per-MB value counts, rides beside the blob)
NATIVE_VIEWS = ("bmp", "vals", "cnt", "u8", "exc_idx", "exc_delta",
                "ovf_idx", "ovf_rows")

_TORCH_DTYPE = {np.dtype(np.uint8): torch.uint8, np.dtype(np.int8): torch.int8,
                np.dtype(np.int16): torch.int16,
                np.dtype(np.int32): torch.int32}


def layout(F, npad, n, W, ecap, ovcap, n4=0):
    """({name: (offset, shape, numpy dtype)}, total bytes): the coefficient
    segments, and the motion segments too when `n4` is given."""
    offs = {}
    t = 0
    for name, dt, shape_of in SEGMENTS[:None if n4 else COEFF]:
        t = (t + 63) & ~63
        shape = shape_of(F, npad, n, W, ecap, ovcap, n4)
        offs[name] = (t, shape, dt)
        t += int(np.prod(shape)) * np.dtype(dt).itemsize
    return offs, t


def alloc(F, npad, n, W, ecap, ovcap, n4=0, pin=False):
    """The blob (numpy, backed by a torch tensor in pinned memory when
    `pin`) and its numpy views by segment name; every overflow slot a
    pad."""
    offs, total = layout(F, npad, n, W, ecap, ovcap, n4)
    blob = torch.zeros(total, dtype=torch.uint8, pin_memory=pin).numpy()
    views = {name: np.ndarray(shape, dt, buffer=blob, offset=off)
             for name, (off, shape, dt) in offs.items()}
    views["ovf_idx"][:] = npad
    return blob, views


def round_cap(x, q):
    """x rounded up to the quantum q (a power of two), at least q."""
    return max(q, (int(x) + q - 1) & ~(q - 1))


def dense(maxnz, novf, W, npad):
    """Whether a picture packed at vals stride W asks for a wider one: an
    MB held more than W nonzeros, W can grow, and its overflow rows
    (2 x 408 bytes an MB) outweigh 32 bytes for each of the npad MBs.
    Takes numbers or numpy arrays of them."""
    return (maxnz > W) & (W < W_MAX) & (novf * 2 * I16_STRIDE > npad * 32)


def fits(caps, npad, cnt, maxnz, nexc, novf):
    """Whether a picture that packed at caps no smaller than `caps` (W,
    ecap, ovcap), with `cnt` its MBs' value counts and (maxnz, nexc,
    novf) its counts there, packs at `caps` with no growth by either
    entry's rule: at the smaller W its overflow MBs are those that
    overflowed here and those that held more than W values here, its
    exceptions (counted in MBs that fit) are at most those here, and it
    is not dense (``dense``)."""
    W, ecap, ovcap = caps
    novf = novf + int(np.count_nonzero(cnt > W))
    return nexc <= ecap and novf <= ovcap and \
        not dense(maxnz, novf, W, npad)


class Staging:
    """A call's host staging of the wire: `slots` blobs (pinned when
    `pin`) for batches of F pictures, made at `caps` (W, ecap, ovcap),
    each with its numpy views by segment name, ``cnt`` [F, npad] and the
    blob (``_blob``) in ``bufs``.  A slot is refilled only after the
    device copy that read it completed: ``shipped`` records that copy's
    event, ``wait`` waits for it.  ``caps`` is the caps now; they only
    grow (``grow``) from ``start``, the caps it was made at.  ``light``
    holds while every picture of the call (``note``) would have packed
    at ``start`` with no growth.  A slot holds what earlier packs left
    (a kept staging's, earlier calls'): a pack writes every byte the
    device decode reads, and ``clear`` readies the rest."""

    def __init__(self, F, npad, n, caps, n4=0, pin=False, slots=2):
        self.F, self.npad, self.n, self.n4, self.pin = F, npad, n, n4, pin
        self.start = self.caps = tuple(caps)
        self.light = True
        self.ev = [None] * slots
        self.bufs = [self._alloc() for _ in range(slots)]

    def _alloc(self):
        blob, views = alloc(self.F, self.npad, self.n, *self.caps,
                            n4=self.n4, pin=self.pin)
        views["cnt"] = np.zeros((self.F, self.npad), np.int32)
        views["_blob"] = blob
        return views

    def blob(self, k):
        """Slot k's blob as a uint8 tensor."""
        return torch.from_numpy(self.bufs[k]["_blob"])

    def views(self, k, i):
        """Picture i of slot k, as the native pack takes it."""
        return tuple(self.bufs[k][key][i] for key in NATIVE_VIEWS)

    def clear(self, k, pics, again=False):
        """Ready pictures `pics` of slot k for a pack: no exceptions and
        every overflow slot a pad; `again` (a pack after a growth) also
        zeroes the overflow rows the earlier pack left past its count."""
        b = self.bufs[k]
        if again:
            b["ovf_rows"][pics] = 0
        b["exc_idx"][pics] = 0
        b["exc_delta"][pics] = 0
        b["ovf_idx"][pics] = self.npad

    def note(self, k, i, maxnz, nexc, novf):
        """Picture i of slot k packed at the caps now with the counts
        (maxnz, nexc, novf): ``light`` ends unless it fits ``start``."""
        if self.light and self.caps != self.start:
            self.light = fits(self.start, self.npad,
                              self.bufs[k]["cnt"][i, :self.n], maxnz, nexc,
                              novf)

    def shipped(self, k, dev):
        """Record the copy of slot k just enqueued (pinned slots only)."""
        if self.pin:
            self.ev[k] = torch.cuda.Event()
            self.ev[k].record(torch.cuda.current_stream(dev))

    def wait(self, k, tm):
        """Wait, in `tm`'s stage wait, for the copy that last read slot k."""
        if self.ev[k] is not None:
            with tm.stage("wait"):
                self.ev[k].synchronize()

    def drain(self):
        for ev in self.ev:
            if ev is not None:
                ev.synchronize()

    def grow(self, caps, tm):
        """New blobs at `caps`, each holding every segment the old one
        held (in its leading corner), once the copies drained (stages
        wait and alloc of `tm`)."""
        with tm.stage("wait"):
            self.drain()
        with tm.stage("alloc"):
            self.caps = tuple(caps)
            self.light = False
            for k, old in enumerate(self.bufs):
                new = self._alloc()
                for name in old:
                    if name != "_blob":
                        new[name][tuple(map(slice, old[name].shape))] = \
                            old[name]
                self.bufs[k] = new


# the most keys a keep holds idle stagings of: a process decodes a few
# geometries and batch sizes, each staging up to ~300 MB of pinned memory
KEEP_KEYS = 4


class StagingKeep:
    """Idle stagings kept between calls, so that a call starts at the
    caps the last call of its key grew to and makes no blobs: at most
    one a key and ``KEEP_KEYS`` keys, a new key past that releasing the
    least recently given back.  A key is (device, F, npad, n, n4, pin);
    n4 keeps the two entries' stagings apart (0 on the batched entry).
    A staging taken is out of the keep until it is given back, so two
    callers of one key at once never share one: the second makes its
    own.  The caps kept are the high-water mark of the calls that needed
    more than the start caps: a call whose every picture fit them
    (``Staging.light``) leaves the key empty, so the next call starts
    anew at them, as it would with no keep."""

    def __init__(self):
        self.idle: OrderedDict = OrderedDict()
        self.lock = threading.Lock()

    def take(self, device, F, npad, n, start, tm, n4=0, pin=False):
        """The idle staging of the key, with its slots, events and grown
        caps (counted as ``staging_kept`` in `tm`), or else a new one at
        the start caps."""
        with self.lock:
            st = self.idle.pop((device, F, npad, n, n4, pin), None)
        if st is None:
            return Staging(F, npad, n, start, n4=n4, pin=pin)
        tm.count("staging_kept", 1)
        st.light = True
        return st

    def give_back(self, device, st):
        """Keep `st`, drained, for the next call of its key on `device`
        (in place of an idle one a concurrent caller gave back first),
        unless its call fit the start caps it grew past."""
        key = (device, st.F, st.npad, st.n, st.n4, st.pin)
        with self.lock:
            self.idle.pop(key, None)
            if st.light and st.caps != st.start:
                return
            self.idle[key] = st
            while len(self.idle) > KEEP_KEYS:
                self.idle.popitem(last=False)

    def release(self):
        """Drop every kept staging (its host memory goes back to torch's
        allocators)."""
        with self.lock:
            self.idle.clear()


# the process's keep, which both entries take their stagings from
KEEP = StagingKeep()
take, give_back, release = KEEP.take, KEEP.give_back, KEEP.release


def dbctl_of(headers):
    """Per-slice deblock control rows (disable_idc, alpha_off, beta_off),
    int32 [n_slices, 3]: what the pack writes into each MB's u8 bytes
    16-18 (offsets + 12)."""
    return np.asarray([(1, 0, 0) if h.deblocking is not None
                       and h.deblocking.disable_idc == 1 else
                       (0, 0, 0) if h.deblocking is None else
                       (h.deblocking.disable_idc,
                        h.deblocking.alpha_c0_offset_div2 * 2,
                        h.deblocking.beta_offset_div2 * 2)
                       for h in headers], np.int32)


def split(blob, offs):
    """Typed views of a device blob's segments; offs maps each name to
    (offset, shape, numpy dtype), as ``layout`` returns them."""
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
    bytes u8 [F, n, 19]: ``dbctl_of``'s rows as the pack wrote them."""
    dis, offa, offb = u8[..., 16:19].to(torch.int32).unbind(-1)
    return dis.contiguous(), offa - 12, offb - 12
