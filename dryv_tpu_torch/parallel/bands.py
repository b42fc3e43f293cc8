"""Band-sharded reconstruction with halo exchange.

Counterpart of ``dryv_tpu/parallel/bands.py``.  A picture's MB rows
split into contiguous bands over the mesh "band" axis.  Frames pipeline
through the bands: at step t, band b reconstructs frame group t - b with
one launch of kernel B2b and sends its bottom luma row and bottom chroma
rows to band b + 1, whose first MB row reads them as its above,
above-right and corner aprons at step t + 1.  Each band's slot runs on a
CUDA stream of its own; the halo copy is ordered by a CUDA event that the
next band's stream waits on before its B2b launch (its stage A goes
ahead), so on one card the bands overlap.  Each group of bands on one
device (``mesh.slot_groups``) replays as one captured CUDA graph, streams,
events and copies included; a halo that crosses from one group to the
next is copied card to card inside the sending group's graph into a
static buffer of the receiving group, and ordered by an external event,
and each group's graph copies its rows of the planes into the step's
planes on the first band's device.
Intra without the in-loop filter: filtering across a band boundary needs
a back-edge fixup, as the JAX version says.

``make_banded_p_recon_fn`` is the banded P recon: each band receives an
apron of reference rows from its neighbours and runs motion compensation
(kernel B4) and the residual add on its own rows.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
from torch.profiler import record_function

from ..graphs import Split, peer_copy
from ..kernels.inter import mc_frame
from ..kernels.transform import stage_a
from ..kernels.wavefront import intra_recon, recon_inputs
from ..pipeline import tables_for
from ..syntax import stack_frames, syntax_tensors
from .mesh import (cat, enable_peers, fork_streams, join_streams, on_stream,
                   run_eager, run_step, slot_groups, slot_streams, step_key)


@lru_cache(maxsize=None)
def band_schedule(mb_w: int, mb_h: int, n_bands: int):
    """Per-band diagonal schedule with band-LOCAL MB addresses, plus the
    inverse maps for local tile->plane assembly; a numpy copy of
    ``dryv_tpu/parallel/bands.py`` ``band_schedule``.

    Returns (rows, sched [n_bands, n_diag, K], d_of [n_bands, n_local],
    k_of [n_bands, n_local])."""
    rows = -(-mb_h // n_bands)
    n_diag = mb_w + 2 * (mb_h - 1)
    diags = [[[] for _ in range(n_diag)] for _ in range(n_bands)]
    for my in range(mb_h):
        b = my // rows
        for mx in range(mb_w):
            diags[b][mx + 2 * my].append((my - b * rows) * mb_w + mx)
    K = max((len(v) for band in diags for v in band), default=1)
    n_local = rows * mb_w
    sched = np.full((n_bands, n_diag, K), -1, dtype=np.int32)
    d_of = np.zeros((n_bands, n_local), dtype=np.int32)
    k_of = np.zeros((n_bands, n_local), dtype=np.int32)
    for b in range(n_bands):
        for d in range(n_diag):
            sched[b, d, :len(diags[b][d])] = diags[b][d]
            for k, a in enumerate(diags[b][d]):
                d_of[b, a] = d
                k_of[b, a] = k
    return rows, sched, d_of, k_of


def make_banded_gop_fn(mesh, mb_w: int, mb_h: int, F: int, Fi: int = 0,
                       axis: str = "band", graph: bool = True):
    """Band-pipelined whole-GOP reconstruction with kernel B2b.

    Counterpart of ``make_banded_gop_pallas_fn``
    (``dryv_tpu/parallel/bands.py`` :182-279).  MB rows are padded to
    B * rows (B bands of rows = ceil(mb_h / B)); each band runs stage A
    on its slot's device, with flat scaling lists as there.  F pictures
    go through in G = F / Fi groups of Fi, over G + B - 1 steps; the
    steps the JAX version clips and throws away are skipped.  Fi = 0
    takes the largest divisor of F not above F / B, so that the pipeline
    holds at least B groups.  For a stream with the in-loop filter on,
    the planes come back unfiltered, as from the JAX function.

    Returns a ``BandedGop``: run(fs_list, device_out=False) -> (y [F,
    16*mb_h, 16*mb_w], cb, cr) uint8 planes, cropped to the picture's MB
    rows: numpy, or with device_out tensors on the first band's device,
    ordered after the run on that device's current stream.  With `graph`
    (the default) a call copies each band's syntax into the static inputs
    of its key's step (slot devices, axis, mb_w, mb_h, F, Fi, the syntax
    tensors' names, and the slot groups when there are several) and
    replays the pipeline of each group of bands on one device, every
    band's stream with its halo copies, as a CUDA graph of its own
    (``mesh.STEPS``), the counterpart of the JAX version's
    ``jax.jit(shard_map(...))``; ``graph=False`` enqueues the same parts
    op by op on the inputs copied to the bands' devices, counted in
    ``STEPS.eager``.  ``run.graphed`` says which."""
    return BandedGop(mesh, mb_w, mb_h, F, Fi, axis, graph)


class BandedGop:
    """``make_banded_gop_fn``'s run.  ``step_args`` gives a call's key,
    the step's maker and its host inputs; a call replays the step, or
    runs the maker's parts op by op on the inputs copied to the bands'
    devices."""

    def __init__(self, mesh, mb_w, mb_h, F, Fi, axis, graph=True):
        self.devs = mesh.axis_devices(axis)
        B = self.B = len(self.devs)
        self.rows = band_schedule(mb_w, mb_h, B)[0]
        if not Fi:
            Fi = max(d for d in range(1, max(1, F // B) + 1) if F % d == 0)
        if F % Fi:
            raise ValueError(f"F={F} is not a multiple of Fi={Fi}")
        self.mb_w, self.mb_h, self.F, self.Fi = mb_w, mb_h, F, Fi
        self.axis = axis
        self.tabs = [tables_for(d) for d in self.devs]
        self.graphed = graph

    def __call__(self, fs_list, device_out=False):
        key, make, xs = self.step_args(fs_list)
        if self.graphed:
            planes = run_step(key, make, xs)
        else:
            planes = run_eager(make(), xs)
        return planes if device_out else tuple(p.cpu().numpy()
                                               for p in planes)

    def step_args(self, fs_list):
        """(key, maker, inputs) of this call's step: the inputs are each
        band's syntax tensors on the host, MB rows padded with zero
        syntax to B * rows, in the key's name order; the maker's ``Split``
        takes them on the bands' devices and runs ``reconstruct`` on each
        group of bands."""
        F, B, n_local = self.F, self.B, self.rows * self.mb_w
        if len(fs_list) != F:
            raise ValueError(f"expected {F} pictures, got {len(fs_list)}")
        stacked = stack_frames(fs_list)
        for k, a in stacked.items():
            if a.shape[1] != B * n_local:
                stacked[k] = np.concatenate(
                    [a, np.zeros((F, B * n_local - a.shape[1])
                                 + a.shape[2:], a.dtype)], axis=1)
        s = syntax_tensors(stacked, "cpu")
        names = tuple(sorted(s))
        xs = [s[name][:, b * n_local:(b + 1) * n_local]
              for b in range(B) for name in names]
        groups = slot_groups(self.devs)
        return (step_key((tuple(self.devs), self.axis, self.mb_w, self.mb_h,
                          F, self.Fi, names), groups),
                lambda: self.split(names, groups), xs)

    def split(self, names, groups):
        """The step's parts, one per group of bands: each runs
        ``reconstruct`` on its bands; a group below another takes its
        first band's halos from static buffers that the group above
        fills (``_Halos``).  Each group's rows go into the step's planes
        on the first band's device (``graphs.peer_copy``); the results are
        those planes cropped."""
        k, devs = len(names), self.devs
        streams = slot_streams(devs)
        halos = _Halos(devs, groups, self.F // self.Fi, self.Fi, self.mb_w)

        def part(g):
            recv = halos.recv(g.start) if g.start else None
            send = halos.send(g.stop) if g.stop < self.B else None
            return lambda *xs: self.reconstruct(
                [dict(zip(names, xs[j * k:(j + 1) * k]))
                 for j in range(len(g))], g.start,
                [streams[i] for i in g], recv, send)

        return Split([(devs[g.start], k * len(g), part(g)) for g in groups],
                     dim=1, view=self.crop)

    def crop(self, planes):
        """(y, cb, cr) cut to the picture's MB rows: views."""
        return tuple(p[:, :(16 if i == 0 else 8) * self.mb_h]
                     for i, p in enumerate(planes))

    def reconstruct(self, syn, lo, streams, recv=None, send=None):
        """The pipeline over bands lo, lo + 1, ... (syn: each one's syntax
        tensors on its device), on the slot `streams`, forked from the
        current stream and joined to it again.  The first band's halo of
        group g is ``recv(g)`` -> (halo, event to wait for), or a zero
        halo for band 0, as the JAX carry; the last band hands group g's
        planes to ``send(g, y, cb, cr)`` when a band lies below it.
        Returns the bands' planes stacked along their rows on their
        device (a group's bands share one), uncropped."""
        nb, Fi = len(syn), self.Fi
        devs = self.devs[lo:lo + nb]
        mb_w, rows, G = self.mb_w, self.rows, self.F // Fi
        fork_streams(devs, streams)
        halo, ready = [None] * nb, [None] * nb
        if recv is None:
            with on_stream(streams[0]):
                halo[0] = (torch.zeros((Fi, 16 * mb_w), dtype=torch.uint8,
                                       device=devs[0]),
                           torch.zeros((Fi, 2, 8 * mb_w), dtype=torch.uint8,
                                       device=devs[0]))
        planes = [[] for _ in range(nb)]
        for t in range(G + nb - 1):
            sent = {}
            for b in range(max(0, t - G + 1), min(nb, t + 1)):
                g = t - b
                with on_stream(streams[b]):
                    sg = {k: v[g * Fi:(g + 1) * Fi]
                          for k, v in syn[b].items()}
                    with record_function("stage_a"):
                        res = stage_a(sg, self.tabs[lo + b])
                    with record_function("recon_inputs"):
                        ins = recon_inputs(sg, *res)
                    if b == 0 and recv is not None:
                        halo[0], ready[0] = recv(g)
                    # only B2b reads the halo: stage A runs before the
                    # wait, beside the band above's work
                    if ready[b] is not None:
                        streams[b].wait_event(ready[b])
                    y, cb, cr = intra_recon(*ins, self.tabs[lo + b], mb_w,
                                            rows, halo=halo[b])
                    planes[b].append((y, cb, cr))
                    if b + 1 < nb:
                        sent[b + 1] = _send(y, cb, cr, devs[b + 1],
                                            streams[b], streams[b + 1])
                    elif send is not None:
                        send(g, y, cb, cr)
            for b, (h, ev) in sent.items():
                halo[b], ready[b] = h, ev
        join_streams(devs, streams)
        out = []
        for p in range(3):
            parts = []
            for b in range(nb):
                for pl in planes[b]:
                    if streams[b] is not None:
                        pl[p].record_stream(
                            torch.cuda.current_stream(devs[b]))
                parts.append(cat([pl[p] for pl in planes[b]]))
            out.append(cat(parts, 1))
        return tuple(out)


class _Halos:
    """The halos that cross from one group of bands to the next: for the
    first band r of every group but the first, one static buffer per
    frame group g on r's device, (bottom luma row [Fi, W], bottom chroma
    rows [Fi, 2, W/2]) of band r - 1, made with the step, and on CUDA
    the external event that the sending group's graph records after its
    copy and the receiving group's graph waits on before B2b.  One
    buffer and event per frame group: each is written once a call."""

    def __init__(self, devs, groups, G, Fi, mb_w):
        self.bufs, self.events = {}, {}
        for grp in groups[1:]:
            d = devs[grp.start]
            self.bufs[grp.start] = [
                (torch.empty((Fi, 16 * mb_w), dtype=torch.uint8, device=d),
                 torch.empty((Fi, 2, 8 * mb_w), dtype=torch.uint8,
                             device=d)) for _ in range(G)]
            self.events[grp.start] = [
                torch.cuda.Event(external=True) if d.type == "cuda"
                else None for _ in range(G)]
        enable_peers(devs)

    def recv(self, r):
        """Band r's halo of group g and its event: r's recv(g)."""
        return lambda g: (self.bufs[r][g], self.events[r][g])

    def send(self, r):
        """send(g, y, cb, cr) of band r - 1: its bottom rows card to card
        into band r's buffers of group g, on the current stream of the
        sending band, then the event."""
        def fn(g, y, cb, cr):
            hy, hc = self.bufs[r][g]
            peer_copy(hy, y[:, -1].contiguous())
            peer_copy(hc, torch.stack([cb[:, -1], cr[:, -1]], 1))
            ev = self.events[r][g]
            if ev is not None:
                ev.record(torch.cuda.current_stream(y.device))
        return fn


def _copy(t, to, src, dst):
    """t copied to device `to` on the current stream, `src` (None on the
    CPU), and the CUDA event (None on the CPU) after which stream `dst`
    may read the copy."""
    out = t.to(to, non_blocking=True)
    if src is None:
        return out, None
    out.record_stream(dst)
    ev = torch.cuda.Event()
    ev.record(src)
    return out, ev


def _send(y, cb, cr, to, src_stream, dst_stream):
    """Band planes -> (bottom luma row [Fi, W], bottom chroma rows [Fi,
    2, W/2]) on device `to`, and the CUDA event (None on the CPU) after
    which `dst_stream` may read them."""
    hy, _ = _copy(y[:, -1].contiguous(), to, src_stream, dst_stream)
    hc, ev = _copy(torch.stack([cb[:, -1], cr[:, -1]], 1), to, src_stream,
                   dst_stream)
    return (hy, hc), ev


def make_banded_frame_fn(mesh, mb_w: int, mb_h: int, axis: str = "band",
                         graph: bool = True):
    """Full-frame band-sharded reconstruction of one picture.

    Counterpart of ``make_banded_frame_fn`` (``dryv_tpu/parallel/
    bands.py`` :55), same contract: run(fs, device_out=False) -> cropped
    (y, cb, cr).  The JAX version exchanges frontier rows after every
    diagonal; here it is ``make_banded_gop_fn`` with F = Fi = 1, which
    gives the same planes from one halo per band boundary.  On a 2-D
    mesh it uses the band axis, as the original does.  `graph` and
    ``run.graphed`` are ``make_banded_gop_fn``'s; ``run.step_args(fs)``
    gives a call's key, the step's maker and its host inputs."""
    run_gop = make_banded_gop_fn(mesh, mb_w, mb_h, 1, Fi=1, axis=axis,
                                 graph=graph)

    def run(fs, device_out=False):
        return tuple(p[0] for p in run_gop([fs], device_out))

    run.graphed = run_gop.graphed
    run.step_args = lambda fs: run_gop.step_args([fs])
    return run


make_banded_wavefront_fn = make_banded_frame_fn   # the JAX package's name


def _hop(t, to, src, dst):
    """``_copy`` of t on stream `src`; stream `dst` waits for the copy
    before its later work reads the result."""
    with on_stream(src):
        out, ev = _copy(t, to, src, dst)
    if ev is not None:
        dst.wait_event(ev)
    return out


def _extend(planes, a, total, devs, streams, first=0, keep=None):
    """Each band's extended plane: band b's rows with `a` rows above and
    below, rows outside the picture replicating its edge rows, so that a
    clamp inside the extended plane is the global clamp.  planes[b] is
    band first + b's [rows, W] on devs[b] (of `total` rows in all); the
    apron rows come from the neighbours in ceil(a / rows) chained hops
    (each band forwards what it received), each ordered by an event on
    the receiving slot's stream, as ``make_banded_gop_fn`` orders its
    halos.  Returns the extended planes of the bands in `keep` (default:
    all)."""
    B = len(planes)
    rows = planes[0].shape[0]
    above = [[] for _ in range(B)]
    below = [[] for _ in range(B)]
    cur_d, cur_u = list(planes), list(planes)
    for _ in range(-(-a // rows)):
        nxt_d, nxt_u = [None] * B, [None] * B
        for b in range(B):
            if b + 1 < B and cur_d[b] is not None:
                nxt_d[b + 1] = _hop(cur_d[b], devs[b + 1], streams[b],
                                    streams[b + 1])
                above[b + 1].insert(0, nxt_d[b + 1])
            if b > 0 and cur_u[b] is not None:
                nxt_u[b - 1] = _hop(cur_u[b], devs[b - 1], streams[b],
                                    streams[b - 1])
                below[b - 1].append(nxt_u[b - 1])
        cur_d, cur_u = nxt_d, nxt_u
    out = []
    for b in range(B) if keep is None else keep:
        with on_stream(streams[b]):
            rows_b = torch.cat(above[b] + [planes[b]] + below[b])
            start = (first + b - len(above[b])) * rows
            g = (torch.arange(rows + 2 * a, device=devs[b])
                 + (first + b) * rows - a)
            out.append(rows_b[g.clamp(0, total - 1) - start])
    return out


def make_banded_p_recon_fn(mesh, mb_w: int, mb_h: int, apron: int,
                           axis: str = "band", graph: bool = True):
    """Banded P recon: returns run(ref_y, ref_cb, ref_cr, mv [n4,2], rs
    [n4], y_resid [n,16,16], c_resid [n,2,8,8], device_out=False) ->
    (y, cb, cr) uint8 planes for a single-reference P picture with no
    intra MBs (blocks with rs < 0 predict 0).

    Counterpart of ``dryv_tpu/parallel/bands.py`` :293-407.  MB rows
    split evenly over the mesh's `axis`; each band receives `apron`
    reference rows from each neighbour band (``_extend``: chained hops
    when the apron exceeds a band's height), remapped so that the clamp
    inside its extended plane is the global one, then runs B4 on that
    plane (its block rows offset by apron / 4) and the residual add on its
    own slot's stream.  The vertical reach of the vectors (integer rows
    plus the 6-tap margin) must stay within the apron: run() asserts it,
    as the JAX version does.  Planes come back numpy, or with device_out
    tensors on the first band's device.  With `graph` (the default) each
    band's reference rows, vectors, slots and residuals are copied into
    the static inputs of the key's step (slot devices, axis, mb_w, mb_h,
    apron, and the slot groups when there are several), and each group
    of bands on one device replays as a CUDA graph of its own
    (``mesh.STEPS``): it pulls the reference rows of the bands around it
    that its aprons reach (ghost bands) card to card from their owners'
    static inputs, then runs the apron hops among its bands, B4 and the
    residual add, and copies its rows into the step's planes on the
    first band's device, as the JAX version's aprons arrive by
    ``ppermute`` inside its one jitted program.
    ``graph=False`` enqueues the same parts op by op on the inputs copied
    to the bands' devices, counted in ``STEPS.eager``.  ``run.graphed``
    says which; ``run.step_args(*args)`` gives a call's key, the step's
    maker and its host inputs."""
    devs = mesh.axis_devices(axis)
    B = len(devs)
    if mb_h % B:
        raise ValueError("bands must split MB rows evenly")
    hb = mb_h // B
    A = apron
    groups = slot_groups(devs)

    def step_args(ref_y, ref_cb, ref_cr, mv, rs, y_resid, c_resid):
        """(key, maker, inputs) of a call's step, after the reach check:
        the inputs are each band's reference rows, vectors, slots and
        residuals on the host."""
        mv = np.asarray(mv)
        reach = int(np.max(np.abs(mv[:, 1]))) // 4 + 9
        assert reach <= A, f"vertical MV reach {reach} exceeds apron {A}"
        n4l = 16 * hb * mb_w
        nl = hb * mb_w
        refs = [np.asarray(p, np.uint8) for p in (ref_y, ref_cb, ref_cr)]
        mv16 = np.ascontiguousarray(mv, np.int16)
        slot = np.where(np.asarray(rs) >= 0, 0, -1).astype(np.int8)
        yr = np.asarray(y_resid, np.int32)
        cr_ = np.asarray(c_resid, np.int32)
        xs = []
        for b in range(B):
            xs += [torch.from_numpy(p[b * len(p) // B:(b + 1) * len(p) // B])
                   for p in refs]
            xs += [torch.from_numpy(a[b * k:(b + 1) * k])
                   for a, k in ((mv16, n4l), (slot, n4l), (yr, nl),
                                (cr_, nl))]
        return (step_key((tuple(devs), axis, mb_w, mb_h, A), groups),
                lambda: _p_recon_split(devs, groups, mb_w, hb, A), xs)

    def run(*args, device_out=False):
        key, make, xs = step_args(*args)
        if run.graphed:
            planes = run_step(key, make, xs)
        else:
            planes = run_eager(make(), xs)
        return planes if device_out else tuple(p.cpu().numpy()
                                               for p in planes)

    run.step_args = step_args
    run.graphed = graph
    return run


def _p_recon_split(devs, groups, mb_w, hb, A):
    """Banded P recon's step as one part per group of bands.  A group's
    ghost bands are the ceil(A / rows) bands on each side of it that its
    aprons reach: the part reads their reference rows (``Split.reads``)
    and pulls them to its device itself; its rows of the planes go into
    the step's planes on devs[0]."""
    B = len(devs)
    streams = slot_streams(devs)
    enable_peers(devs)
    m = -(-A // (16 * hb))
    parts, reads = [], []
    for g in groups:
        ghosts = (range(max(0, g.start - m), g.start),
                  range(g.stop, min(B, g.stop + m)))
        parts.append((devs[g.start], 7 * len(g),
                      _p_recon_fn([devs[i] for i in g],
                                  [streams[i] for i in g], mb_w, hb, A, B,
                                  g.start, len(ghosts[0]))))
        reads.append(tuple(7 * b + p for bands in ghosts for b in bands
                           for p in range(3)))
    return Split(parts, reads=reads)


def _p_recon_fn(devs, streams, mb_w, hb, A, B, first=0, n_up=0):
    """A part's function, captured or run op by op: fn(*each of its
    bands' ref_y, ref_cb, ref_cr rows, mv, slots, y_resid, c_resid on its
    device, *the (ref_y, ref_cb, ref_cr) rows of its ghost bands on their
    owners' devices, the n_up above its bands first) -> (y, cb, cr) of
    its bands stacked on its device (a group's bands share one).  Its
    bands are bands first, first + 1, ... of B.  The ghost rows are
    pulled card to card on the current stream (``graphs.peer_copy``), the
    slot streams fork from it; the apron hops, B4 and the residual add
    run on each band's stream, and the planes are stacked after the
    join."""
    nb = len(devs)
    dev = devs[0]

    def fn(*xs):
        ghosts = []
        for i in range(7 * nb, len(xs), 3):
            bufs = tuple(torch.empty_like(x, device=dev)
                         for x in xs[i:i + 3])
            for dst, src in zip(bufs, xs[i:i + 3]):
                peer_copy(dst, src, pull=True)
            ghosts.append(bufs)
        up, down = ghosts[:n_up], ghosts[n_up:]
        gdevs = [dev] * len(up) + list(devs) + [dev] * len(down)
        gstreams = ([streams[0]] * len(up) + list(streams)
                    + [streams[-1]] * len(down))
        keep = range(len(up), len(up) + nb)
        fork_streams(devs, streams)
        band = [xs[7 * b:7 * (b + 1)] for b in range(nb)]
        ext = [_extend([u[p] for u in up] + [bd[p] for bd in band]
                       + [d[p] for d in down], a, B * band[0][p].shape[0],
                       gdevs, gstreams, first - len(up), keep)
               for p, a in ((0, A), (1, A // 2), (2, A // 2))]
        parts = []
        for b, st in enumerate(streams):
            with on_stream(st):
                mvb, sb, yrb, crb = band[b][3:]
                py, pc = mc_frame(ext[0][b][None], ext[1][b][None],
                                  ext[2][b][None], sb, None, mvb, None,
                                  {"mode": 0}, mb_w, hb, row0=A // 4)
                ty = (py.to(torch.int32) + yrb).clamp(0, 255) \
                    .to(torch.uint8)
                tc = (pc.to(torch.int32) + crb).clamp(0, 255) \
                    .to(torch.uint8)
                parts.append((
                    ty.view(hb, mb_w, 16, 16).permute(0, 2, 1, 3)
                    .reshape(16 * hb, 16 * mb_w),
                    tc[:, 0].reshape(hb, mb_w, 8, 8).permute(0, 2, 1, 3)
                    .reshape(8 * hb, 8 * mb_w),
                    tc[:, 1].reshape(hb, mb_w, 8, 8).permute(0, 2, 1, 3)
                    .reshape(8 * hb, 8 * mb_w)))
        join_streams(devs, streams)
        out = []
        for p in range(3):
            for b in range(nb):
                if streams[b] is not None:
                    parts[b][p].record_stream(
                        torch.cuda.current_stream(devs[b]))
            out.append(cat([parts[b][p] for b in range(nb)]))
        return tuple(out)
    return fn
