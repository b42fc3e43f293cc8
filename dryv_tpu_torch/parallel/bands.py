"""Band-sharded reconstruction with halo exchange.

Counterpart of ``dryv_tpu/parallel/bands.py``.  A picture's MB rows
split into contiguous bands over the mesh "band" axis.  Frames pipeline
through the bands: at step t, band b reconstructs frame group t - b with
one launch of kernel B2b and sends its bottom luma row and bottom chroma
rows to band b + 1, whose first MB row reads them as its above,
above-right and corner aprons at step t + 1.  Each band's slot runs on a
CUDA stream of its own; the halo copy is ordered by a CUDA event that the
next band's stream waits on, so on one card the bands overlap and on
several the copy goes peer to peer.  Intra without the in-loop filter:
filtering across a band boundary needs a back-edge fixup, as the JAX
version says.

``make_banded_p_recon_fn`` is the banded P recon: each band receives an
apron of reference rows from its neighbours and runs motion compensation
(kernel B4) and the residual add on its own rows.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..kernels.inter import mc_frame
from ..pipeline import recon_syntax, tables_for
from ..syntax import stack_frames, syntax_tensors
from .mesh import fork_streams, join_streams, on_stream, slot_streams


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
                       axis: str = "band"):
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
    ordered after the run on that device's current stream."""
    return BandedGop(mesh, mb_w, mb_h, F, Fi, axis)


class BandedGop:
    """``make_banded_gop_fn``'s run: ``upload`` puts each band's syntax
    on its slot's device, ``reconstruct`` runs the pipeline on it, and a
    call does both."""

    def __init__(self, mesh, mb_w, mb_h, F, Fi, axis):
        self.devs = mesh.axis_devices(axis)
        B = self.B = len(self.devs)
        self.rows = band_schedule(mb_w, mb_h, B)[0]
        if not Fi:
            Fi = max(d for d in range(1, max(1, F // B) + 1) if F % d == 0)
        if F % Fi:
            raise ValueError(f"F={F} is not a multiple of Fi={Fi}")
        self.mb_w, self.mb_h, self.F, self.Fi = mb_w, mb_h, F, Fi
        self.tabs = [tables_for(d) for d in self.devs]
        self.streams = slot_streams(self.devs)

    def __call__(self, fs_list, device_out=False):
        return self.reconstruct(self.upload(fs_list), device_out)

    def upload(self, fs_list):
        """FrameSyntax list -> per band, its syntax tensors on its device
        (MB rows padded with zero syntax to B * rows)."""
        F, B, n_local = self.F, self.B, self.rows * self.mb_w
        if len(fs_list) != F:
            raise ValueError(f"expected {F} pictures, got {len(fs_list)}")
        stacked = stack_frames(fs_list)
        for k, a in stacked.items():
            if a.shape[1] != B * n_local:
                stacked[k] = np.concatenate(
                    [a, np.zeros((F, B * n_local - a.shape[1])
                                 + a.shape[2:], a.dtype)], axis=1)
        fork_streams(self.devs, self.streams)
        syn = []
        for b, (dev, st) in enumerate(zip(self.devs, self.streams)):
            with on_stream(st):
                syn.append(syntax_tensors(
                    {k: v[:, b * n_local:(b + 1) * n_local]
                     for k, v in stacked.items()}, dev))
        join_streams(self.devs, self.streams)
        return syn

    def reconstruct(self, syn, device_out=False):
        """The pipeline over ``upload``'s syntax; returns the planes."""
        devs, streams, B, Fi = self.devs, self.streams, self.B, self.Fi
        mb_w, rows, G = self.mb_w, self.rows, self.F // Fi
        fork_streams(devs, streams)
        with on_stream(streams[0]):
            # band 0 has no band above: a zero halo, as the JAX carry
            halo = [(torch.zeros((Fi, 16 * mb_w), dtype=torch.uint8,
                                 device=devs[0]),
                     torch.zeros((Fi, 2, 8 * mb_w), dtype=torch.uint8,
                                 device=devs[0]))] + [None] * (B - 1)
        ready = [None] * B
        planes = [[] for _ in range(B)]
        for t in range(G + B - 1):
            sent = {}
            for b in range(max(0, t - G + 1), min(B, t + 1)):
                g = t - b
                with on_stream(streams[b]):
                    if ready[b] is not None:
                        streams[b].wait_event(ready[b])
                    sg = {k: v[g * Fi:(g + 1) * Fi]
                          for k, v in syn[b].items()}
                    y, cb, cr = recon_syntax(sg, self.tabs[b], mb_w, rows,
                                             halo=halo[b])
                    planes[b].append((y, cb, cr))
                    if b + 1 < B:
                        sent[b + 1] = _send(y, cb, cr, devs[b + 1],
                                            streams[b], streams[b + 1])
            for b, (h, ev) in sent.items():
                halo[b], ready[b] = h, ev
        join_streams(devs, streams)
        out = []
        for p in range(3):
            parts = []
            for b in range(B):
                for pl in planes[b]:
                    if streams[b] is not None:
                        pl[p].record_stream(
                            torch.cuda.current_stream(devs[b]))
                parts.append(torch.cat([pl[p] for pl in planes[b]])
                             .to(devs[0]))
            full = torch.cat(parts, 1)[:, :(16 if p == 0 else 8) * self.mb_h]
            out.append(full if device_out else full.cpu().numpy())
        return tuple(out)


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


def make_banded_frame_fn(mesh, mb_w: int, mb_h: int, axis: str = "band"):
    """Full-frame band-sharded reconstruction of one picture.

    Counterpart of ``make_banded_frame_fn`` (``dryv_tpu/parallel/
    bands.py`` :55), same contract: run(fs, device_out=False) -> cropped
    (y, cb, cr).  The JAX version exchanges frontier rows after every
    diagonal; here it is ``make_banded_gop_fn`` with F = Fi = 1, which
    gives the same planes from one halo per band boundary.  On a 2-D
    mesh it uses the band axis, as the original does."""
    run_gop = make_banded_gop_fn(mesh, mb_w, mb_h, 1, Fi=1, axis=axis)

    def run(fs, device_out=False):
        return tuple(p[0] for p in run_gop([fs], device_out))

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


def _extend(planes, a, total, devs, streams):
    """Each band's extended plane: band b's rows with `a` rows above and
    below, rows outside the picture replicating its edge rows, so that a
    clamp inside the extended plane is the global clamp.  planes[b] is
    band b's [rows, W] on devs[b]; the apron rows come from the
    neighbours in ceil(a / rows) chained hops (each band forwards what it
    received), each ordered by an event on the receiving slot's stream,
    as ``make_banded_gop_fn`` orders its halos."""
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
    for b in range(B):
        with on_stream(streams[b]):
            rows_b = torch.cat(above[b] + [planes[b]] + below[b])
            start = (b - len(above[b])) * rows
            g = torch.arange(rows + 2 * a, device=devs[b]) + b * rows - a
            out.append(rows_b[g.clamp(0, total - 1) - start])
    return out


def make_banded_p_recon_fn(mesh, mb_w: int, mb_h: int, apron: int,
                           axis: str = "band"):
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
    tensors on the first band's device."""
    devs = mesh.axis_devices(axis)
    B = len(devs)
    if mb_h % B:
        raise ValueError("bands must split MB rows evenly")
    hb = mb_h // B
    A = apron
    streams = slot_streams(devs)

    def run(ref_y, ref_cb, ref_cr, mv, rs, y_resid, c_resid,
            device_out=False):
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
        fork_streams(devs, streams)
        band = []
        for b, (dev, st) in enumerate(zip(devs, streams)):
            with on_stream(st):
                ps = [torch.from_numpy(p[b * len(p) // B:(b + 1) * len(p)
                                         // B]).to(dev) for p in refs]
                band.append(ps + [torch.from_numpy(
                    a[b * k:(b + 1) * k]).to(dev) for a, k in (
                        (mv16, n4l), (slot, n4l), (yr, nl), (cr_, nl))])
        ext = [_extend([bd[p] for bd in band], a, len(refs[p]), devs,
                       streams) for p, a in ((0, A), (1, A // 2),
                                             (2, A // 2))]
        parts = []
        for b, (dev, st) in enumerate(zip(devs, streams)):
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
            for b in range(B):
                if streams[b] is not None:
                    parts[b][p].record_stream(
                        torch.cuda.current_stream(devs[b]))
            full = torch.cat([parts[b][p].to(devs[0]) for b in range(B)])
            out.append(full if device_out else full.cpu().numpy())
        return tuple(out)

    return run
