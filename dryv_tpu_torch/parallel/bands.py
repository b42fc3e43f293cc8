"""Band-sharded intra reconstruction with halo exchange.

Counterpart of ``dryv_tpu/parallel/bands.py`` (intra; the banded P
recon ``make_banded_p_recon_fn`` needs motion compensation and waits for
the I/P/B slice).  A picture's MB rows split into contiguous bands over
the mesh "band" axis.  Frames pipeline through the bands: at step t,
band b reconstructs frame group t - b with one launch of kernel B2b and
sends its bottom luma row and bottom chroma rows to band b + 1, whose
first MB row reads them as its above, above-right and corner aprons at
step t + 1.  Each band's slot runs on a CUDA stream of its own; the
halo copy is ordered by a CUDA event that the next band's stream waits
on, so on one card the bands overlap and on several the copy goes peer
to peer.  Intra without the in-loop filter: filtering across a band
boundary needs a back-edge fixup, as the JAX version says.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

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


def _send(y, cb, cr, to, src_stream, dst_stream):
    """Band planes -> (bottom luma row [Fi, W], bottom chroma rows [Fi,
    2, W/2]) on device `to`, and the CUDA event (None on the CPU) after
    which `dst_stream` may read them."""
    hy = y[:, -1].contiguous().to(to, non_blocking=True)
    hc = torch.stack([cb[:, -1], cr[:, -1]], 1).to(to, non_blocking=True)
    if src_stream is None:
        return (hy, hc), None
    for h in (hy, hc):
        h.record_stream(dst_stream)
    ev = torch.cuda.Event()
    ev.record(src_stream)
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
