"""In-loop deblocking (spec 8.7): the edge parameters, and kernel B3.

``deblock_precompute`` is the plain PyTorch port of
``deblock_precompute_jax`` and ``_pair_bs_jax`` (``dryv_tpu/kernels/
deblock.py``) over a batch of pictures: boundary strength, alpha, beta
and tC0 per edge.  Without motion inputs it is
``deblock_precompute_intra_jax`` (all-intra pictures: bS 4 on MB edges,
3 inside); with them, the inter boundary strengths (1 and 2) come from
coded-coefficient flags, motion vectors and reference keys per 4x4
block.  The JAX package runs both in XLA inside its jitted steps.
``pack_params`` lays the parameters out as one uint8 row of 192 bytes
per MB in ``PRE_KEYS`` order.  Kernel B6 (``deblock_params``,
``csrc/deblock_params.cu``) writes those rows directly, with no int32
dict in between; its plain version is ``deblock_params_plain``.

Kernel B3 (``csrc/deblock.cu``) replaces the Pallas kernel
``_build_db_kernel`` behind ``make_deblock_pallas``
(``dryv_tpu/kernels/pallas_deblock.py``).  It filters the finished recon
planes in place.  Filtering MB (x, y) changes its own samples, the left
MB's columns 13..15 and the above MB's rows 13..15 (chroma: 7), and reads
the above MB's bottom rows, whose columns 13..15 (x+1, y-1) filters: the
dependency shape of intra prediction.  So B3 is one persistent launch of
MB-row walkers like B2: its tickets (``deblock_tickets``) are (frame, MB
row, luma or chroma), and an MB waits until the row above in its frame
and part has finished ``apron_wait(x, y, mb_w)`` MBs.  Intra prediction
reads unfiltered samples, so B3 runs only after all of B2.

The plain version runs the same per-MB step (``filter_mbs``) over the
anti-diagonals d = x + 2y, whose MBs never touch a common sample; the
CPU tests replay the kernel's schedule through ``filter_mbs`` too.
"""
from __future__ import annotations

import torch

from ..coeffs import KIND_I8, KIND_PCM

from .. import _build
from ..tables import chroma_qp
from .geometry import PRE_KEYS, diag_schedule
from .wavefront import row_tickets

PRM_BYTES = 192
PARTS = ("luma", "chroma")


def _pair_bs(intra_p, intra_q, mb_edge, nz_p, nz_q, mv0p, mv1p, mv0q, mv1q,
             rk0p, rk1p, rk0q, rk1q):
    """Port of ``_pair_bs_jax``: boundary strength (8.7.2.1) of the 4x4
    block pairs (p, q) across an edge, from intra flags, coded-coefficient
    flags, motion vectors [..., 2] and reference keys (-1 unused)."""
    def far(a, b):
        return ((a - b).abs() >= 4).any(-1)

    np_cnt = (rk0p >= 0).to(torch.int32) + (rk1p >= 0).to(torch.int32)
    nq_cnt = (rk0q >= 0).to(torch.int32) + (rk1q >= 0).to(torch.int32)
    keys_differ = ((np_cnt != nq_cnt)
                   | (torch.minimum(rk0p, rk1p) != torch.minimum(rk0q, rk1q))
                   | (torch.maximum(rk0p, rk1p) != torch.maximum(rk0q, rk1q)))
    far1 = far(torch.where((rk0p >= 0)[..., None], mv0p, mv1p),
               torch.where((rk0q >= 0)[..., None], mv0q, mv1q))
    fa = far(mv0p, mv0q) | far(mv1p, mv1q)
    fx = far(mv0p, mv1q) | far(mv1p, mv0q)
    mv_bs = torch.where(np_cnt == 1, far1, torch.where(
        rk0p == rk1p, fa & fx, torch.where(rk0p == rk0q, fa, fx)))
    bs = torch.where(keys_differ, 1, mv_bs.to(torch.int32))
    bs = torch.where(nz_p | nz_q, 2, bs)
    return torch.where(intra_p | intra_q, torch.where(mb_edge, 4, 3), bs)


def deblock_precompute(kind, qp_y, sid, dis, offa, offb, mb_w, mb_h,
                       chroma_off0, chroma_off1, tables, t8=None, nz4=None,
                       mv0=None, mv1=None, rk0=None, rk1=None):
    """Edge parameters of a batch of F pictures: the plain PyTorch port of
    ``deblock_precompute_jax``.

    kind (the native numbering, intra 0..3 and 11) / qp_y / sid / dis /
    offa / offb [F, n] per-MB integer tensors (dis/offa/offb: the MB's
    slice's deblock control).  The inter inputs, all or none: t8 [F, n]
    transform-8x8 flags, nz4 [F, H4, W4] coded-coefficient flags,
    mv0/mv1 [F, H4, W4, 2], rk0/rk1 [F, H4, W4] reference keys or stack
    slots (-1 = list unused; only equality matters).  Without them every
    MB must be intra, as for ``deblock_precompute_intra_jax``: bS 4 on MB
    edges and 3 inside.  Returns the PRE_KEYS dict of int32 [F, n, ...]
    tensors."""
    alpha_t, beta_t, tc0_t = tables["alpha"], tables["beta"], tables["tc0"]
    dev = kind.device
    F = kind.shape[0]
    H4, W4 = 4 * mb_h, 4 * mb_w

    def grid(a, shape=(mb_h, mb_w)):
        return a.to(torch.int32).reshape((F,) + shape)

    kind = grid(kind)
    qpy = torch.where(kind == KIND_PCM, 0, grid(qp_y))
    sid, dis, offa, offb = grid(sid), grid(dis), grid(offa), grid(offb)
    t8 = (kind == KIND_I8) | (False if t8 is None else grid(t8) != 0)
    qpc = [chroma_qp(qpy, chroma_off0, tables["qpc_tab"]),
           chroma_qp(qpy, chroma_off1, tables["qpc_tab"])]

    def left(a, fill=0):        # along axis 2 of [F, rows, cols, ...]
        pad = [0, 0] * (a.ndim - 3) + [1, 0]
        return torch.nn.functional.pad(a[:, :, :-1], pad, value=fill)

    def up(a, fill=0):          # along axis 1
        pad = [0, 0] * (a.ndim - 2) + [1, 0]
        return torch.nn.functional.pad(a[:, :-1], pad, value=fill)

    if nz4 is None:
        # per MB: [edge, line segment]; every pair of blocks is intra.
        # (Made on the device: a host list copied to a CUDA tensor would
        # wait for the work queued before it.)
        edge0 = torch.arange(4, device=dev) == 0
        BSVg = BSHg = (3 + edge0.to(torch.int32))[:, None].expand(4, 4)
    else:
        intra_mb = (kind <= 3) | (kind == 11)
        intra4 = intra_mb.repeat_interleave(4, 1).repeat_interleave(4, 2)
        nz4 = nz4.reshape(F, H4, W4) != 0
        mv0, mv1 = grid(mv0, (H4, W4, 2)), grid(mv1, (H4, W4, 2))
        rk0, rk1 = grid(rk0, (H4, W4)), grid(rk1, (H4, W4))
        mbe_v = (torch.arange(W4, device=dev) % 4 == 0)[None, :] \
            .expand(H4, W4)
        mbe_h = (torch.arange(H4, device=dev) % 4 == 0)[:, None] \
            .expand(H4, W4)
        BSV = _pair_bs(left(intra4, False), intra4, mbe_v, left(nz4, False),
                       nz4, left(mv0), left(mv1), mv0, mv1, left(rk0, -1),
                       left(rk1, -1), rk0, rk1)
        BSH = _pair_bs(up(intra4, False), intra4, mbe_h, up(nz4, False), nz4,
                       up(mv0), up(mv1), mv0, mv1, up(rk0, -1), up(rk1, -1),
                       rk0, rk1)
        # per MB: [edge, line segment]
        BSVg = BSV.reshape(F, mb_h, 4, mb_w, 4).permute(0, 1, 3, 4, 2)
        BSHg = BSH.reshape(F, mb_h, 4, mb_w, 4).permute(0, 1, 3, 2, 4)

    on_self = (dis != 1).to(torch.int32)
    mx = torch.arange(mb_w, device=dev)[None, None, :]
    my = torch.arange(mb_h, device=dev)[None, :, None]
    on_v0 = (on_self != 0) & (mx > 0) & ~((dis == 2) & (left(sid, -1) != sid))
    on_h0 = (on_self != 0) & (my > 0) & ~((dis == 2) & (up(sid, -1) != sid))

    def idx_ab(qpav, off):
        return (qpav + off).clamp(0, 51).long()

    def tc0_of(ia, bs):
        return tc0_t[ia, (bs.clamp(1, 3) - 1).long()]

    def luma_dir(on_e0, qp_nb, BSg):
        qpav = (qp_nb + qpy + 1) >> 1
        ia0, ib0 = idx_ab(qpav, offa), idx_ab(qpav, offb)
        ia_i, ib_i = idx_ab(qpy, offa), idx_ab(qpy, offb)
        onk = on_self * (~t8).to(torch.int32)
        # per-edge enables: edge 0 = MB boundary; 8x8 keeps only edge 2
        ons = torch.stack([on_e0.to(torch.int32), onk, on_self, onk], -1)
        bs = BSg * ons[..., None]
        al = torch.stack([alpha_t[ia0]] + [alpha_t[ia_i]] * 3, -1)
        be = torch.stack([beta_t[ib0]] + [beta_t[ib_i]] * 3, -1)
        ia = torch.stack([ia0] + [ia_i] * 3, -1)
        return bs, tc0_of(ia[..., None], bs), al, be

    rep = torch.arange(4, device=dev).repeat_interleave(2)

    def chroma_dir(on_e0, qpc_nb, BSg):
        bs = torch.stack([BSg[..., 0, :][..., rep] * on_e0[..., None],
                          BSg[..., 2, :][..., rep] * on_self[..., None]],
                         -2)                                 # [F,h,w,2,8]
        al, be, tc = [], [], []
        for p in (0, 1):
            qpav = (qpc_nb[p] + qpc[p] + 1) >> 1
            ia0, ib0 = idx_ab(qpav, offa), idx_ab(qpav, offb)
            ia_i, ib_i = idx_ab(qpc[p], offa), idx_ab(qpc[p], offb)
            al.append(torch.stack([alpha_t[ia0], alpha_t[ia_i]], -1))
            be.append(torch.stack([beta_t[ib0], beta_t[ib_i]], -1))
            tc.append(tc0_of(torch.stack([ia0, ia_i], -1)[..., None], bs))
        return (bs, torch.stack(tc, -2), torch.stack(al, -1),
                torch.stack(be, -1))

    out = {}
    out["bsv"], out["tc0v"], out["av"], out["bv"] = luma_dir(on_v0,
                                                             left(qpy), BSVg)
    out["bsh"], out["tc0h"], out["ah"], out["bh"] = luma_dir(on_h0, up(qpy),
                                                             BSHg)
    out["bscv"], out["tc0cv"], out["acv"], out["bcv"] = chroma_dir(
        on_v0.to(torch.int32), [left(q) for q in qpc], BSVg)
    out["bsch"], out["tc0ch"], out["ach"], out["bch"] = chroma_dir(
        on_h0.to(torch.int32), [up(q) for q in qpc], BSHg)
    n = mb_w * mb_h
    return {k: v.reshape((F, n) + tuple(v.shape[3:])).to(torch.int32)
            for k, v in out.items()}


def pack_params(pre):
    """PRE_KEYS dict of [F, n, ...] -> uint8 [F, n, 192] parameter rows
    (every value fits a byte: bS <= 4, tC0 <= 25, alpha <= 255, beta
    <= 18)."""
    F, n = pre["bsv"].shape[:2]
    prm = torch.cat([pre[k].reshape(F, n, -1) for k in PRE_KEYS], -1)
    assert prm.shape[-1] == PRM_BYTES
    return prm.to(torch.uint8).contiguous()


def deblock_params_plain(kind, qp_y, sid, dis, offa, offb, mb_w, mb_h,
                         chroma_off0, chroma_off1, tables, t8=None,
                         nz4=None, mv=None, rs=None):
    """Plain PyTorch version of B6: ``pack_params`` of
    ``deblock_precompute`` on B6's inputs (``deblock_params``)."""
    inter = ()
    if mv is not None:
        grid = (kind.shape[0], 4 * mb_h, 4 * mb_w)
        inter = (t8, nz4.reshape(grid), mv[:, :, 0].reshape(*grid, 2),
                 mv[:, :, 1].reshape(*grid, 2), rs[..., 0].reshape(grid),
                 rs[..., 1].reshape(grid))
    return pack_params(deblock_precompute(
        kind, qp_y, sid, dis, offa, offb, mb_w, mb_h, chroma_off0,
        chroma_off1, tables, *inter))


def deblock_params(kind, qp_y, sid, dis, offa, offb, mb_w, mb_h,
                   chroma_off0, chroma_off1, tables, t8=None, nz4=None,
                   mv=None, rs=None):
    """B6: the uint8 [F, n, 192] parameter rows B3 reads, as
    ``deblock_params_plain`` gives them.  kind (the native numbering),
    qp_y, sid, dis, offa, offb: int32 [F, n] contiguous.  The inter
    inputs, all or none: t8 int32 [F, n], nz4 bool or uint8 [F, 4*mb_h,
    4*mb_w], mv int16 [F, 16n, 2, 2] (4x4 blocks in raster order over
    the picture, list, component) and rs int8 [F, 16n, 4] (the reference
    keys of lists 0 and 1 first, -1 = unused), all contiguous: the
    packed I/P/B wire's layout.  Without them every MB must be intra.
    Types and shapes are checked on every device; then CPU tensors take
    the plain version, and CUDA tensors (contiguous) launch the kernel
    (one launch per call) or raise."""
    inter = (t8, nz4, mv, rs)
    if any(t is None for t in inter) and any(t is not None for t in inter):
        raise ValueError("deblock_params takes all inter inputs or none")
    F, n = kind.shape
    n4 = 16 * n
    per_mb = (kind, qp_y, sid, dis, offa, offb)
    tabs = [tables[k] for k in ("alpha", "beta", "tc0", "qpc_tab")]
    if n != mb_w * mb_h:
        raise ValueError(f"{n} MBs do not make {mb_w}x{mb_h}")
    want = [(t, torch.int32, (F, n)) for t in per_mb + (t8,)] + [
        (nz4, (torch.bool, torch.uint8), (F, 4 * mb_h, 4 * mb_w)),
        (mv, torch.int16, (F, n4, 2, 2)), (rs, torch.int8, (F, n4, 4))] + [
        (t, torch.int32, tuple(t.shape)) for t in tabs]
    for t, dt, shape in want:
        if t is not None and (t.dtype not in (dt if isinstance(dt, tuple)
                                              else (dt,))
                              or tuple(t.shape) != shape):
            raise ValueError(f"B6 takes {dt} {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if kind.device.type == "cpu":
        return deblock_params_plain(kind, qp_y, sid, dis, offa, offb, mb_w,
                                    mb_h, chroma_off0, chroma_off1, tables,
                                    t8, nz4, mv, rs)
    _build.check_cuda(*per_mb, *tabs, *(t for t in inter if t is not None))
    prm = torch.empty((F, n, PRM_BYTES), dtype=torch.uint8,
                      device=kind.device)
    _build.call("dt_deblock_params", *per_mb, *inter, *tabs, prm, mb_w,
                mb_h, F, chroma_off0, chroma_off1)
    deblock_params.launches += 1
    return prm


deblock_params.launches = 0


def _filt_luma(p3, p2, p1, p0, q0, q1, q2, q3, bs, alpha, beta, tc0):
    """8.7.2.3/8.7.2.4 on sample taps; returns (p2, p1, p0, q0, q1, q2)."""
    filt = ((bs > 0) & ((p0 - q0).abs() < alpha)
            & ((p1 - p0).abs() < beta) & ((q1 - q0).abs() < beta))
    ap = (p2 - p0).abs() < beta
    aq = (q2 - q0).abs() < beta
    tc = tc0 + ap.to(torch.int32) + aq.to(torch.int32)
    delta = torch.maximum(torch.minimum(
        ((q0 - p0) * 4 + (p1 - q1) + 4) >> 3, tc), -tc)
    p0w = (p0 + delta).clamp(0, 255)
    q0w = (q0 - delta).clamp(0, 255)
    avg = (p0 + q0 + 1) >> 1
    p1w = p1 + torch.maximum(torch.minimum((p2 + avg - 2 * p1) >> 1, tc0),
                             -tc0)
    q1w = q1 + torch.maximum(torch.minimum((q2 + avg - 2 * q1) >> 1, tc0),
                             -tc0)
    strong = (p0 - q0).abs() < (alpha >> 2) + 2
    sp = ap & strong
    sq = aq & strong
    p0s = torch.where(sp, (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
                      (2 * p1 + p0 + q1 + 2) >> 2)
    p1s = torch.where(sp, (p2 + p1 + p0 + q0 + 2) >> 2, p1)
    p2s = torch.where(sp, (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3, p2)
    q0s = torch.where(sq, (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3,
                      (2 * q1 + q0 + p1 + 2) >> 2)
    q1s = torch.where(sq, (q2 + q1 + q0 + p0 + 2) >> 2, q1)
    q2s = torch.where(sq, (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3, q2)
    b4 = bs == 4
    return (torch.where(filt & b4, p2s, p2),
            torch.where(filt, torch.where(b4, p1s, torch.where(ap, p1w, p1)),
                        p1),
            torch.where(filt, torch.where(b4, p0s, p0w), p0),
            torch.where(filt, torch.where(b4, q0s, q0w), q0),
            torch.where(filt, torch.where(b4, q1s, torch.where(aq, q1w, q1)),
                        q1),
            torch.where(filt & b4, q2s, q2))


def _filt_chroma(p1, p0, q0, q1, bs, alpha, beta, tc0):
    """Chroma edge filter; returns (p0, q0)."""
    filt = ((bs > 0) & ((p0 - q0).abs() < alpha)
            & ((p1 - p0).abs() < beta) & ((q1 - q0).abs() < beta))
    tc = tc0 + 1
    delta = torch.maximum(torch.minimum(
        ((q0 - p0) * 4 + (p1 - q1) + 4) >> 3, tc), -tc)
    b4 = bs == 4
    p0n = torch.where(b4, (2 * p1 + p0 + q1 + 2) >> 2,
                      (p0 + delta).clamp(0, 255))
    q0n = torch.where(b4, (2 * q1 + q0 + p1 + 2) >> 2,
                      (q0 - delta).clamp(0, 255))
    return torch.where(filt, p0n, p0), torch.where(filt, q0n, q0)


def _edges(win, n_edges, first, step, filt, params):
    """Filter `n_edges` edges across the last axis of `win`, in order;
    params(e) gives edge e's filter parameters."""
    ntap = 4 if filt is _filt_luma else 2
    for e in range(n_edges):
        c = first + step * e
        taps = [win[..., c + k] for k in range(-ntap, ntap)]
        new = filt(*taps, *params(e))
        lo = -3 if ntap == 4 else -1
        for k, v in zip(range(lo, -lo), new):
            win[..., c + k] = v


def pad_planes(y, cb, cr):
    """int32 copies of the planes with 4 (chroma: 2) rows and columns of
    zeros above and to the left, so every MB's window is in bounds (the
    edges there have bS 0 and leave the pad as it is): Y [F, H+4, W+4]
    and C [F, 2, H/2+2, W/2+2]."""
    F, H, Wd = y.shape
    Y = torch.zeros((F, H + 4, Wd + 4), dtype=torch.int32, device=y.device)
    Y[:, 4:, 4:] = y
    C = torch.zeros((F, 2, H // 2 + 2, Wd // 2 + 2), dtype=torch.int32,
                    device=y.device)
    C[:, 0, 2:, 2:] = cb
    C[:, 1, 2:, 2:] = cr
    return Y, C


def unpad_planes(Y, C):
    """The uint8 planes (y, cb, cr) inside ``pad_planes``' copies."""
    return (Y[:, 4:, 4:].to(torch.uint8), C[:, 0, 2:, 2:].to(torch.uint8),
            C[:, 1, 2:, 2:].to(torch.uint8))


def _luma_mbs(P, Y, f, a, mb_w):
    """``filter_mbs`` for luma; P: the MBs' parameter rows, int32."""
    M = a.numel()
    i20 = torch.arange(20, device=Y.device)
    bsv, tc0v = P[:, 0:16].view(M, 4, 4), P[:, 16:32].view(M, 4, 4)
    av, bv = P[:, 32:36], P[:, 36:40]
    bsh, tc0h = P[:, 40:56].view(M, 4, 4), P[:, 56:72].view(M, 4, 4)
    ah, bh = P[:, 72:76], P[:, 76:80]
    # window: rows y0-4..y0+15, cols x0-4..x0+15 (padded coords)
    y0 = 16 * (a // mb_w)
    x0 = 16 * (a % mb_w)
    ri = (y0[:, None, None] + i20[:, None]).expand(M, 20, 20)
    ci = (x0[:, None, None] + i20).expand(M, 20, 20)
    fi = f[:, None, None].expand(M, 20, 20)
    win = Y[fi, ri, ci]
    v = win[:, 4:20, :]        # own rows, cols -4..15: vertical edges
    _edges(v, 4, 4, 4, _filt_luma, lambda e: (
        bsv[:, e].repeat_interleave(4, -1), av[:, e:e + 1],
        bv[:, e:e + 1], tc0v[:, e].repeat_interleave(4, -1)))
    win[:, 4:20, :] = v
    h = win[:, :, 4:20].transpose(1, 2).clone()   # [M, col, row]
    _edges(h, 4, 4, 4, _filt_luma, lambda e: (
        bsh[:, e].repeat_interleave(4, -1), ah[:, e:e + 1],
        bh[:, e:e + 1], tc0h[:, e].repeat_interleave(4, -1)))
    win[:, :, 4:20] = h.transpose(1, 2)
    # own MB, left strip and above strip (not the corner)
    keep = torch.ones((20, 20), dtype=torch.bool, device=Y.device)
    keep[:4, :4] = False
    return (fi[:, keep], ri[:, keep], ci[:, keep]), win[:, keep]


def _chroma_mbs(P, C, f, a, mb_w):
    """``filter_mbs`` for both chroma planes."""
    M = a.numel()
    dev = C.device
    i10 = torch.arange(10, device=dev)
    bscv, tc0cv = P[:, 80:96].view(M, 2, 8), P[:, 96:128].view(M, 2, 2, 8)
    acv, bcv = P[:, 128:132].view(M, 2, 2), P[:, 132:136].view(M, 2, 2)
    bsch, tc0ch = P[:, 136:152].view(M, 2, 8), P[:, 152:184].view(M, 2, 2, 8)
    ach, bch = P[:, 184:188].view(M, 2, 2), P[:, 188:192].view(M, 2, 2)
    # both planes, window rows/cols -2..7
    cy0 = 8 * (a // mb_w)
    cx0 = 8 * (a % mb_w)
    cri = (cy0[:, None, None, None] + i10[:, None]).expand(M, 2, 10, 10)
    cci = (cx0[:, None, None, None] + i10).expand(M, 2, 10, 10)
    cfi = f[:, None, None, None].expand(M, 2, 10, 10)
    cpi = torch.arange(2, device=dev)[None, :, None, None].expand(M, 2, 10,
                                                                 10)
    cwin = C[cfi, cpi, cri, cci]
    cv = cwin[:, :, 2:10, :]
    _edges(cv, 2, 2, 4, _filt_chroma, lambda e: (
        bscv[:, None, e], acv[:, e, :, None], bcv[:, e, :, None],
        tc0cv[:, e]))
    cwin[:, :, 2:10, :] = cv
    chh = cwin[:, :, :, 2:10].transpose(2, 3).clone()
    _edges(chh, 2, 2, 4, _filt_chroma, lambda e: (
        bsch[:, None, e], ach[:, e, :, None], bch[:, e, :, None],
        tc0ch[:, e]))
    cwin[:, :, :, 2:10] = chh.transpose(2, 3)
    ckeep = torch.ones((10, 10), dtype=torch.bool, device=dev)
    ckeep[:2, :2] = False
    return ((cfi[:, :, ckeep], cpi[:, :, ckeep], cri[:, :, ckeep],
             cci[:, :, ckeep]), cwin[:, :, ckeep])


def filter_mbs(prm, Y, C, f, a, mb_w, part):
    """One step of B3 for the MBs (f[i], a[i]) (frame, MB address; long
    tensors), `part` "luma" or "chroma", on the padded int32 planes of
    ``pad_planes``: reads each MB's window (own samples, left strip,
    above strip), filters its vertical then horizontal edges, and returns
    (plane, index, values), the samples the MBs change (own MB, left
    strip, above strip; not the corner).  ``plane[index] = values`` stores
    them.  The MBs must touch no common sample."""
    P = prm[f, a].to(torch.int32)
    if part == "luma":
        return (Y, *_luma_mbs(P, Y, f, a, mb_w))
    return (C, *_chroma_mbs(P, C, f, a, mb_w))


def deblock_plain(prm, y, cb, cr, mb_w, mb_h):
    """Plain PyTorch version of B3; returns filtered copies of the
    planes.  prm u8 [F, n, 192] from ``pack_params``.  Runs
    ``filter_mbs`` on the MBs of each anti-diagonal in turn."""
    F = y.shape[0]
    dev = y.device
    Y, C = pad_planes(y, cb, cr)
    for row in diag_schedule(mb_w, mb_h)[0]:
        addrs = torch.as_tensor(row[row >= 0], dtype=torch.long, device=dev)
        f = torch.arange(F, device=dev).repeat_interleave(addrs.numel())
        a = addrs.repeat(F)
        for part in PARTS:
            plane, idx, val = filter_mbs(prm, Y, C, f, a, mb_w, part)
            plane[idx] = val
    return unpad_planes(Y, C)


def deblock_tickets(mb_h, F):
    """The task of each of B3's work tickets, in the order blocks claim
    them: (frame, MB row, part), ticket t being part PARTS[t % 2] of
    ``row_tickets(mb_h, F)[t // 2]``.  A block walks its row left to
    right; MB (x, y) first waits until row y - 1 of its frame and part
    has finished ``apron_wait(x, y, mb_w)`` MBs."""
    return [(f, y, part) for f, y in row_tickets(mb_h, F) for part in PARTS]


def deblock(prm, y, cb, cr, mb_w, mb_h):
    """B3: filter the planes.  CUDA tensors are filtered in place by the
    kernel (one launch per call, its blocks scheduled by
    ``deblock_tickets`` and ``apron_wait``) and returned; CPU tensors
    take the plain version, which returns new planes."""
    F, n, nb = prm.shape
    if n != mb_w * mb_h or nb != PRM_BYTES or prm.dtype != torch.uint8:
        raise ValueError(f"prm must be uint8 [F,{mb_w * mb_h},"
                         f"{PRM_BYTES}], got {prm.dtype} "
                         f"{tuple(prm.shape)}")
    if y.shape != (F, 16 * mb_h, 16 * mb_w) or \
            cb.shape != (F, 8 * mb_h, 8 * mb_w) or cr.shape != cb.shape:
        raise ValueError("plane shapes do not match the MB geometry")
    if y.device.type == "cpu":
        return deblock_plain(prm, y, cb, cr, mb_w, mb_h)
    _build.check_cuda(prm, y, cb, cr)
    if any(t.data_ptr() % 16 for t in (prm, y, cb, cr)):
        raise ValueError("B3's parameter rows and planes must start on "
                         "16-byte boundaries (it moves 16-byte rows)")
    # ticket counter + one progress flag per (part, frame, MB row)
    sched = torch.zeros(1 + 2 * F * mb_h, dtype=torch.int32,
                        device=y.device)
    _build.call("dt_deblock", prm, y, cb, cr, sched, mb_w, mb_h, F)
    deblock.launches += 1
    return y, cb, cr


deblock.launches = 0
