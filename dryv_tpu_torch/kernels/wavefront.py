"""Kernel B2: intra reconstruction along the MB wavefront.

Replaces the Pallas kernel ``_build_kernel`` behind
``make_gop_recon_pallas`` in ``dryv_tpu/kernels/pallas_wavefront.py``.
MB (x, y) predicts from (x-1, y), (x, y-1), (x+1, y-1) and (x-1, y-1).
The plain version walks the anti-diagonals d = x + 2y in order (all MBs
on one are independent) and reads every apron from the planes that
earlier diagonals wrote.  The CUDA kernel (``csrc/intra_wavefront.cu``)
is one persistent launch whose blocks walk MB rows and order themselves
through progress flags; ``row_tickets`` and ``apron_wait`` are its
schedule in Python, which the CPU tests simulate.

With ``halo`` the same kernel is B2b, the Pallas kernel's
``banded=True``: the planes hold one band of MB rows, and its first MB
row reads the above, above-right and corner aprons from the bottom pixel
rows of the band above (``dryv_tpu_torch.parallel.bands``).

Inputs per MB (``recon_inputs`` builds them from stage A's rows):
  meta  u8  [F, n, 32]   kind, i16 mode, chroma mode, avail a..d, 16
                         z-scan 4x4 modes, 4 8x8 modes (rows as
                         ``ROW_*`` of pallas_wavefront.py)
  yres  i16 [F, n, 256]  luma residual in storage order (z-rows; I8
                         quadrant rows), PCM samples for PCM MBs
  cres  i16 [F, n, 2, 8, 8]  chroma residual, PCM samples for PCM MBs
Output: uint8 planes y [F, 16*mb_h, 16*mb_w], cb, cr [F, 8*mb_h, 8*mb_w].
"""
from __future__ import annotations

import torch

from ..avc.neighbors import ZSCAN_4X4_POS
from ..coeffs import KIND_I8, KIND_I16, KIND_PCM

from .. import _build
from ..tables import index_on
from .geometry import diag_schedule

META_ROWS = 32
ROW_KIND, ROW_I16M, ROW_CMODE, ROW_AV, ROW_M4, ROW_M8 = 0, 1, 2, 3, 7, 23


def recon_inputs(s, yres, cres):
    """Stage A's rows (``transform.stage_a``: int16, clamped to [-255,
    255]) + syntax -> (meta, yres, cres) for B2.

    s: [F, n, ...] integer tensors kind, i16_mode, chroma_mode,
    avail_a..d, modes4 [.,16], modes8 [.,4] and, for PCM batches, pcm_y
    [.,256] (raster) and pcm_c [.,2,8,8], whose samples replace the
    residual rows of the PCM MBs."""
    F, n = s["kind"].shape
    dev = s["kind"].device
    meta = torch.zeros((F, n, META_ROWS), dtype=torch.uint8, device=dev)
    meta[..., ROW_KIND] = s["kind"].to(torch.uint8)
    meta[..., ROW_I16M] = s["i16_mode"].to(torch.uint8)
    meta[..., ROW_CMODE] = s["chroma_mode"].to(torch.uint8)
    for i, k in enumerate(("avail_a", "avail_b", "avail_c", "avail_d")):
        meta[..., ROW_AV + i] = s[k].to(torch.uint8)
    meta[..., ROW_M4:ROW_M4 + 16] = s["modes4"].to(torch.uint8)
    meta[..., ROW_M8:ROW_M8 + 4] = s["modes8"].to(torch.uint8)
    if "pcm_y" in s:
        pcm = (s["kind"] == KIND_PCM)
        pcm_z = s["pcm_y"].reshape(F, n, 256)[..., index_on("z2sp", dev)] \
            .to(torch.int16)
        yres = torch.where(pcm[..., None], pcm_z, yres)
        cres = torch.where(pcm[..., None, None, None],
                           s["pcm_c"].reshape(F, n, 2, 8, 8)
                           .to(torch.int16), cres)
    return meta.contiguous(), yres.contiguous(), cres.contiguous()


def _tap_pred(tap, mode, sv):
    """Directional prediction from tap rows: tap [9, P, 8] int32, mode
    [M], sv [M, S] int32 -> [M, P] (DC rows give 0; callers replace
    them)."""
    t = tap[mode]                                        # [M, P, 8]
    g = torch.gather(sv[:, None, :].expand(-1, t.shape[1], -1), 2,
                     t[..., 0:3].long())
    return ((g * t[..., 3:6]).sum(-1) + t[..., 6]) >> t[..., 7]


def _dc(aa, ab, suma, suml, shift):
    """Intra DC with the availability fallback chain; shift is log2 of
    the sample count on one side."""
    both = (suma + suml + (1 << shift)) >> (shift + 1)
    left = (suml + (1 << (shift - 1))) >> shift
    top = (suma + (1 << (shift - 1))) >> shift
    return torch.where(aa & ab, both, torch.where(
        aa, left, torch.where(ab, top, torch.full_like(suma, 128))))


def _recon_luma(Wn, m, r, avt, tables):
    """One diagonal's luma: Wn [M,17,25] windows (row 0 / col 0 aprons),
    m [M,32] meta, r [M,256] residual rows, avt [M,6] availability by
    source code.  Returns spatial samples [M,256]."""
    M = Wn.shape[0]
    tap4 = tables["tap4"].to(torch.int32)
    tap8 = tables["tap8"].to(torch.int32)
    av4 = tables["avail4"].long()
    av8 = tables["avail8"].long()
    ava, avb = avt[:, 1], avt[:, 2]

    # ---- I4: 16 z-scan blocks on their own copy of the window ----------
    W4 = Wn.clone()
    o4 = torch.empty((M, 256), dtype=torch.int32, device=Wn.device)
    for blk, (bx, by) in enumerate(ZSCAN_4X4_POS):
        r0, c0 = 4 * by, 4 * bx
        aa, ab, ac = (avt[:, av4[j, blk]] for j in range(3))
        row = W4[:, r0, c0:c0 + 9]
        above = torch.cat([row[:, 1:5], torch.where(
            ac[:, None], row[:, 5:9], row[:, 4:5].expand(-1, 4))], 1)
        left = W4[:, r0 + 1:r0 + 5, c0]
        sv = torch.cat([row[:, 0:1], above, left], 1)      # [M, 13]
        mode = m[:, ROW_M4 + blk]
        dc = _dc(aa, ab, above[:, :4].sum(1), left.sum(1), 2)
        pred = torch.where((mode == 2)[:, None], dc[:, None],
                           _tap_pred(tap4, mode, sv))
        u = (pred + r[:, 16 * blk:16 * blk + 16]).clamp(0, 255)
        o4[:, 16 * blk:16 * blk + 16] = u
        W4[:, r0 + 1:r0 + 5, c0 + 1:c0 + 5] = u.view(M, 4, 4)

    # ---- I8: 4 quadrants with the reference-sample filter ---------------
    W8 = Wn.clone()
    o8 = torch.empty((M, 256), dtype=torch.int32, device=Wn.device)
    for blk in range(4):
        bx, by = blk & 1, blk >> 1
        r0, c0 = 8 * by, 8 * bx
        aa, ab, ac, ad = (avt[:, av8[j, blk]] for j in range(4))
        row = W8[:, r0, c0:c0 + 17]
        a = torch.cat([row[:, 1:9], torch.where(
            ac[:, None], row[:, 9:17], row[:, 8:9].expand(-1, 8))], 1)
        lf = W8[:, r0 + 1:r0 + 9, c0]
        corn = row[:, 0]
        fa = torch.cat([
            torch.where(ad, (corn + 2 * a[:, 0] + a[:, 1] + 2) >> 2,
                        (3 * a[:, 0] + a[:, 1] + 2) >> 2)[:, None],
            (a[:, :-2] + 2 * a[:, 1:-1] + a[:, 2:] + 2) >> 2,
            ((a[:, 14] + 3 * a[:, 15] + 2) >> 2)[:, None]], 1)
        fl = torch.cat([
            torch.where(ad, (corn + 2 * lf[:, 0] + lf[:, 1] + 2) >> 2,
                        (3 * lf[:, 0] + lf[:, 1] + 2) >> 2)[:, None],
            (lf[:, :-2] + 2 * lf[:, 1:-1] + lf[:, 2:] + 2) >> 2,
            ((lf[:, 6] + 3 * lf[:, 7] + 2) >> 2)[:, None]], 1)
        fz = torch.where(aa & ab, (a[:, 0] + 2 * corn + lf[:, 0] + 2) >> 2,
                         torch.where(ab, (3 * corn + a[:, 0] + 2) >> 2,
                                     torch.where(aa, (3 * corn + lf[:, 0]
                                                      + 2) >> 2, corn)))
        fz = torch.where(ad, fz, corn)
        fa = torch.where(ab[:, None], fa, a)
        fl = torch.where(aa[:, None], fl, lf)
        sv = torch.cat([fz[:, None], fa, fl], 1)            # [M, 25]
        mode = m[:, ROW_M8 + blk]
        dc = _dc(aa, ab, fa[:, :8].sum(1), fl.sum(1), 3)
        pred = torch.where((mode == 2)[:, None], dc[:, None],
                           _tap_pred(tap8, mode, sv))
        u = (pred + r[:, 64 * blk:64 * blk + 64]).clamp(0, 255)
        o8[:, 64 * blk:64 * blk + 64] = u
        W8[:, r0 + 1:r0 + 9, c0 + 1:c0 + 9] = u.view(M, 8, 8)

    # ---- I16 (spatial) ----------------------------------------------------
    above = Wn[:, 0, 1:17]
    left = Wn[:, 1:17, 0]
    corner = Wn[:, 0, 0]
    k8 = torch.arange(1, 9, dtype=torch.int32, device=Wn.device)
    above_m = torch.cat([above[:, :7].flip(1), corner[:, None]], 1)
    left_m = torch.cat([left[:, :7].flip(1), corner[:, None]], 1)
    hh = (k8 * (above[:, 8:16] - above_m)).sum(1)
    vv = (k8 * (left[:, 8:16] - left_m)).sum(1)
    b = (5 * hh + 32) >> 6
    c = (5 * vv + 32) >> 6
    aa16 = 16 * (above[:, 15] + left[:, 15])
    xs = torch.arange(16, dtype=torch.int32, device=Wn.device)
    plane = ((aa16[:, None, None] + b[:, None, None] * (xs[None, None] - 7)
              + c[:, None, None] * (xs[None, :, None] - 7) + 16) >> 5
             ).clamp(0, 255)
    dc = _dc(ava, avb, above.sum(1), left.sum(1), 4)
    mode = m[:, ROW_I16M][:, None, None]
    p16 = torch.where(mode == 0, above[:, None, :].expand(-1, 16, -1),
                      torch.where(mode == 1, left[:, :, None].expand(-1, -1,
                                                                    16),
                                  torch.where(mode == 2, dc[:, None, None],
                                              plane))).reshape(M, 256)
    sp2z = index_on("sp2z", Wn.device)
    r_sp = r[:, sp2z]
    o16 = (p16 + r_sp).clamp(0, 255)

    kind = m[:, ROW_KIND][:, None]
    sp2q = index_on("sp2q", Wn.device)
    return torch.where(kind == KIND_PCM, r_sp, torch.where(
        kind == KIND_I16, o16, torch.where(kind == KIND_I8, o8[:, sp2q],
                                           o4[:, sp2z])))


def _recon_chroma(cw, cmode, kind, ava, avb, cr):
    """cw [M,2,17] (corner, above 8, left 8), cr [M,2,8,8] -> [M,2,8,8]."""
    above = cw[..., 1:9]
    left = cw[..., 9:17]
    corner = cw[..., 0:1]
    k4 = torch.arange(1, 5, dtype=torch.int32, device=cw.device)
    hs = (k4 * (above[..., 4:8] - torch.cat([above[..., :3].flip(-1), corner],
                                            -1))).sum(-1)
    vs = (k4 * (left[..., 4:8] - torch.cat([left[..., :3].flip(-1), corner],
                                           -1))).sum(-1)
    b = (34 * hs + 32) >> 6
    c = (34 * vs + 32) >> 6
    aa = 16 * (above[..., 7] + left[..., 7])
    xs = torch.arange(8, dtype=torch.int32, device=cw.device)
    plane = ((aa[..., None, None] + b[..., None, None] * (xs - 3)
              + c[..., None, None] * (xs[:, None] - 3) + 16) >> 5
             ).clamp(0, 255)
    a_, b_ = ava[:, None], avb[:, None]
    asum = [above[..., 4 * i:4 * i + 4].sum(-1) for i in (0, 1)]
    lsum = [left[..., 4 * i:4 * i + 4].sum(-1) for i in (0, 1)]
    dcf = torch.full_like(asum[0], 128)
    q00 = _dc(a_, b_, asum[0], lsum[0], 2)
    q11 = _dc(a_, b_, asum[1], lsum[1], 2)
    q01 = torch.where(b_, (asum[1] + 2) >> 2,
                      torch.where(a_, (lsum[0] + 2) >> 2, dcf))
    q10 = torch.where(a_, (lsum[1] + 2) >> 2,
                      torch.where(b_, (asum[0] + 2) >> 2, dcf))
    quad = torch.stack([torch.stack([q00, q01], -1),
                        torch.stack([q10, q11], -1)], -2)   # [M,2,2,2]
    dc = quad.repeat_interleave(4, -1).repeat_interleave(4, -2)
    mode = cmode[:, None, None, None]
    pred = torch.where(mode == 0, dc, torch.where(
        mode == 1, left[..., :, None].expand(-1, -1, -1, 8),
        torch.where(mode == 2, above[..., None, :].expand(-1, -1, 8, -1),
                    plane)))
    out = (pred + cr).clamp(0, 255)
    return torch.where((kind == KIND_PCM)[:, None, None, None], cr, out)


def intra_recon_plain(meta, yres, cres, tables, mb_w, mb_h, halo=None):
    """Plain PyTorch version of B2 (B2b with ``halo``), vectorised over
    the MBs of each diagonal in all frames."""
    F, n, _ = meta.shape
    dev = meta.device
    H, Wd = 16 * mb_h, 16 * mb_w
    # planes padded by 1 row on top, 1 column on the left and 8 on the
    # right: out-of-picture aprons read 0 (legal modes never use them);
    # a band's top pad row holds the halo
    Y = torch.zeros((F, H + 1, Wd + 9), dtype=torch.int32, device=dev)
    C = torch.zeros((F, 2, H // 2 + 1, Wd // 2 + 1), dtype=torch.int32,
                    device=dev)
    if halo is not None:
        Y[:, 0, 1:Wd + 1] = halo[0]
        C[:, :, 0, 1:] = halo[1]
    sched = diag_schedule(mb_w, mb_h)[0]
    i17 = torch.arange(17, device=dev)
    i25 = torch.arange(25, device=dev)
    i8 = torch.arange(8, device=dev)
    i16 = torch.arange(16, device=dev)
    for row in sched:
        addrs = torch.as_tensor(row[row >= 0], dtype=torch.long, device=dev)
        K = addrs.numel()
        f = torch.arange(F, device=dev).repeat_interleave(K)
        a = addrs.repeat(F)
        M = F * K
        y0 = 16 * (a // mb_w) + 1
        x0 = 16 * (a % mb_w) + 1
        m = meta[f, a].long()
        Wn = Y[f[:, None, None], (y0 - 1)[:, None, None] + i17[:, None],
               (x0 - 1)[:, None, None] + i25].clone()
        Wn[:, 1:, 1:] = 0
        avt = torch.cat([torch.ones((M, 1), dtype=torch.bool, device=dev),
                         m[:, ROW_AV:ROW_AV + 4] != 0,
                         torch.zeros((M, 1), dtype=torch.bool, device=dev)],
                        1)
        out = _recon_luma(Wn, m, yres[f, a].to(torch.int32), avt, tables)
        Y[f[:, None, None], y0[:, None, None] + i16[:, None],
          x0[:, None, None] + i16] = out.view(M, 16, 16).to(torch.int32)
        cy0 = 8 * (a // mb_w) + 1
        cx0 = 8 * (a % mb_w) + 1
        fp = f[:, None, None]
        pp = torch.arange(2, device=dev)[None, :, None]
        cw = torch.cat([
            C[fp, pp, (cy0 - 1)[:, None, None], (cx0 - 1)[:, None, None]],
            C[fp, pp, (cy0 - 1)[:, None, None], cx0[:, None, None] + i8],
            C[fp, pp, cy0[:, None, None] + i8, (cx0 - 1)[:, None, None]]],
            -1)
        oc = _recon_chroma(cw, m[:, ROW_CMODE], m[:, ROW_KIND], avt[:, 1],
                           avt[:, 2], cres[f, a].to(torch.int32))
        C[fp[..., None], pp[..., None], cy0[:, None, None, None]
          + i8[:, None], cx0[:, None, None, None] + i8] = oc.to(torch.int32)
    return (Y[:, 1:, 1:Wd + 1].to(torch.uint8),
            C[:, 0, 1:, 1:].to(torch.uint8), C[:, 1, 1:, 1:].to(torch.uint8))


def row_tickets(mb_h, F):
    """The task of each of B2's work tickets, in the order blocks claim
    them: ticket t is MB row t // F of frame t % F, so row 0 of every
    frame comes first and all F pictures start together.  A block walks
    its row left to right, then claims the next ticket."""
    return [(t % F, t // F) for t in range(F * mb_h)]


def apron_wait(mx, my, mb_w):
    """The wait rule: how many MBs of row my - 1 (same frame) must be
    finished before MB (mx, my) reads its above, above-right and corner
    aprons (up to the above-right MB), or None for row 0, whose aprons
    are outside the picture or in the complete halo.  Its left apron is
    the MB the same block finished just before."""
    return None if my == 0 else min(mx + 2, mb_w)


def intra_recon(meta, yres, cres, tables, mb_w, mb_h, halo=None):
    """B2: (meta, yres, cres) -> (y, cb, cr) uint8 planes.  CPU tensors
    take the plain version; CUDA tensors launch the kernel (one launch
    per call, its blocks scheduled by ``row_tickets`` and
    ``apron_wait``).

    halo = (hy uint8 [F, 16*mb_w], hc uint8 [F, 2, 8*mb_w]), the bottom
    luma row and the two bottom chroma rows of the band above, makes it
    B2b: MB row 0 reads its above, above-right and corner aprons there.
    B2b launches count in ``intra_recon.banded_launches``, B2's in
    ``intra_recon.launches``."""
    F, n, rows = meta.shape
    if n != mb_w * mb_h or rows != META_ROWS:
        raise ValueError(f"meta shape {tuple(meta.shape)} does not match "
                         f"{mb_w}x{mb_h} MBs")
    if yres.shape != (F, n, 256) or yres.dtype != torch.int16:
        raise ValueError(f"yres must be int16 [F,n,256], got "
                         f"{yres.dtype} {tuple(yres.shape)}")
    if cres.shape != (F, n, 2, 8, 8) or cres.dtype != torch.int16:
        raise ValueError(f"cres must be int16 [F,n,2,8,8], got "
                         f"{cres.dtype} {tuple(cres.shape)}")
    if halo is not None:
        hy, hc = halo
        if hy.shape != (F, 16 * mb_w) or hc.shape != (F, 2, 8 * mb_w) \
                or hy.dtype != torch.uint8 or hc.dtype != torch.uint8:
            raise ValueError(f"halo must be uint8 [F,{16 * mb_w}] and "
                             f"[F,2,{8 * mb_w}], got {hy.dtype} "
                             f"{tuple(hy.shape)} and {hc.dtype} "
                             f"{tuple(hc.shape)}")
    if meta.device.type == "cpu":
        return intra_recon_plain(meta, yres, cres, tables, mb_w, mb_h, halo)
    tabs = [tables[k] for k in ("tap4", "tap8", "avail4", "avail8")]
    _build.check_cuda(meta, yres, cres, *tabs, *(halo or ()))
    if any(t.data_ptr() % 16 for t in (meta, yres, cres, *tabs)):
        raise ValueError("B2's inputs must start on 16-byte boundaries "
                         "(it copies them in 16-byte chunks)")
    y = torch.empty((F, 16 * mb_h, 16 * mb_w), dtype=torch.uint8,
                    device=meta.device)
    cb = torch.empty((F, 8 * mb_h, 8 * mb_w), dtype=torch.uint8,
                     device=meta.device)
    cr = torch.empty_like(cb)
    # ticket counter + one progress flag per (frame, MB row)
    sched = torch.zeros(1 + F * mb_h, dtype=torch.int32, device=meta.device)
    _build.call("dt_intra_wavefront", meta, yres, cres, *tabs, y, cb, cr,
                *(halo or (None, None)), sched, mb_w, mb_h, F)
    if halo is None:
        intra_recon.launches += 1
    else:
        intra_recon.banded_launches += 1
    return y, cb, cr


intra_recon.launches = 0
intra_recon.banded_launches = 0
