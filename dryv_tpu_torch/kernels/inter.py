"""Motion compensation (spec 8.4.2) for every 4x4 block of a picture, and
kernel B4.

Counterpart of ``dryv_tpu/kernels/inter.py``.  The JAX package runs it as
an XLA gather (no Pallas kernel): a 9x9 reference window per 4x4 luma
block (edge-clamped into its stack slot), the 6-tap half-pel lattice
(b, h, j), the Table 8-12 quarter-pel phase select, eighth-pel bilinear
chroma on 3x3 windows, and the unified weighted-prediction combine
(8.4.2.3: default, explicit, implicit).  ``mc_luma_blocks``,
``mc_chroma_blocks``, ``wp_combine``, ``mc_frame_plain`` (the JAX
``mc_frame``) and ``resolve_wp_blocks_torch`` (``resolve_wp_blocks_jax``)
are its int32 PyTorch ports, with the JAX names, shapes and layouts;
``resolve_wp_blocks`` is a numpy copy of the host version.

Kernel B4 (``csrc/inter_mc.cu``) computes what ``mc_frame_plain`` does,
with the weighted-prediction tables resolved per block inside the kernel:
a warp per two macroblocks, a lane per 4x4 block, each warp on one
path for all of its lanes (the note in the source says which and why).
``mc_frame`` is its wrapper: it takes the packed wire's fields as they
arrive (int16 motion vectors, int8 slots and reference indices, the
picture's WP tables) and returns uint8 predictions in MB-tile layout;
CPU tensors take its plain version ``mc_frame_wire_plain``, CUDA tensors
launch B4.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import _build

WP_KEYS = ("wy0", "oy0", "wy1", "oy1", "dy", "wcb0", "ocb0", "wcb1", "ocb1",
           "wcr0", "ocr0", "wcr1", "ocr1", "dc")


def _tap6(v0, v1, v2, v3, v4, v5):
    return v0 - 5 * v1 + 20 * v2 + 20 * v3 - 5 * v4 + v5


def _avg(a, b):
    return (a + b + 1) >> 1


def _clip255(v):
    return v.clamp(0, 255)


def mc_luma_blocks(ref_flat, rs, mv, bx4, by4, H, W):
    """Quarter-pel MC for all 4x4 luma blocks of one list.

    ref_flat: [R*H*W] int32 flattened reference stack; rs [n4] stack slot
    (valid); mv [n4,2] quarter-pel; bx4/by4 [n4] block coordinates in 4x4
    units.  Returns [n4,4,4] int32 predictions."""
    mvx, mvy = mv[:, 0], mv[:, 1]
    bx = bx4 * 4 + (mvx >> 2) - 2
    by = by4 * 4 + (mvy >> 2) - 2
    a9 = torch.arange(9, device=ref_flat.device)
    rows = (by[:, None] + a9).clamp(0, H - 1).long()
    cols = (bx[:, None] + a9).clamp(0, W - 1).long()
    base = rs.long() * (H * W)
    flat = base[:, None, None] + rows[:, :, None] * W + cols[:, None, :]
    win = ref_flat[flat.reshape(-1)].reshape(-1, 9, 9)

    # 6-tap lattice (names as in refimpl/inter.py luma_interp)
    bmat = _tap6(win[:, :, 0:4], win[:, :, 1:5], win[:, :, 2:6],
                 win[:, :, 3:7], win[:, :, 4:8], win[:, :, 5:9])   # [n4,9,4]
    b = (bmat + 16) >> 5
    hmat = _tap6(win[:, 0:4, :], win[:, 1:5, :], win[:, 2:6, :],
                 win[:, 3:7, :], win[:, 4:8, :], win[:, 5:9, :])   # [n4,4,9]
    hh = (hmat + 16) >> 5
    jmat = _tap6(bmat[:, 0:4, :], bmat[:, 1:5, :], bmat[:, 2:6, :],
                 bmat[:, 3:7, :], bmat[:, 4:8, :], bmat[:, 5:9, :])
    jC = _clip255((jmat + 512) >> 10)                              # [n4,4,4]

    G = win[:, 2:6, 2:6]
    Hs = win[:, 2:6, 3:7]
    M = win[:, 3:7, 2:6]
    bC = _clip255(b[:, 2:6, :])
    bD = _clip255(b[:, 3:7, :])
    hC = _clip255(hh[:, :, 2:6])
    hE = _clip255(hh[:, :, 3:7])

    fx = (mvx & 3)[:, None, None]
    fy = (mvy & 3)[:, None, None]
    w = torch.where
    # Table 8-12 phase selection, branchless
    row0 = w(fx == 0, G, w(fx == 1, _avg(G, bC),
                           w(fx == 2, bC, _avg(bC, Hs))))
    row2 = w(fx == 0, hC, w(fx == 1, _avg(hC, jC),
                            w(fx == 2, jC, _avg(jC, hE))))
    diag = _avg(w(fy == 1, bC, bD), w(fx == 1, hC, hE))
    row1 = w(fx == 0, _avg(G, hC), w(fx == 2, _avg(bC, jC), diag))
    row3 = w(fx == 0, _avg(hC, M), w(fx == 2, _avg(jC, bD), diag))
    return w(fy == 0, row0, w(fy == 1, row1, w(fy == 2, row2, row3)))


def mc_chroma_blocks(ref_flat, rs, mv, bx4, by4, Hc, Wc):
    """Eighth-pel bilinear chroma MC for the 2x2 chroma block co-located
    with each luma 4x4 block (4:2:0).  ref_flat [R*Hc*Wc] one plane's
    stack; returns [n4,2,2] int32."""
    mvx, mvy = mv[:, 0], mv[:, 1]
    bx = bx4 * 2 + (mvx >> 3)
    by = by4 * 2 + (mvy >> 3)
    a3 = torch.arange(3, device=ref_flat.device)
    rows = (by[:, None] + a3).clamp(0, Hc - 1).long()
    cols = (bx[:, None] + a3).clamp(0, Wc - 1).long()
    base = rs.long() * (Hc * Wc)
    flat = base[:, None, None] + rows[:, :, None] * Wc + cols[:, None, :]
    win = ref_flat[flat.reshape(-1)].reshape(-1, 3, 3)
    A, B = win[:, 0:2, 0:2], win[:, 0:2, 1:3]
    C, D = win[:, 1:3, 0:2], win[:, 1:3, 1:3]
    fx = (mvx & 7)[:, None, None]
    fy = (mvy & 7)[:, None, None]
    return ((8 - fx) * (8 - fy) * A + fx * (8 - fy) * B +
            (8 - fx) * fy * C + fx * fy * D + 32) >> 6


def wp_combine(p0, p1, use0, use1, w0, o0, w1, o1, d):
    """Unified 8.4.2.3 combine: default / explicit / implicit collapse
    into per-block (w, o, logWD); all [n4] broadcast over block dims."""
    bshape = (-1,) + (1,) * (p0.ndim - 1)
    use0b, use1b = use0.reshape(bshape), use1.reshape(bshape)
    w0b, o0b = w0.reshape(bshape), o0.reshape(bshape)
    w1b, o1b = w1.reshape(bshape), o1.reshape(bshape)
    db = d.reshape(bshape)
    ps = torch.where(use0b, p0, p1)
    ws = torch.where(use0b, w0b, w1b)
    os_ = torch.where(use0b, o0b, o1b)
    one = torch.ones_like(db)
    single = _clip255(((ps * ws + ((one << db) >> 1)) >> db) + os_)
    bi = _clip255(((p0 * w0b + p1 * w1b + (one << db)) >> (db + 1))
                  + ((o0b + o1b + 1) >> 1))
    return torch.where(use0b & use1b, bi, single)


def mc_frame_plain(refs_y, refs_cb, refs_cr, rs0, rs1, mv0, mv1, wp, mb_w,
                   mb_h, row0=0):
    """The JAX ``mc_frame``: returns (pred_y [n,16,16], pred_c [n,2,8,8])
    int32 in MB-tile layout.

    refs_*: [R,H,W] reference stacks (any integer type); rs0/rs1 [n4]
    stack slot per 4x4 block per list (-1 = unused); mv0/mv1 [n4,2]; wp:
    dict of per-block combine parameters (``WP_KEYS``), each [n4].
    rs1 = mv1 = None is a P picture: no list-1 window is read.  The
    planes' size comes from the stacks; `row0` (in 4x4 rows) places the
    first block row in them (0 for whole pictures; banded P recon passes
    its extended plane's apron)."""
    H, W = refs_y.shape[1:]
    Hc, Wc = refs_cb.shape[1:]
    W4 = mb_w * 4
    n4 = W4 * mb_h * 4
    dev = refs_y.device
    idx = torch.arange(n4, device=dev)
    bx4 = idx % W4
    by4 = idx // W4 + row0
    mv0 = mv0.to(torch.int32)
    one_list = rs1 is None
    use0 = rs0 >= 0
    use1 = torch.zeros_like(use0) if one_list else rs1 >= 0
    r0 = rs0.clamp(min=0)
    r1 = None if one_list else rs1.clamp(min=0)
    mv1 = None if one_list else mv1.to(torch.int32)
    wp = {k: torch.as_tensor(v, device=dev).to(torch.int32)
          for k, v in wp.items()}

    ry = refs_y.to(torch.int32).reshape(-1)
    p0y = mc_luma_blocks(ry, r0, mv0, bx4, by4, H, W)
    p1y = p0y if one_list else mc_luma_blocks(ry, r1, mv1, bx4, by4, H, W)
    py = wp_combine(p0y, p1y, use0, use1, wp["wy0"], wp["oy0"], wp["wy1"],
                    wp["oy1"], wp["dy"])
    pcs = []
    for ref, pl in ((refs_cb, "cb"), (refs_cr, "cr")):
        rc = ref.to(torch.int32).reshape(-1)
        p0 = mc_chroma_blocks(rc, r0, mv0, bx4, by4, Hc, Wc)
        p1 = p0 if one_list else mc_chroma_blocks(rc, r1, mv1, bx4, by4,
                                                  Hc, Wc)
        pcs.append(wp_combine(p0, p1, use0, use1, wp[f"w{pl}0"],
                              wp[f"o{pl}0"], wp[f"w{pl}1"], wp[f"o{pl}1"],
                              wp["dc"]))
    n = mb_w * mb_h
    pred_y = (py.reshape(mb_h, 4, mb_w, 4, 4, 4)
              .permute(0, 2, 1, 4, 3, 5).reshape(n, 16, 16))
    pc = torch.stack(pcs, 1)                                   # [n4,2,2,2]
    pred_c = (pc.reshape(mb_h, 4, mb_w, 4, 2, 2, 2)
              .permute(0, 2, 4, 1, 5, 3, 6).reshape(n, 2, 8, 8))
    return pred_y, pred_c


def resolve_wp_blocks_torch(ri0, ri1, wp_mode, expl, denom_y, denom_c, imp,
                            n_ref1):
    """Port of ``resolve_wp_blocks_jax``: per-block combine parameters
    (``WP_KEYS``, int32 [n4]) from the list reference indices ri0/ri1
    [n4] (-1 unused) and the picture's tables.  wp_mode 0/1/2 is a
    Python int; expl [2,nmax,6] and imp [ncap,2] may be zero-padded;
    denom_y/denom_c/n_ref1 may be 0-d tensors."""
    dev = ri0.device
    ri0, ri1 = ri0.to(torch.int32), ri1.to(torch.int32)
    z = torch.zeros_like(ri0)
    one = torch.ones_like(ri0)
    out = {"wy0": one, "oy0": z, "wy1": one, "oy1": z, "dy": z,
           "wcb0": one, "ocb0": z, "wcb1": one, "ocb1": z,
           "wcr0": one, "ocr0": z, "wcr1": one, "ocr1": z, "dc": z}
    if wp_mode == 1:
        expl = torch.as_tensor(expl, device=dev).to(torch.int32)
        e0 = expl[0, ri0.clamp(0, expl.shape[1] - 1).long()]
        e1 = expl[1, ri1.clamp(0, expl.shape[1] - 1).long()]
        out.update(wy0=e0[:, 0], oy0=e0[:, 1], wy1=e1[:, 0], oy1=e1[:, 1],
                   dy=z + denom_y,
                   wcb0=e0[:, 2], ocb0=e0[:, 3], wcb1=e1[:, 2],
                   ocb1=e1[:, 3], wcr0=e0[:, 4], ocr0=e0[:, 5],
                   wcr1=e1[:, 4], ocr1=e1[:, 5], dc=z + denom_c)
    elif wp_mode == 2:
        imp = torch.as_tensor(imp, device=dev).to(torch.int32)
        bi = (ri0 >= 0) & (ri1 >= 0)
        pair = (ri0.clamp(min=0) * n_ref1 + ri1.clamp(min=0)) \
            .clamp(0, imp.shape[0] - 1).long()
        w0 = torch.where(bi, imp[pair, 0], 1)
        w1 = torch.where(bi, imp[pair, 1], 1)
        d = torch.where(bi, 5, 0).to(torch.int32)
        out.update(wy0=w0, wy1=w1, dy=d, wcb0=w0, wcb1=w1, wcr0=w0, wcr1=w1,
                   dc=d)
    return {k: v.to(torch.int32) for k, v in out.items()}


def resolve_wp_blocks(ri0, ri1, wp_mode, expl, denom_y, denom_c, imp,
                      n_ref1):
    """Host-side per-block WP parameter resolution (numpy); a copy of
    ``dryv_tpu/kernels/inter.py`` ``resolve_wp_blocks``.

    ri0/ri1 [n4] list ref indices (-1 unused); wp_mode 0/1/2; expl
    [2, nmax, 6] (wy,oy,wcb,ocb,wcr,ocr) for explicit mode; imp
    [n_ref0*n_ref1, 2] implicit bi weights.  Returns the dict mc_frame
    wants, all int32 [n4]."""
    n4 = ri0.shape[0]
    z = np.zeros(n4, np.int32)
    one = np.ones(n4, np.int32)
    out = {"wy0": one.copy(), "oy0": z.copy(), "wy1": one.copy(),
           "oy1": z.copy(), "dy": z.copy(),
           "wcb0": one.copy(), "ocb0": z.copy(), "wcb1": one.copy(),
           "ocb1": z.copy(), "wcr0": one.copy(), "ocr0": z.copy(),
           "wcr1": one.copy(), "ocr1": z.copy(), "dc": z.copy()}
    if wp_mode == 1:
        i0 = np.clip(ri0, 0, expl.shape[1] - 1)
        i1 = np.clip(ri1, 0, expl.shape[1] - 1)
        e0 = expl[0, i0]
        e1 = expl[1, i1]
        out.update(
            wy0=e0[:, 0], oy0=e0[:, 1], wy1=e1[:, 0], oy1=e1[:, 1],
            dy=np.full(n4, denom_y, np.int32),
            wcb0=e0[:, 2], ocb0=e0[:, 3], wcb1=e1[:, 2], ocb1=e1[:, 3],
            wcr0=e0[:, 4], ocr0=e0[:, 5], wcr1=e1[:, 4], ocr1=e1[:, 5],
            dc=np.full(n4, denom_c, np.int32))
    elif wp_mode == 2:
        bi = (ri0 >= 0) & (ri1 >= 0)
        pair = (np.clip(ri0, 0, None) * n_ref1 +
                np.clip(ri1, 0, None)).astype(np.int64)
        pair = np.clip(pair, 0, imp.shape[0] - 1)
        w0 = np.where(bi, imp[pair, 0], 1).astype(np.int32)
        w1 = np.where(bi, imp[pair, 1], 1).astype(np.int32)
        d = np.where(bi, 5, 0).astype(np.int32)
        out.update(wy0=w0, wy1=w1, dy=d, wcb0=w0, wcb1=w1,
                   wcr0=w0, wcr1=w1, dc=d)
    return {k: np.ascontiguousarray(v, np.int32) for k, v in out.items()}


def mc_frame_wire_plain(refs_y, refs_cb, refs_cr, rs0, rs1, mv0, mv1, wp,
                        mb_w, mb_h, row0=0):
    """Plain PyTorch version of B4 with ``mc_frame``'s contract (the
    wire's fields, the picture's WP tables, uint8 out, blocks that use no
    list predicting 0): ``resolve_wp_blocks_torch`` and
    ``mc_frame_plain``, on any device."""
    n = mb_w * mb_h
    mode = int(wp["mode"])
    if mode == 0:
        blk = resolve_wp_blocks_torch(rs0, rs0, 0, None, 0, 0, None, 1)
    else:
        # a P picture has no list-1 index, as B4 reads none
        ri1 = wp["ri1"] if rs1 is not None else torch.full_like(
            rs0, -1)
        misc = wp["misc"].to(torch.int32)
        blk = resolve_wp_blocks_torch(wp["ri0"], ri1, mode,
                                      wp["expl"], misc[0], misc[1],
                                      wp["imp"], misc[2])
    rs0i = rs0.to(torch.int32)
    rs1i = None if rs1 is None else rs1.to(torch.int32)
    py, pc = mc_frame_plain(refs_y, refs_cb, refs_cr, rs0i, rs1i, mv0,
                            mv1, blk, mb_w, mb_h, row0)
    used = rs0i >= 0
    if rs1i is not None:
        used |= rs1i >= 0
    used = used.view(mb_h, 4, mb_w, 4)
    uy = used.permute(0, 2, 1, 3).reshape(n, 4, 1, 4, 1) \
        .expand(n, 4, 4, 4, 4).reshape(n, 16, 16)
    uc = used.permute(0, 2, 1, 3).reshape(n, 1, 4, 1, 4, 1) \
        .expand(n, 2, 4, 2, 4, 2).reshape(n, 2, 8, 8)
    return (torch.where(uy, py, 0).to(torch.uint8),
            torch.where(uc, pc, 0).to(torch.uint8))


def _check_fields(rs0, rs1, mv0, mv1, wp, n4):
    """The wire fields B4 reads in place: int8 slots and reference
    indices [n4] sharing one stride, int16 vectors [n4, 2] with a
    contiguous last axis sharing one stride, on one device."""
    rs = [t for t in (rs0, rs1, wp.get("ri0"), wp.get("ri1"))
          if t is not None]
    mv = [t for t in (mv0, mv1) if t is not None]
    dev = rs0.device
    for t in rs + mv:
        if t.device != dev:
            raise ValueError("mc_frame's inputs must share one device")
    if any(t.dtype != torch.int8 or t.shape != (n4,)
           or t.stride() != rs0.stride() for t in rs):
        raise ValueError(f"slots and reference indices must be int8 [{n4}] "
                         f"views of one stride")
    if any(t.dtype != torch.int16 or t.shape != (n4, 2) or t.stride(1) != 1
           or t.stride() != mv0.stride() for t in mv):
        raise ValueError(f"motion vectors must be int16 [{n4}, 2] views of "
                         f"one stride with a contiguous last axis")
    if (rs1 is None) != (mv1 is None):
        raise ValueError("rs1 and mv1 are both given (B) or both None (P)")


def mc_frame(refs_y, refs_cb, refs_cr, rs0, rs1, mv0, mv1, wp, mb_w, mb_h,
             row0=0):
    """B4: motion-compensated prediction of a picture (or of a band of its
    MB rows) -> (pred_y uint8 [n,16,16], pred_c uint8 [n,2,8,8]) in
    MB-tile layout.  Blocks that use no list (intra MBs) predict 0.

    refs_*: uint8 [R,H,W] reference stacks (chroma [R,Hc,Wc]); rs0/rs1:
    int8 [n4] stack slot per 4x4 block per list (-1 = list unused), slots
    below R; mv0/mv1: int16 [n4, 2] quarter-pel (x, y).  rs1 = mv1 =
    None is a P picture: no list-1 window is read.  The per-block fields
    may be strided views of the packed wire (``device_ipb_packed``).
    wp: the picture's weighted-prediction tables, {"mode": 0/1/2 (int),
    "ri0", "ri1": int8 [n4] reference indices (-1 unused), "expl": int16
    [2,32,6], "imp": int16 [256,2], "misc": int32 [4] (denom_y, denom_c,
    n_ref1, -)}; mode 0 reads none of them.  `row0` (4x4 rows) places the
    first block row in the planes.  CPU tensors take
    ``mc_frame_wire_plain``; CUDA tensors launch the kernel, counted in
    ``mc_frame.launches``."""
    n = mb_w * mb_h
    n4 = 16 * n
    R, H, W = refs_y.shape
    Hc, Wc = refs_cb.shape[1:]
    if W != 16 * mb_w or Wc != 8 * mb_w or refs_cr.shape != refs_cb.shape \
            or refs_cb.shape[0] != R or Hc != H // 2 \
            or 4 * (row0 + 4 * mb_h) > H or row0 < 0:
        raise ValueError(f"stacks {tuple(refs_y.shape)} / "
                         f"{tuple(refs_cb.shape)} do not hold {mb_w}x{mb_h} "
                         f"MBs from 4x4 row {row0}")
    mode = int(wp["mode"])
    if mode not in (0, 1, 2):
        raise ValueError(f"wp mode {mode}")
    _check_fields(rs0, rs1, mv0, mv1, wp, n4)
    if refs_y.device.type == "cpu":
        return mc_frame_wire_plain(refs_y, refs_cb, refs_cr, rs0, rs1, mv0,
                                   mv1, wp, mb_w, mb_h, row0)
    if any(t.dtype != torch.uint8 for t in (refs_y, refs_cb, refs_cr)):
        raise ValueError("B4 reads uint8 reference stacks")
    if any(t.data_ptr() % 4 for t in (refs_y, refs_cb, refs_cr)):
        raise ValueError("B4's reference stacks must start on 4-byte "
                         "boundaries (it reads their rows in words)")
    tabs = ((wp.get("expl"), (2, 32, 6), torch.int16),
            (wp.get("imp"), (256, 2), torch.int16),
            (wp.get("misc"), (4,), torch.int32))
    if mode:
        for t, shape, dt in tabs:
            if t.shape != shape or t.dtype != dt:
                raise ValueError(f"WP table must be {dt} {shape}, got "
                                 f"{t.dtype} {tuple(t.shape)}")
    _build.check_cuda(refs_y, refs_cb, refs_cr,
                      *(t for t, _, _ in tabs if mode))
    if rs0.device != refs_y.device:
        raise ValueError("mc_frame's fields and stacks must share a device")
    pred_y = torch.empty((n, 16, 16), dtype=torch.uint8, device=rs0.device)
    pred_c = torch.empty((n, 2, 8, 8), dtype=torch.uint8, device=rs0.device)
    _build.call("dt_inter_mc", refs_y, refs_cb, refs_cr, mv0, mv1, rs0, rs1,
                wp.get("ri0") if mode else None,
                wp.get("ri1") if mode else None,
                *(t if mode else None for t, _, _ in tabs),
                pred_y, pred_c, R, H, W, mb_w, mb_h, row0, mv0.stride(0),
                rs0.stride(0), 1 if rs1 is None else 2, mode)
    mc_frame.launches += 1
    return pred_y, pred_c


mc_frame.launches = 0
