# Copy of dryv_tpu/avc/neighbors.py.
"""Macroblock and sub-block neighbor derivation (spec 6.4.9-6.4.12).

Progressive frame coding (no MBAFF interleave): the neighbor of MB (x, y) is
A=(x-1,y), B=(x,y-1), C=(x+1,y-1), D=(x-1,y-1), gated on slice/slice-group
membership (reference slice/mod.rs:576-613).  Sub-block neighbor derivation
returns (in_current_mb, neighbor_mb_delta, neighbor_blk_idx).
"""
from __future__ import annotations

# 4x4 luma blocks use z-scan order within the MB: blkIdx =
# 4*quadrant + sub where quadrant/sub are 2x2 rasters (spec 6.4.3).
# Map blkIdx -> (x, y) in 4x4-block units (0..3, 0..3):
ZSCAN_4X4_POS = []
for _idx in range(16):
    _q, _s = _idx >> 2, _idx & 3
    ZSCAN_4X4_POS.append((((_q & 1) << 1) | (_s & 1), (_q & 2) | ((_s >> 1) & 1)))
POS_TO_ZSCAN = {pos: i for i, pos in enumerate(ZSCAN_4X4_POS)}


def blk4x4_neighbor(blk_idx: int, direction: str):
    """Left ('A') or above ('B') neighbor of a z-scan 4x4 luma block.

    Returns (same_mb: bool, nb_blk_idx: int)."""
    x, y = ZSCAN_4X4_POS[blk_idx]
    if direction == "A":
        if x > 0:
            return True, POS_TO_ZSCAN[(x - 1, y)]
        return False, POS_TO_ZSCAN[(3, y)]
    else:
        if y > 0:
            return True, POS_TO_ZSCAN[(x, y - 1)]
        return False, POS_TO_ZSCAN[(x, 3)]


def blk8x8_neighbor(blk_idx: int, direction: str):
    """8x8 luma blocks are a 2x2 raster: idx = 2*y + x."""
    x, y = blk_idx & 1, blk_idx >> 1
    if direction == "A":
        if x > 0:
            return True, y * 2 + (x - 1)
        return False, y * 2 + 1
    else:
        if y > 0:
            return True, (y - 1) * 2 + x
        return False, 2 + x


def chroma_blk_neighbor(blk_idx: int, direction: str, chroma_array_type: int):
    """Chroma 4x4 blocks form a raster grid: 2x2 (4:2:0) or 2x4 (4:2:2);
    idx = w*y + x with w=2."""
    h = 2 * chroma_array_type  # rows: 2 for 4:2:0, 4 for 4:2:2
    x, y = blk_idx & 1, blk_idx >> 1
    if direction == "A":
        if x > 0:
            return True, y * 2 + (x - 1)
        return False, y * 2 + 1
    else:
        if y > 0:
            return True, (y - 1) * 2 + x
        return False, (h - 1) * 2 + x


def mbaff_neighbor(addr: int, xN: int, yN: int, mb_w: int, field_of_pair,
                   maxw: int = 16, maxh: int = 16):
    """Neighbouring-location derivation for MBAFF frames (spec 6.4.11 /
    Table 6-4 semantics; the reference encodes the same derivation in
    slice/mod.rs:412-571).

    Geometric model of the table: left-family neighbours (yN >= 0)
    convert the current MB's pair-row into the left pair's frame/field
    mapping; above-family neighbours (yN < 0) target the pair-row just
    above in the current MB's own parity terms (frame MBs take the
    geometric row; field MBs the nearest same-parity row), then convert
    to the neighbour pair's mapping.

    field_of_pair(pair_addr) -> field flag of that pair.
    Returns (mb_addr, xW, yM) or None (out of picture / undecoded).
    maxw/maxh: 16/16 luma, 8/8 chroma 4:2:0, 8/16 chroma 4:2:2."""
    pair, bot = addr >> 1, addr & 1
    px, py = pair % mb_w, pair // mb_w
    fld = field_of_pair(pair)
    if 0 <= xN < maxw and 0 <= yN < maxh:
        return addr, xN, yN
    if yN >= 0:
        if xN >= maxw or px == 0:
            return None
        npair = pair - 1
        yP = (2 * yN + bot) if fld else (maxh * bot + yN)
    elif not fld and bot:
        # frame bottom MB: the row above is the last row of the top
        # half of its own pair (B) or of the left pair (D); the
        # above-right (C) lies in the not-yet-decoded right pair
        if xN >= maxw:
            return None
        if xN < 0 and px == 0:
            return None
        npair = pair if xN >= 0 else pair - 1
        yP = maxh - 1
    else:
        if py == 0:
            return None
        if xN < 0:
            if px == 0:
                return None
            npair = pair - mb_w - 1
        elif xN < maxw:
            npair = pair - mb_w
        else:
            if px + 1 >= mb_w:
                return None
            npair = pair - mb_w + 1
        # frame top: geometric last pair-row; field: same-parity row
        yP = 2 * maxh - 1 if (not fld or bot) else 2 * maxh - 2
    if field_of_pair(npair):
        return npair * 2 + (yP & 1), xN % maxw, yP >> 1
    return npair * 2 + (1 if yP >= maxh else 0), xN % maxw, yP % maxh
