# Copy of dryv_tpu/avc/slice_map.py.
"""FMO slice-group map derivation (spec 8.2.2.1-8.2.2.8).

Behavioural mirror of reference SliceGroup::init_sgmap (pps.rs:145-300):
interleaved, dispersed, foreground+leftover, box-out, raster wipe, wedge
wipe, and explicit maps; plus the slice-group-aware next-MB iteration
(reference slice/mod.rs:319-326 next_mb_addr)."""
from __future__ import annotations

import numpy as np

from .pps import PPS, SliceGroups
from .sps import SPS


def map_units_to_sgmap(pps: PPS, sps: SPS, slice_group_change_cycle: int = 0
                       ) -> np.ndarray:
    """Returns sgmap [pic_size_in_map_units] of slice group ids.

    Frame coding: map units == macroblocks."""
    w = sps.pic_width_in_mbs
    h = sps.pic_height_in_map_units
    n = w * h
    sg = pps.slice_groups
    if sg is None or sg.num_slice_groups <= 1:
        return np.zeros(n, dtype=np.int32)
    g = sg.num_slice_groups
    out = np.zeros(n, dtype=np.int32)

    if sg.map_type == 0:  # interleaved (8.2.2.1)
        i = 0
        while i < n:
            for grp in range(g):
                run = sg.run_length_minus1[grp] + 1
                for _ in range(run):
                    if i >= n:
                        break
                    out[i] = grp
                    i += 1
                if i >= n:
                    break
    elif sg.map_type == 1:  # dispersed (8.2.2.2)
        for i in range(n):
            out[i] = ((i % w) + (((i // w) * g) // 2)) % g
    elif sg.map_type == 2:  # foreground + leftover (8.2.2.3)
        out[:] = g - 1
        for grp in range(g - 2, -1, -1):
            tl = sg.top_left[grp]
            br = sg.bottom_right[grp]
            y0, x0 = tl // w, tl % w
            y1, x1 = br // w, br % w
            for y in range(y0, min(y1, h - 1) + 1):
                for x in range(x0, min(x1, w - 1) + 1):
                    out[y * w + x] = grp
    elif sg.map_type in (3, 4, 5):
        # changing maps: size of group 0 grows with slice_group_change_cycle
        rate = sg.change_rate_minus1 + 1
        size0 = min(slice_group_change_cycle * rate, n)
        if sg.map_type == 3:  # box-out (8.2.2.4)
            out[:] = 1
            d = sg.change_direction_flag
            x = (w - d) // 2
            y = (h - d) // 2
            x_min = x_max = x
            y_min = y_max = y
            xdir = d - 1
            ydir = d
            cnt = 0
            while cnt < size0:
                if 0 <= x < w and 0 <= y < h and out[y * w + x] == 1:
                    out[y * w + x] = 0
                    cnt += 1
                if xdir == -1 and x == x_min:
                    x_min = max(x_min - 1, 0)
                    x = x_min
                    xdir = 0
                    ydir = 2 * d - 1
                elif xdir == 1 and x == x_max:
                    x_max = min(x_max + 1, w - 1)
                    x = x_max
                    xdir = 0
                    ydir = 1 - 2 * d
                elif ydir == -1 and y == y_min:
                    y_min = max(y_min - 1, 0)
                    y = y_min
                    xdir = 1 - 2 * d
                    ydir = 0
                elif ydir == 1 and y == y_max:
                    y_max = min(y_max + 1, h - 1)
                    y = y_max
                    xdir = 2 * d - 1
                    ydir = 0
                else:
                    x += xdir
                    y += ydir
        elif sg.map_type == 4:  # raster scan wipe (8.2.2.5)
            out[:] = 1
            if sg.change_direction_flag == 0:
                out[:size0] = 0
            else:
                if size0 > 0:
                    out[n - size0:] = 0
        else:  # map_type 5: wipe (vertical, column-major) (8.2.2.6)
            out[:] = 1
            k = 0
            if sg.change_direction_flag == 0:
                for x in range(w):
                    for y in range(h):
                        if k >= size0:
                            break
                        out[y * w + x] = 0
                        k += 1
            else:
                for x in range(w - 1, -1, -1):
                    for y in range(h - 1, -1, -1):
                        if k >= size0:
                            break
                        out[y * w + x] = 0
                        k += 1
    elif sg.map_type == 6:  # explicit (8.2.2.7)
        ids = sg.explicit_ids
        for i in range(n):
            out[i] = ids[i] if i < len(ids) else 0
    return out


def next_mb_addr(sgmap: np.ndarray, addr: int) -> int:
    """Next MB of the same slice group (reference slice/mod.rs:319-326)."""
    grp = sgmap[addr]
    i = addr + 1
    n = len(sgmap)
    while i < n and sgmap[i] != grp:
        i += 1
    return i  # == n when exhausted


def first_mb_of_group(sgmap: np.ndarray, first_mb_in_slice: int) -> int:
    return first_mb_in_slice
