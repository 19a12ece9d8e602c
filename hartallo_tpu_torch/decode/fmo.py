"""FMO: MbToSliceGroupMap derivation, spec 8.2.2 (map types 0..6), and
the slice-group MB scan order used by the slice parsers.

Reference parity: ``hl_codec_264_fmo.c:16-208`` (all seven map-unit
types).  Progressive frames (MapUnits == MBs).
"""
from __future__ import annotations

import numpy as np


def mb_to_slice_group_map(sps, pps, slice_group_change_cycle: int = 0
                          ) -> np.ndarray:
    """Returns (gh*gw,) int32 slice-group id per MB address.

    slice_group_change_cycle: from the slice header (types 3..5 only).
    """
    gw, gh = sps.pic_width_in_mbs, sps.pic_height_in_mbs
    n = gw * gh
    groups = pps.num_slice_groups_minus1 + 1
    if groups == 1:
        return np.zeros(n, np.int32)
    t = pps.slice_group_map_type
    m = np.zeros(n, np.int32)

    if t == 0:
        # interleaved (8.2.2.1): runs of run_length per group, cycling
        runs = [r + 1 for r in pps.run_length_minus1]
        i = 0
        while i < n:
            for g in range(groups):
                for _ in range(runs[g]):
                    if i >= n:
                        break
                    m[i] = g
                    i += 1
    elif t == 1:
        # dispersed (8.2.2.2)
        for i in range(n):
            m[i] = ((i % gw) + (((i // gw) * groups) // 2)) % groups
    elif t == 2:
        # foreground rectangles + leftover (8.2.2.3)
        m[:] = groups - 1
        for g in range(groups - 2, -1, -1):
            tl = pps.top_left[g]
            br = pps.bottom_right[g]
            y0, x0 = tl // gw, tl % gw
            y1, x1 = br // gw, br % gw
            for y in range(y0, min(y1, gh - 1) + 1):
                for x in range(x0, min(x1, gw - 1) + 1):
                    m[y * gw + x] = g
    elif t in (3, 4, 5):
        # changing slice groups (8.2.2.4-7): 2 groups, size controlled by
        # MapUnitsInSliceGroup0 = min(cycle * rate, n)
        rate = pps.slice_group_change_rate_minus1 + 1
        size0 = min((slice_group_change_cycle) * rate, n)
        d = pps.slice_group_change_direction_flag
        if t == 3:
            # box-out (8.2.2.4): k counts only newly-assigned (vacant) units
            m[:] = 1
            x = (gw - d) // 2
            y = (gh - d) // 2
            left = right = x
            top_b = bot_b = y
            xdir = d - 1
            ydir = d
            k = 0
            # the clamped spiral re-walks filled cells on skewed pictures;
            # gw*gh*(gw+gh) bounds the walk provably (each of the gw+gh
            # ring expansions revisits at most gw*gh cells) — the
            # reference runs the walk to completion (hl_codec_264_fmo.c)
            guard = 0
            while k < size0 and guard < gw * gh * (gw + gh):
                guard += 1
                if m[y * gw + x] == 1:
                    m[y * gw + x] = 0
                    k += 1
                if xdir == -1 and x == left:
                    left = max(left - 1, 0)
                    x = left
                    xdir, ydir = 0, 2 * d - 1
                elif xdir == 1 and x == right:
                    right = min(right + 1, gw - 1)
                    x = right
                    xdir, ydir = 0, 1 - 2 * d
                elif ydir == -1 and y == top_b:
                    top_b = max(top_b - 1, 0)
                    y = top_b
                    xdir, ydir = 1 - 2 * d, 0
                elif ydir == 1 and y == bot_b:
                    bot_b = min(bot_b + 1, gh - 1)
                    y = bot_b
                    xdir, ydir = 2 * d - 1, 0
                else:
                    x += xdir
                    y += ydir
        elif t == 4:
            # raster scan
            m[:] = 1
            if d == 0:
                m[:size0] = 0
            else:
                if size0 > 0:
                    m[n - size0:] = 0
        else:
            # wipe (column-major)
            m[:] = 1
            k = 0
            stop = False
            cols = range(gw) if d == 0 else range(gw - 1, -1, -1)
            for x in cols:
                rows = range(gh) if d == 0 else range(gh - 1, -1, -1)
                for y in rows:
                    if k >= size0:
                        stop = True
                        break
                    m[y * gw + x] = 0
                    k += 1
                if stop:
                    break
    elif t == 6:
        # explicit
        ids = pps.slice_group_id
        for i in range(n):
            m[i] = ids[i] if i < len(ids) else 0
    return m


def slice_scan_order(sg_map: np.ndarray, first_mb: int) -> np.ndarray:
    """MB addresses a slice starting at first_mb visits, in decode order
    (NextMbAddress, 8.2.2 eq 8-25): ascending addresses in the same
    slice group."""
    g = sg_map[first_mb]
    addrs = np.nonzero(sg_map == g)[0]
    return addrs[addrs >= first_mb].astype(np.int32)
