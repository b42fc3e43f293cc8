# Copy of dryv_tpu/cabac/tables.py.
"""Normative CABAC constant tables (Rec. ITU-T H.264).

Loaded from ``tables_data.npz`` (produced by tools/extract_normative_tables.py).
These are standard-mandated values — Tables 9-12..9-33 (context init (m,n)),
9-43 (8x8 significance ctx maps), 9-44 (rangeTabLPS), 9-45 (state
transitions) — identical in every conformant H.264 codec.

Context index space follows the spec's ctxIdx assignment (0..1030, including
the high-profile 4:2:2/4:4:4 residual categories); see reference
src/video/cabac/consts.rs:4-135 for the same layout.
"""
from __future__ import annotations

import numpy as np
from pathlib import Path

_DATA = np.load(Path(__file__).with_name("tables_data.npz"))

CTX_COUNT = 1031

# (m, n) init pairs: [ctxIdx, init_mode, 2]; init_mode 0 = I/SI slices,
# modes 1..3 = cabac_init_idc 0..2 for P/B slices (spec 9.3.1.1).
CTX_INIT: np.ndarray = _DATA["ctx_init"].astype(np.int32)
RANGE_LPS: np.ndarray = _DATA["range_lps"].astype(np.int32)  # [64][4] Table 9-44
TRANS_LPS: np.ndarray = _DATA["trans_lps"].astype(np.int32)  # [64] Table 9-45
TRANS_MPS: np.ndarray = _DATA["trans_mps"].astype(np.int32)  # [64] Table 9-45
# Table 9-43: ctxIdxInc for significant/last_significant in 8x8 blocks,
# columns: [frame sig, field sig, last sig] per coeff position 0..62.
SIG_COEFF_8X8: np.ndarray = _DATA["sig8x8"].astype(np.int32)

# Normative default scaling lists (Tables 7-3/7-4), raster order.
DEFAULT_4X4_INTRA: np.ndarray = _DATA["default_4x4_intra"].astype(np.int32)
DEFAULT_4X4_INTER: np.ndarray = _DATA["default_4x4_inter"].astype(np.int32)
DEFAULT_8X8_INTRA: np.ndarray = _DATA["default_8x8_intra"].astype(np.int32)
DEFAULT_8X8_INTER: np.ndarray = _DATA["default_8x8_inter"].astype(np.int32)

assert CTX_INIT.shape == (CTX_COUNT, 4, 2)


def clip3(lo: int, hi: int, v: int) -> int:
    return lo if v < lo else hi if v > hi else v


def init_context_states(slice_qp_y: int, init_mode: int) -> tuple[np.ndarray, np.ndarray]:
    """Spec 9.3.1.1: derive (pStateIdx, valMPS) for every context.

    init_mode: 0 for I/SI slices, 1+cabac_init_idc for P/B slices.
    Returns int32 arrays (p_state[CTX_COUNT], val_mps[CTX_COUNT]).
    """
    m = CTX_INIT[:, init_mode, 0].astype(np.int64)
    n = CTX_INIT[:, init_mode, 1].astype(np.int64)
    qp = clip3(0, 51, slice_qp_y)
    pre = np.clip(((m * qp) >> 4) + n, 1, 126)
    val_mps = (pre > 63).astype(np.int32)
    p_state = np.where(pre <= 63, 63 - pre, pre - 64).astype(np.int32)
    return p_state, val_mps


# ---------------------------------------------------------------------------
# ctxIdx base offsets (spec Table 9-11 ctxIdx assignment; same layout as
# reference consts.rs).  Only the ones the syntax layer uses are named.
# ---------------------------------------------------------------------------
CTX_MB_TYPE_SI_PRE = 0
CTX_MB_TYPE_I = 3
CTX_MB_SKIP_FLAG_P = 11
CTX_MB_TYPE_P_PRE = 14
CTX_MB_TYPE_P_SUF = 17
CTX_SUB_MB_TYPE_P = 21
CTX_MB_SKIP_FLAG_B = 24
CTX_MB_TYPE_B_PRE = 27
CTX_MB_TYPE_B_SUF = 32
CTX_SUB_MB_TYPE_B = 36
CTX_MVD_X = 40
CTX_MVD_Y = 47
CTX_REF_IDX = 54
CTX_MB_QP_DELTA = 60
CTX_INTRA_CHROMA_PRED_MODE = 64
CTX_PREV_INTRA_PRED_MODE_FLAG = 68
CTX_REM_INTRA_PRED_MODE = 69
CTX_MB_FIELD_DECODING_FLAG = 70
CTX_CBP_LUMA = 73
CTX_CBP_CHROMA = 77
CTX_TERMINATE = 276
CTX_TRANSFORM_SIZE_8X8_FLAG = 399

# Residual block categories (spec Table 9-40): 0 Luma DC (Intra16x16),
# 1 Luma AC (Intra16x16), 2 Luma 4x4, 3 Chroma DC, 4 Chroma AC, 5 Luma 8x8,
# 6-9 Cb (DC/AC/4x4/8x8) for 4:4:4, 10-13 Cr likewise.  The maps below give
# the ctxIdx base per category for each residual syntax element.
CTX_CODED_BLOCK_FLAG = {0: 85, 1: 89, 2: 93, 3: 97, 4: 101, 5: 1012,
                        6: 460, 7: 464, 8: 468, 9: 1016,
                        10: 472, 11: 476, 12: 480, 13: 1020}
CTX_SIG_FRAME = {0: 105, 1: 120, 2: 134, 3: 149, 4: 152, 5: 402,
                 6: 484, 7: 499, 8: 513, 9: 660,
                 10: 528, 11: 543, 12: 557, 13: 718}
CTX_SIG_FIELD = {0: 277, 1: 292, 2: 306, 3: 321, 4: 324, 5: 436,
                 6: 776, 7: 791, 8: 805, 9: 675,
                 10: 820, 11: 835, 12: 849, 13: 733}
CTX_LAST_FRAME = {0: 166, 1: 181, 2: 195, 3: 210, 4: 213, 5: 417,
                  6: 572, 7: 587, 8: 601, 9: 690,
                  10: 616, 11: 631, 12: 645, 13: 748}
CTX_LAST_FIELD = {0: 338, 1: 353, 2: 367, 3: 382, 4: 385, 5: 451,
                  6: 864, 7: 879, 8: 893, 9: 699,
                  10: 908, 11: 923, 12: 937, 13: 757}
CTX_ABS_LEVEL = {0: 227, 1: 237, 2: 247, 3: 257, 4: 266, 5: 426,
                 6: 952, 7: 962, 8: 972, 9: 708,
                 10: 982, 11: 992, 12: 1002, 13: 766}
