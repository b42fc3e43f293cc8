# Copy of dryv_tpu/native/entropy.py.
"""ctypes bindings for the native CABAC entropy stage.

decode_picture_slices(slices, sps, pps) -> dense syntax arrays (raster
coefficient blocks + inter motion syntax), covering I/SI/P/B CABAC slices.
Output contract matches the Python SliceCoder path (verified in tests).
"""
from __future__ import annotations

import ctypes as ct

import numpy as np

from .build import build

# native kind codes (entropy.cc): extends the device numbering
NK_I4, NK_I8, NK_I16, NK_PCM = 0, 1, 2, 3
NK_P, NK_P8X8, NK_P_SKIP = 4, 5, 6
NK_B, NK_B8X8, NK_B_SKIP, NK_B_DIRECT = 7, 8, 9, 10
NK_SI = 11

# map native kind -> (python MbKind value, transform8x8-folded)
_MBKIND_OF_NATIVE = {NK_I4: 0, NK_I8: 0, NK_I16: 1, NK_PCM: 2, NK_P: 3,
                     NK_P8X8: 4, NK_P_SKIP: 5, NK_B: 6, NK_B8X8: 7,
                     NK_B_SKIP: 8, NK_B_DIRECT: 9, NK_SI: 10}


class PicParams(ct.Structure):
    _fields_ = [("mb_w", ct.c_int32), ("mb_h", ct.c_int32),
                ("chroma_array_type", ct.c_int32),
                ("transform_8x8_mode_flag", ct.c_int32),
                ("bit_depth_luma", ct.c_int32),
                ("bit_depth_chroma", ct.c_int32),
                ("direct_8x8_inference_flag", ct.c_int32)]


class SliceParams(ct.Structure):
    _fields_ = [("rbsp_off", ct.c_int64), ("rbsp_len", ct.c_int64),
                ("bit_off", ct.c_int64), ("first_mb", ct.c_int32),
                ("slice_qp", ct.c_int32), ("slice_type", ct.c_int32),
                ("cabac_init_idc", ct.c_int32), ("nref_l0", ct.c_int32),
                ("nref_l1", ct.c_int32)]


_P = ct.POINTER(ct.c_int32)


class Out(ct.Structure):
    _fields_ = [("kind", _P), ("qp_y", _P), ("cbp", _P), ("i16_mode", _P),
                ("chroma_mode", _P), ("modes4", _P), ("modes8", _P),
                ("luma4", _P), ("luma8", _P), ("luma_dc", _P),
                ("chroma_dc", _P), ("chroma_ac", _P), ("pcm_y", _P),
                ("pcm_c", _P), ("slice_id", _P),
                ("bin_count", ct.POINTER(ct.c_int64)),
                ("mb_type_code", _P), ("sub_mb_type", _P),
                ("ref_idx", _P), ("mvd", _P), ("transform8", _P)]


_U8P = ct.POINTER(ct.c_uint8)
_PP = ct.POINTER(_U8P)


class InterParams(ct.Structure):
    """Mirrors InterParams in recon.cc (inter picture reconstruction)."""
    _fields_ = [
        ("is_b", ct.c_int32), ("direct_spatial", ct.c_int32),
        ("n_ref0", ct.c_int32), ("n_ref1", ct.c_int32),
        ("ref0_y", _PP), ("ref0_cb", _PP), ("ref0_cr", _PP),
        ("ref1_y", _PP), ("ref1_cb", _PP), ("ref1_cr", _PP),
        ("list0_keys", _P), ("list1_keys", _P),
        ("col_mv0", _P), ("col_mv1", _P),
        ("col_refidx0", _P), ("col_refidx1", _P),
        ("col_refkey0", _P), ("col_refkey1", _P),
        ("col_shortterm", ct.c_int32), ("col_default_key", ct.c_int32),
        ("n_tk", ct.c_int32),
        ("tkeys", _P), ("t_ref0", _P), ("t_ident", _P), ("t_dsf", _P),
        ("wp_mode", ct.c_int32), ("wp_denom_y", ct.c_int32),
        ("wp_denom_c", ct.c_int32),
        ("wp_expl", _P), ("wp_stride", ct.c_int32), ("wp_imp", _P),
        ("out_mv0", _P), ("out_mv1", _P),
        ("out_refidx0", _P), ("out_refidx1", _P),
        ("out_refkey0", _P), ("out_refkey1", _P),
        ("out_nz4", _U8P), ("motion_only", ct.c_int32)]


_lib = None


def lib():
    global _lib
    if _lib is None:
        _lib = ct.CDLL(str(build()))
        fn = _lib.dt_decode_picture_slices
        fn.restype = ct.c_int
        fn.argtypes = [ct.POINTER(ct.c_uint8), ct.POINTER(SliceParams),
                       ct.c_int32, PicParams, Out, ct.c_int32]
        fnc = _lib.dt_decode_picture_slices_cavlc
        fnc.restype = ct.c_int
        fnc.argtypes = fn.argtypes
        fmo = _lib.dt_decode_picture_slices_fmo
        fmo.restype = ct.c_int
        fmo.argtypes = fn.argtypes + [_P]
        rf = _lib.dt_reconstruct_islices
        rf.restype = ct.c_int
        rf.argtypes = [_P] * 15 + [ct.c_int32] * 4 + \
                      [ct.POINTER(ct.c_uint8)] * 3
        db = _lib.dt_deblock_frame
        db.restype = ct.c_int
        U8 = ct.POINTER(ct.c_uint8)
        db.argtypes = [U8, U8, U8, ct.c_int32, ct.c_int32, ct.c_int32,
                       _P, _P, _P, U8, U8, _P, _P, U8, _P, _P, _P, _P]
        rp = _lib.dt_recon_picture
        rp.restype = ct.c_int
        rp.argtypes = [_P] * 20 + [ct.c_int32] * 4 + [U8] * 3 + \
                      [ct.POINTER(InterParams)]
        pk = _lib.dt_pack_frame
        pk.restype = ct.c_int
        pk.argtypes = [_P] * 13 + [ct.c_int32] * 2 + [_P] + \
                      [ct.POINTER(ct.c_uint8), ct.POINTER(ct.c_int8), _P,
                       ct.POINTER(ct.c_uint8), _P,
                       ct.POINTER(ct.c_int16), ct.c_int32,
                       _P, ct.POINTER(ct.c_int16), ct.c_int32,
                       _P, _P, ct.c_int32]
        dp = _lib.dt_decode_pack_picture_slices
        dp.restype = ct.c_int
        dp.argtypes = [ct.POINTER(ct.c_uint8), ct.POINTER(SliceParams),
                       ct.c_int32, PicParams, Out, ct.c_int32, ct.c_int32,
                       _P, ct.POINTER(ct.c_uint8), ct.POINTER(ct.c_int8),
                       _P, ct.POINTER(ct.c_uint8), _P,
                       ct.POINTER(ct.c_int16), ct.c_int32,
                       _P, ct.POINTER(ct.c_int16), ct.c_int32, _P]
    return _lib


def _ptr(a):
    return a.ctypes.data_as(_P)


def decode_picture_islices(slice_datas, sps, pps, n_threads: int = 0,
                           reuse: bool = False):
    """Back-compat intra entry: slice_datas = [(rbsp, bit_off, first_mb,
    slice_qp)]."""
    full = [(rbsp, bitoff, first, qp, 2, 0, 0, 0)
            for rbsp, bitoff, first, qp in slice_datas]
    return decode_picture_slices(full, sps, pps, n_threads, reuse)


# output-buffer arena keyed by (n_mbs, n_slices): fresh np.zeros for every
# frame costs ~10 ms of page faults at 1080p (45 MB of arrays); the decoder
# overwrites/clears every slot a downstream consumer reads for the decoded
# MB kind, so steady-state reuse is safe for the pipeline (opt-in).
_ARENA: dict = {}


def _alloc_out(n: int, ns: int, reuse: bool):
    if reuse and (n, ns) in _ARENA:
        return _ARENA[(n, ns)]
    out = {
        "kind": np.zeros(n, np.int32),
        "qp_y": np.zeros(n, np.int32),
        "cbp": np.zeros(n, np.int32),
        "i16_mode": np.zeros(n, np.int32),
        "chroma_mode": np.zeros(n, np.int32),
        "modes4": np.zeros((n, 16), np.int32),
        "modes8": np.zeros((n, 4), np.int32),
        "luma4": np.zeros((n, 16, 16), np.int32),   # raster 4x4 blocks
        "luma8": np.zeros((n, 4, 64), np.int32),    # raster 8x8 blocks
        "luma_dc": np.zeros((n, 16), np.int32),     # raster DC grid
        "chroma_dc": np.zeros((n, 2, 8), np.int32),
        "chroma_ac": np.zeros((n, 2, 8, 16), np.int32),  # raster, slot 0 zero
        "pcm_y": np.zeros((n, 256), np.int32),
        "pcm_c": np.zeros((n, 128), np.int32),
        "slice_id": np.zeros(n, np.int32),
        "bin_count": np.zeros(ns, np.int64),
        "mb_type_code": np.zeros(n, np.int32),
        "sub_mb_type": np.zeros((n, 4), np.int32),
        "ref_idx": np.zeros((n, 2, 4), np.int32),
        "mvd": np.zeros((n, 2, 16, 2), np.int32),
        "transform8": np.zeros(n, np.int32),
    }
    if reuse:
        _ARENA[(n, ns)] = out
    return out


def _marshal(slice_datas, sps, pps, reuse):
    """Shared ctypes marshaling for the picture-level native entries."""
    mb_w = sps.pic_width_in_mbs
    mb_h = sps.frame_height_in_mbs
    n = mb_w * mb_h
    ns = len(slice_datas)

    rbsp_all = b"".join(s[0] for s in slice_datas)
    sp_arr = (SliceParams * ns)()
    off = 0
    for k, (rbsp, bitoff, first, qp, st, cinit, n0, n1) in \
            enumerate(slice_datas):
        sp_arr[k] = SliceParams(off, len(rbsp), bitoff, first, qp, st,
                                cinit, n0, n1)
        off += len(rbsp)

    out = _alloc_out(n, ns, reuse)
    ostruct = Out(
        _ptr(out["kind"]), _ptr(out["qp_y"]), _ptr(out["cbp"]),
        _ptr(out["i16_mode"]), _ptr(out["chroma_mode"]), _ptr(out["modes4"]),
        _ptr(out["modes8"]), _ptr(out["luma4"]), _ptr(out["luma8"]),
        _ptr(out["luma_dc"]), _ptr(out["chroma_dc"]), _ptr(out["chroma_ac"]),
        _ptr(out["pcm_y"]), _ptr(out["pcm_c"]), _ptr(out["slice_id"]),
        out["bin_count"].ctypes.data_as(ct.POINTER(ct.c_int64)),
        _ptr(out["mb_type_code"]), _ptr(out["sub_mb_type"]),
        _ptr(out["ref_idx"]), _ptr(out["mvd"]), _ptr(out["transform8"]))
    pp = PicParams(mb_w, mb_h, sps.chroma_array_type,
                   pps.transform_8x8_mode_flag,
                   8 + sps.bit_depth_luma_minus8,
                   8 + sps.bit_depth_chroma_minus8,
                   sps.direct_8x8_inference_flag)

    # zero-copy: the native stage only reads the rbsp bytes; keep the
    # joined bytes object alive through the call via the returned tuple
    buf = ct.cast(ct.c_char_p(rbsp_all), ct.POINTER(ct.c_uint8))
    return rbsp_all, buf, sp_arr, ns, pp, out, ostruct


def decode_picture_slices(slice_datas, sps, pps, n_threads: int = 0,
                          reuse: bool = False, sgmap=None):
    """slice_datas: list of (rbsp, bit_off, first_mb, slice_qp, slice_type,
    cabac_init_idc, nref_l0, nref_l1).  Returns dense array dict.

    reuse=True hands back arena-cached output buffers (overwritten on the
    next reuse=True call with the same geometry) — use for throughput
    pipelines that consume the arrays before the next frame decode.

    sgmap: FMO slice-group map ([n] int array, one slice per group in
    group order); CABAC only."""
    keep, buf, sp_arr, ns, pp, out, ostruct = _marshal(slice_datas, sps,
                                                       pps, reuse)
    if sgmap is not None:
        assert pps.entropy_coding_mode_flag
        sg = np.ascontiguousarray(np.asarray(sgmap).reshape(-1), np.int32)
        rc = lib().dt_decode_picture_slices_fmo(
            buf, sp_arr, ct.c_int32(ns), pp, ostruct,
            ct.c_int32(n_threads or min(ns, 16)), _ptr(sg))
        assert rc == 0
        return out
    entry = (lib().dt_decode_picture_slices if pps.entropy_coding_mode_flag
             else lib().dt_decode_picture_slices_cavlc)
    rc = entry(
        buf, sp_arr, ct.c_int32(ns), pp,
        ostruct, ct.c_int32(n_threads or min(ns, 16)))
    assert rc == 0
    return out


def decode_pack_picture_islices(slice_datas, sps, pps, W, dbctl, bmp, vals,
                                cnt, u8meta, exc_idx, exc_delta,
                                ovf_idx, ovf_rows,
                                n_threads: int = 0, reuse: bool = True):
    """Fused intra CABAC decode + device bitmap-ABI pack: each slice
    worker packs its MB range right after decoding it (coefficients
    still cache-hot).  slice_datas as decode_picture_islices.  MBs with
    more than W nonzeros ship their dense 408-coeff int16 row through
    ovf_idx/ovf_rows instead of growing W (wire stays small).  Returns
    (out, max_nz_per_mb, n_exc, n_ovf); max_nz == -1 flags PCM."""
    full = [(rbsp, bitoff, first, qp, 2, 0, 0, 0)
            for rbsp, bitoff, first, qp in slice_datas]
    keep, buf, sp_arr, ns, pp, out, ostruct = _marshal(full, sps, pps,
                                                       reuse)
    pack_out = np.zeros(4, np.int32)
    rc = lib().dt_decode_pack_picture_slices(
        buf, sp_arr, ct.c_int32(ns), pp, ostruct,
        ct.c_int32(n_threads or min(ns, 16)), ct.c_int32(W), _ptr(dbctl),
        bmp.ctypes.data_as(ct.POINTER(ct.c_uint8)),
        vals.ctypes.data_as(ct.POINTER(ct.c_int8)), _ptr(cnt),
        u8meta.ctypes.data_as(ct.POINTER(ct.c_uint8)), _ptr(exc_idx),
        exc_delta.ctypes.data_as(ct.POINTER(ct.c_int16)),
        ct.c_int32(len(exc_idx)), _ptr(ovf_idx),
        ovf_rows.ctypes.data_as(ct.POINTER(ct.c_int16)),
        ct.c_int32(len(ovf_idx)), _ptr(pack_out))
    assert rc == 0
    return out, int(pack_out[0]), int(pack_out[1]), int(pack_out[3])


def reconstruct_islices(out: dict, sps, pps):
    """Native scalar reconstruction from dense entropy outputs (intra).

    Returns (y, cb, cr) uint8 planes.  Single-threaded — this is the
    C++-scalar baseline path (see BASELINE.md)."""
    mb_w = sps.pic_width_in_mbs
    mb_h = sps.frame_height_in_mbs
    W, H = mb_w * 16, mb_h * 16
    y = np.zeros((H, W), np.uint8)
    cb = np.zeros((H // 2, W // 2), np.uint8)
    cr = np.zeros((H // 2, W // 2), np.uint8)
    u8 = ct.POINTER(ct.c_uint8)
    rc = lib().dt_reconstruct_islices(
        _ptr(out["kind"]), _ptr(out["qp_y"]), _ptr(out["cbp"]),
        _ptr(out["i16_mode"]), _ptr(out["chroma_mode"]), _ptr(out["modes4"]),
        _ptr(out["modes8"]), _ptr(out["luma4"]), _ptr(out["luma8"]),
        _ptr(out["luma_dc"]), _ptr(out["chroma_dc"]), _ptr(out["chroma_ac"]),
        _ptr(out["pcm_y"]), _ptr(out["pcm_c"]), _ptr(out["slice_id"]),
        ct.c_int32(mb_w), ct.c_int32(mb_h),
        ct.c_int32(pps.chroma_qp_index_offset),
        ct.c_int32(pps.second_chroma_qp_offset),
        y.ctypes.data_as(u8), cb.ctypes.data_as(u8), cr.ctypes.data_as(u8))
    assert rc == 0
    return y, cb, cr


def pack_frame(out: dict, n: int, W: int, dbctl, bmp, vals, cnt, u8meta,
               exc_idx, exc_delta, ovf_idx, ovf_rows, n_threads: int = 0,
               inter: bool = False):
    """Pack one picture's entropy outputs into the device bitmap ABI.

    bmp [>=n,51] u8, vals [>=n,W] i8, cnt [>=n] i32, u8meta [n,19] u8,
    exc_idx/exc_delta [ecap], ovf_idx [ovcap] i32 / ovf_rows [ovcap,408]
    i16: caller-allocated slot views.  dbctl is an [n_slices,3] int32
    array (disable_idc, alpha_off, beta_off per slice).  inter=True
    packs an I/P/B picture: skip MBs emit empty rows, transform8 inter
    MBs pack luma8 rows, and bit 6 of the kind byte carries the
    transform-size flag.  Returns (max_nz_per_mb, n_exc, n_ovf);
    max_nz == -1 flags PCM (fall back), n_exc > ecap or n_ovf > ovcap
    means the caller must grow and re-pack."""
    n_exc = np.zeros(1, np.int32)
    n_ovf = np.zeros(1, np.int32)
    t8 = _ptr(out["transform8"]) if inter else _P()
    r = lib().dt_pack_frame(
        _ptr(out["kind"]), _ptr(out["qp_y"]), _ptr(out["i16_mode"]),
        _ptr(out["chroma_mode"]), _ptr(out["modes4"]), _ptr(out["modes8"]),
        _ptr(out["slice_id"]), _ptr(out["luma4"]), _ptr(out["luma8"]),
        _ptr(out["luma_dc"]), _ptr(out["chroma_dc"]), _ptr(out["chroma_ac"]),
        t8,
        ct.c_int32(n), ct.c_int32(W), _ptr(dbctl),
        bmp.ctypes.data_as(ct.POINTER(ct.c_uint8)),
        vals.ctypes.data_as(ct.POINTER(ct.c_int8)), _ptr(cnt),
        u8meta.ctypes.data_as(ct.POINTER(ct.c_uint8)), _ptr(exc_idx),
        exc_delta.ctypes.data_as(ct.POINTER(ct.c_int16)),
        ct.c_int32(len(exc_idx)), _ptr(ovf_idx),
        ovf_rows.ctypes.data_as(ct.POINTER(ct.c_int16)),
        ct.c_int32(len(ovf_idx)), _ptr(n_exc), _ptr(n_ovf),
        ct.c_int32(n_threads or 2))
    return int(r), int(n_exc[0]), int(n_ovf[0])
