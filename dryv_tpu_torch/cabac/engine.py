# Copy of dryv_tpu/cabac/engine.py.
"""CABAC binary arithmetic decoder (spec 9.3.3.2).

Python reference implementation — the correctness anchor for the C++ host
entropy stage (dryv_tpu/native) and the behavioural mirror of the reference
engine at src/video/cabac/mod.rs:1207-1307 (decision/bypass/terminate/renorm).
"""
from __future__ import annotations

from . import tables
from .tables import RANGE_LPS, TRANS_LPS, TRANS_MPS, init_context_states


class CabacDecoder:
    __slots__ = ("data", "pos", "bit_len", "range", "offset", "p_state",
                 "val_mps", "bin_count")

    def __init__(self, rbsp: bytes, bit_offset: int, slice_qp_y: int, init_mode: int):
        """rbsp: EPB-stripped slice data; bit_offset: first bit of slice data
        after cabac_alignment_one_bit (must be byte aligned)."""
        assert bit_offset % 8 == 0
        self.data = rbsp
        self.pos = bit_offset
        self.bit_len = len(rbsp) * 8
        p_state, val_mps = init_context_states(slice_qp_y, init_mode)
        self.p_state = p_state.tolist()
        self.val_mps = val_mps.tolist()
        # 9.3.1.2 engine init
        self.range = 510
        self.offset = self._read_bits(9)
        if self.offset in (510, 511):
            raise ValueError("illegal CABAC initial offset")
        self.bin_count = 0

    def _read_bit(self) -> int:
        p = self.pos
        if p >= self.bit_len:
            # spec allows reading past the end during the final renorms;
            # trailing bits are 0 (cabac_zero_word territory).
            self.pos = p + 1
            return 0
        self.pos = p + 1
        return (self.data[p >> 3] >> (7 - (p & 7))) & 1

    def _read_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self._read_bit()
        return v

    # -- spec 9.3.3.2.1 -----------------------------------------------------
    def decision(self, ctx_idx: int) -> int:
        state = self.p_state[ctx_idx]
        lps = int(RANGE_LPS[state][(self.range >> 6) & 3])
        self.range -= lps
        if self.offset >= self.range:
            # LPS path
            bin_val = 1 - self.val_mps[ctx_idx]
            self.offset -= self.range
            self.range = lps
            if state == 0:
                self.val_mps[ctx_idx] = 1 - self.val_mps[ctx_idx]
            self.p_state[ctx_idx] = int(TRANS_LPS[state])
        else:
            bin_val = self.val_mps[ctx_idx]
            self.p_state[ctx_idx] = int(TRANS_MPS[state])
        # renorm (9.3.3.2.2)
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self._read_bit()
        self.bin_count += 1
        return bin_val

    # -- spec 9.3.3.2.3 -----------------------------------------------------
    def bypass(self) -> int:
        self.offset = (self.offset << 1) | self._read_bit()
        self.bin_count += 1
        if self.offset >= self.range:
            self.offset -= self.range
            return 1
        return 0

    def bypass_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bypass()
        return v

    # -- spec 9.3.3.2.4 (ctxIdx 276: end_of_slice_flag / I_PCM) -------------
    def terminate(self) -> int:
        self.range -= 2
        self.bin_count += 1
        if self.offset >= self.range:
            return 1
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self._read_bit()
        return 0

    # -- 9.3.1.2 re-init after PCM bytes ------------------------------------
    def reinit_engine(self) -> None:
        assert self.pos % 8 == 0
        self.range = 510
        self.offset = self._read_bits(9)

    def byte_align(self) -> None:
        self.pos = (self.pos + 7) & ~7

    # -- binarization helpers (spec 9.3.2) ----------------------------------
    def unary(self, ctx_base: int, ctx_incs) -> int:
        """Unary binarization: read bins until 0; ctx_incs[i] gives ctxIdxInc
        for bin i (last entry repeats)."""
        k = 0
        while self.decision(ctx_base + ctx_incs[min(k, len(ctx_incs) - 1)]):
            k += 1
        return k

    def tu(self, ctx_base: int, ctx_incs, c_max: int) -> int:
        """Truncated unary (9.3.2.2)."""
        k = 0
        while k < c_max and self.decision(ctx_base + ctx_incs[min(k, len(ctx_incs) - 1)]):
            k += 1
        return k

    def ueg_suffix(self, prefix: int, u_coff: int, k: int, signed: bool) -> int:
        """UEGk suffix (9.3.2.3): call after a TU prefix reached u_coff."""
        value = prefix
        if prefix >= u_coff:
            # exp-Golomb suffix, bypass-coded
            while self.bypass():
                value += 1 << k
                k += 1
            while k > 0:
                k -= 1
                if self.bypass():
                    value += 1 << k
        if signed and value != 0:
            if self.bypass():
                value = -value
        return value
