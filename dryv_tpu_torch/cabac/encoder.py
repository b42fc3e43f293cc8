# Copy of dryv_tpu/cabac/encoder.py.
"""CABAC binary arithmetic *encoder* (spec 9.3.4).

Used only by the fixture generator (dryv_tpu/encoder): we have no x264 or
ffmpeg encoder in the image, so conformance test clips are produced by our
own intra encoder and cross-checked against the bundled libavcodec decoder.
"""
from __future__ import annotations

from .tables import RANGE_LPS, TRANS_LPS, TRANS_MPS, init_context_states


class CabacEncoder:
    __slots__ = ("low", "range", "bits_outstanding", "first_bit", "out",
                 "p_state", "val_mps")

    def __init__(self, slice_qp_y: int, init_mode: int):
        p_state, val_mps = init_context_states(slice_qp_y, init_mode)
        self.p_state = p_state.tolist()
        self.val_mps = val_mps.tolist()
        self.low = 0
        self.range = 510
        self.bits_outstanding = 0
        self.first_bit = True
        self.out = []  # list of bits

    # -- 9.3.4.3 PutBit -----------------------------------------------------
    def _put_bit(self, b: int) -> None:
        if self.first_bit:
            self.first_bit = False
        else:
            self.out.append(b)
        while self.bits_outstanding > 0:
            self.out.append(1 - b)
            self.bits_outstanding -= 1

    def _renorm(self) -> None:
        while self.range < 256:
            if self.low >= 512:
                self.low -= 512
                self._put_bit(1)
            elif self.low < 256:
                self._put_bit(0)
            else:
                self.low -= 256
                self.bits_outstanding += 1
            self.range <<= 1
            self.low <<= 1

    # -- 9.3.4.2 EncodeDecision ---------------------------------------------
    def decision(self, ctx_idx: int, bin_val: int) -> None:
        state = self.p_state[ctx_idx]
        lps = int(RANGE_LPS[state][(self.range >> 6) & 3])
        self.range -= lps
        if bin_val != self.val_mps[ctx_idx]:
            self.low += self.range
            self.range = lps
            if state == 0:
                self.val_mps[ctx_idx] = 1 - self.val_mps[ctx_idx]
            self.p_state[ctx_idx] = int(TRANS_LPS[state])
        else:
            self.p_state[ctx_idx] = int(TRANS_MPS[state])
        self._renorm()

    # -- 9.3.4.4 EncodeBypass -----------------------------------------------
    def bypass(self, bin_val: int) -> None:
        self.low <<= 1
        if bin_val:
            self.low += self.range
        if self.low >= 1024:
            self._put_bit(1)
            self.low -= 1024
        elif self.low < 512:
            self._put_bit(0)
        else:
            self.low -= 512
            self.bits_outstanding += 1

    def bypass_bits(self, v: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self.bypass((v >> i) & 1)

    # -- 9.3.4.5 EncodeTerminate / 9.3.4.6 EncodeFlush ----------------------
    def terminate(self, bin_val: int) -> None:
        self.range -= 2
        if bin_val:
            self.low += self.range
            # EncodeFlush
            self.range = 2
            self._renorm()
            self._put_bit((self.low >> 9) & 1)
            # last two bits; lowest bit forced to 1 = rbsp_stop_one_bit
            two = ((self.low >> 7) & 3) | 1
            self.out.append((two >> 1) & 1)
            self.out.append(two & 1)
        else:
            self._renorm()

    # -- binarization helpers ------------------------------------------------
    def unary(self, value: int, ctx_base: int, ctx_incs) -> None:
        for k in range(value):
            self.decision(ctx_base + ctx_incs[min(k, len(ctx_incs) - 1)], 1)
        self.decision(ctx_base + ctx_incs[min(value, len(ctx_incs) - 1)], 0)

    def tu(self, value: int, ctx_base: int, ctx_incs, c_max: int) -> None:
        for k in range(value):
            self.decision(ctx_base + ctx_incs[min(k, len(ctx_incs) - 1)], 1)
        if value < c_max:
            self.decision(ctx_base + ctx_incs[min(value, len(ctx_incs) - 1)], 0)

    def ueg_suffix(self, abs_value: int, u_coff: int, k: int,
                   signed: bool, sign: int) -> None:
        """Encode the UEGk suffix for abs_value (prefix already TU-coded to
        min(abs_value, u_coff)); then optional sign bypass bit."""
        if abs_value >= u_coff:
            suf = abs_value - u_coff
            kk = k
            while suf >= (1 << kk):
                self.bypass(1)
                suf -= 1 << kk
                kk += 1
            self.bypass(0)
            while kk > 0:
                kk -= 1
                self.bypass((suf >> kk) & 1)
        if signed and abs_value != 0:
            self.bypass(1 if sign < 0 else 0)

    # -- raw writes + re-init (I_PCM path, spec 9.3.1.2) ----------------------
    def byte_align(self) -> None:
        while len(self.out) % 8:
            self.out.append(0)

    def write_raw(self, v: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self.out.append((v >> i) & 1)

    def reinit_engine(self) -> None:
        assert len(self.out) % 8 == 0
        self.low = 0
        self.range = 510
        self.bits_outstanding = 0
        self.first_bit = True

    # -- output ---------------------------------------------------------------
    def get_bits(self) -> list:
        """Bitstring after terminate(1); includes rbsp stop bit."""
        return self.out
