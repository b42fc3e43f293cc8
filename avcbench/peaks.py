"""Peak rates of each card the benchmark knows, by the name
``torch.cuda.get_device_name()`` gives.  A roofline share is read only on
a card listed here.

NVIDIA H100 SXM5 80GB: 3.35 TB/s of HBM3 (NVIDIA's data sheet); 32-bit
integer add, shift, compare, min/max and logic results at 64 a clock per
SM at compute capability 9.0 (CUDA C++ Programming Guide, "Arithmetic
Instructions"), times 132 SMs at the 1980 MHz maximum SM clock: 16.727 T/s.
Both hold at the card's full 700 W power limit; each run prints the
card's limit beside its numbers.
"""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_per_s": 3.35e12,
        "int32_ops_per_s": 64 * 132 * 1980e6,
    },
}
