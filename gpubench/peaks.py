"""Peaks of one NVIDIA H100 SXM (80 GB HBM3) that the rooflines divide by.

PEAK_BYTES_S is NVIDIA's published memory bandwidth (data sheet).
PEAK_IMAD_S is derived, not published: the data sheet's 67 TFLOP/s of fp32
is 128 lanes per SM issuing one 2-flop FMA per clock; the Hopper white paper
gives an SM 64 int32 lanes, so the card issues 67e12 / 2 / 2 = 16.75e12
integer multiply-add instructions (IMAD) per second.  Both assume the full
700 W power limit.
"""

PEAK_BYTES_S = 3.35e12
PEAK_IMAD_S = 16.75e12

# 32-bit multiply instructions per modular product of one word (adds and
# compares not counted, so the operation bound is a floor): the 64-bit Shoup
# product is one 64x64 high product (4 IMAD) and two 64-bit low products
# (3 each); the 32-bit one is one high and two low 32-bit products.
IMAD_PER_MULMOD = {64: 10, 32: 3}
