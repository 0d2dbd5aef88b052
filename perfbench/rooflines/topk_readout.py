"""csrc/topk_readout.cu: the least work one launch needs.

Operations: a multiply and an add per (query, selected slot, value column).
Bytes: the indices and weights read once, each distinct value row the
indices name read once (in the ring's dtype), the f32 output written once.
From chip_smoke.py's bound of the kernel; it does not depend on how the
kernel stages its rows.
"""


def cost(launch: dict):
    b, q, k, c = (launch[x] for x in ("b", "q", "k", "c"))
    flops = 2 * b * q * k * c
    nbytes = b * (8 * q * k + 4 * q * c) + launch["isz"] * launch["rows"] * c
    return flops, nbytes
