"""csrc/denom_readout.cu: the least work one launch needs.

Operations: per entry of the threshold's support, its similarity again
(a multiply and an add per operand channel) and its weighted value row (a
multiply and an add per value column). Bytes: the group maxima and each
query's operands read once, each support row's value (ring dtype),
operands and scale read once, the validity bytes, the f32 output written
once. From chip_smoke.py's bound of the kernel. The support's entries and
rows are counted from below (harness/port_spans.py: one entry per group
whose maximum reaches the threshold, one row per such group column), so the
share it gives is a lower bound.
"""


def cost(launch: dict):
    b, q, kc, c, nseg = (launch[x] for x in ("b", "q", "kc", "c", "nseg"))
    entries, rows, nv = launch["entries"], launch["rows"], launch["nv"]
    flops = 2 * entries * (kc + c)
    nbytes = b * 4 * q * (nseg + kc + 1 + c) + 4 * nv + \
        rows * (launch["isz"] * c + 4 * kc + 4 + 1)
    return flops, nbytes
