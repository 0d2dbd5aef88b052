"""csrc/segmax.cu: the least work one launch needs.

Operations: a multiply and an add per (query, valid token, operand
channel) of the one-product similarity. Bytes: the query operands and their
offsets read once, the valid tokens' operands and scales read once, the
validity byte of every slot, the group maxima [Q, nseg] written once. From
chip_smoke.py's bound of the kernel on the paths (valid tokens only).
"""


def cost(launch: dict):
    b, q, n, kc, nseg, nv = (launch[x] for x in ("b", "q", "n", "kc", "nseg",
                                                 "nv"))
    flops = 2 * q * kc * nv
    nbytes = b * (4 * (q * kc + q) + n + 4 * q * nseg) + 4 * nv * (kc + 1)
    return flops, nbytes
