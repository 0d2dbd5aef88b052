"""csrc/sim_topk.cu: the least work one launch needs.

Operations: 4 f32 operations per (query, valid token, key channel) of the
similarity with a selection term (2*qk*qe*mk - qe*mk^2), per video.
Bytes: each input read once (qk and qe in f32, the valid tokens' keys and
shrinkage in the ring's dtype, the validity byte of every slot) and the
output pair (values, indices) written once. From chip_smoke.py's bound of
the kernel, with the valid tokens in place of the ring's slots.
"""


def cost(launch: dict):
    b, q, n, ck, k = (launch[x] for x in ("b", "q", "n", "ck", "k"))
    nv, isz = launch["nv"], launch["isz"]
    flops = 4 * q * nv * ck
    nbytes = b * (4 * 2 * q * ck + n + 8 * q * k) + isz * nv * (ck + 1)
    return flops, nbytes
