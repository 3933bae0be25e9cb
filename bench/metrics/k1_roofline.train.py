"""K1's least time over every leaf (``bench.roofline``) over its device
time (``gram_kernel``) in the traced steps."""


def read(m):
    tr = m.get("trace")
    if tr is None:
        return None
    t = tr.kernel_s(r"gram_kernel")
    if t <= 0:
        return None
    return 100.0 * m["k1_least_s"] * m["traced_steps"] / t
