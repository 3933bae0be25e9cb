"""K4's least time over every leaf (``bench.roofline``) over its device
time (``combine_bulyan_kernel``) in the traced steps."""


def read(m):
    tr = m.get("trace")
    if tr is None:
        return None
    t = tr.kernel_s(r"combine_bulyan_kernel")
    if t <= 0:
        return None
    return 100.0 * m["k4_least_s"] * m["traced_steps"] / t
