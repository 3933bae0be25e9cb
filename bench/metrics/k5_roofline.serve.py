"""K5's least time on each logits stack it aggregated in the traced
steps (``bench.roofline``, the stack counted once) over the device time
of its K1, selection and K4 kernels there."""


def read(m):
    tr = m.get("trace")
    if tr is None or not m.get("k5_least_s"):
        return None
    t = tr.kernel_s(r"gram_kernel|select_kernel|combine_\w+_kernel")
    return 100.0 * m["k5_least_s"] / t if t > 0 else None
