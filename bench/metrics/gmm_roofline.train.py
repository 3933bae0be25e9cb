"""The grouped GEMM's least time per step over the rows it multiplied
(``gmm_least_s``: the configuration's ``gmm_least_s`` of the program's row
counter) over its kernels' device time in the traced steps."""


def read(m):
    tr = m.get("trace")
    if tr is None or not m.get("gmm_least_s") or not m.get("traced_steps"):
        return None
    t = tr.kernel_s(r"gmm_rows_kernel|gmm_dw_kernel")
    if t <= 0:
        return None
    return 100.0 * m["gmm_least_s"] * m["traced_steps"] / t
