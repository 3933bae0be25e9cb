"""Device ms per traced step of the grouped GEMM's kernels (forward, dX
and dW: ``gmm_rows_kernel``, ``gmm_dw_kernel``)."""


def read(m):
    tr = m.get("trace")
    if tr is None or not m.get("traced_steps"):
        return None
    t = tr.kernel_s(r"gmm_rows_kernel|gmm_dw_kernel")
    return 1e3 * t / m["traced_steps"] if t > 0 else None
