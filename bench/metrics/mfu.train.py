"""Model FLOPs of all workers' forward and backward (the configuration's
formula) over the untraced window steps' time, against the fp32 peak."""
from bench.roofline import PEAK_FP32_PER_S


def read(m):
    steps = m.get("untraced_step_s")
    if not steps or "flops_per_step" not in m:
        return None
    return 100.0 * m["flops_per_step"] * len(steps) / sum(steps) \
        / PEAK_FP32_PER_S
