"""``torch.cuda.max_memory_allocated()`` over the training window."""


def read(m):
    if "untraced_step_s" not in m or not m.get("peak_bytes"):
        return None
    return m["peak_bytes"] / 2 ** 30
