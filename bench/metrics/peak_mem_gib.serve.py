"""``torch.cuda.max_memory_allocated()`` over the serving window."""


def read(m):
    if not m.get("serve") or not m.get("peak_bytes"):
        return None
    return m["peak_bytes"] / 2 ** 30
