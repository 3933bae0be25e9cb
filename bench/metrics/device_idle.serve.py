"""Share of the traced serving steps in which no device operation ran
(the union of kernel, copy and set intervals)."""


def read(m):
    tr = m.get("trace")
    if tr is None or not m.get("serve") or not m.get("traced_s"):
        return None
    return 100.0 * (1.0 - tr.busy_s / m["traced_s"])
