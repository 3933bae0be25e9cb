"""The serving window's least time over its measured time: per decode
step and per admission, the larger of its bytes (every replica's weights
and the cache it reads and writes) over the HBM rate and its FLOPs over
the fp32 peak (the configuration's formulas)."""


def read(m):
    if not m.get("least_s") or not m.get("window_s"):
        return None
    return 100.0 * m["least_s"] / m["window_s"]
