"""K1, selection and K4 launches per window step
(``repro_torch.kernels._build.LAUNCHES``)."""


def read(m):
    c, steps = m.get("launches"), m.get("steps")
    if not c or not steps:
        return None
    total = sum(c.get(k, 0) for k in ("pairwise_gram_partial",
                                      "select_weights", "fused_coordinate"))
    return total / steps if total else None
