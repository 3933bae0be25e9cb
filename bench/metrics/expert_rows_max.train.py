"""The busiest held expert's rows per step (any expert layer) over the
held experts' mean, times 100: 100 when every held expert multiplies as
many rows (the program's row counter, ``expert_rows_max``)."""


def read(m):
    return m.get("expert_rows_max")
