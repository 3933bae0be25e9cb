"""The card's published peaks and the least time of each aggregation
kernel, frozen here so that a change to the program cannot move the
yardstick.

The kernel formulas are those of ``chip_smoke.py::bound`` with one
correction: K5 (K1, the selection and K4 on one stack) counts the stack
once, since a roofline charges each input byte one read whatever the
kernel reads again.
"""
from __future__ import annotations

#: published H100 SXM peaks (NVIDIA data sheet, dense rates), at the
#: full 700 W power limit
PEAK_BYTES_PER_S = 3.35e12
#: float32 outside the tensor cores: the port runs float32 with TF32 off
PEAK_FP32_PER_S = 67e12


def least_s(nbytes: float, ops: float) -> float:
    """The larger of the bytes over the memory rate and the operations
    over the fp32 peak, in seconds."""
    return max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_FP32_PER_S)


def _select_ops(n: int, f: int) -> int:
    theta = n - 2 * f
    return n * (n - 1) * (n - 2) + sum(
        n * max(1, n - t - f - 2) for t in range(theta))


def kernel_work(kernel: str, n: int, d: int, f: int, elem: int = 4):
    """``(bytes, operations)`` one call of an aggregation kernel needs
    on an ``(n, d)`` stack of ``elem``-byte entries, Bulyan-Krum mode.

    Bytes: each input read once, each output written once.  Operations:
    the Gram's symmetric half and diagonal, ``n (n + 1) d`` (a
    multiply-add counts 2); the selection's sort of each column's
    off-diagonal entries and its neighbour sums in each of its theta
    rounds; per coordinate the sort of theta values (``theta (theta -
    1)``, a compare-exchange is a min and a max) and the window's
    ``4 theta`` adds.

    Args:
      kernel: ``"k1"`` (``gram_kernel``), ``"select"``, ``"k4"``
        (``combine_bulyan_kernel``) or ``"k5"`` (the three on one
        stack).
      n: rows (workers or replicas).
      d: columns.
      f: Byzantine bound.
      elem: bytes per stack entry.

    Returns:
      ``(bytes, operations)``.
    """
    theta = n - 2 * f
    stack = n * d * elem
    gram_ops = n * (n + 1) * d
    window_ops = d * (theta * (theta - 1) + 4 * theta)
    if kernel == "k1":
        return stack + n * n * 4, gram_ops
    if kernel == "select":
        return n * n * 4 + (theta * n + 2 * n) * 4, _select_ops(n, f)
    if kernel == "k4":
        return stack + theta * n * 4 + d * 4, window_ops
    if kernel == "k5":
        return (stack + d * 4 + 2 * n * 4,
                gram_ops + _select_ops(n, f) + window_ops)
    raise KeyError(kernel)


def kernel_least_s(kernel: str, n: int, d: int, f: int,
                   elem: int = 4) -> float:
    """:func:`least_s` of :func:`kernel_work`."""
    return least_s(*kernel_work(kernel, n, d, f, elem))
