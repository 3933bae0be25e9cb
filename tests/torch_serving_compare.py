"""Comparisons the serving parity tests hold the port's token streams to.

Greedy decoding turns a last-bit difference between two packages into a
different token wherever the aggregated logits' two largest entries are
closer than that difference.  So a port stream is compared with the
reference's position by position, and the first divergence of a stream
is let off only right after a position where the reference's own top-2
gap was within the tolerance (1e-4 of the row's largest entry); after
it the two streams decode different contexts and are not compared.  A
:class:`GapRecorder` on the reference's engine records that gap for
every token it emits; :func:`assert_streams_match` counts the let-off
positions so a test can assert they are rare.
"""
import contextlib

import numpy as np

TOL = 1e-4


def top2_gap(row) -> tuple:
    """``(gap between the two largest entries, largest |entry|)`` of a
    logits row."""
    row = np.asarray(row, dtype=np.float64).ravel()
    top = np.sort(row)[-2:]
    return float(top[1] - top[0]), float(np.max(np.abs(row)))


class GapRecorder:
    """Wraps a reference ``ServingEngine`` (per-token plain or ensemble
    mode) to record, per request id, the top-2 gap and scale of the
    logits row each emitted token was the argmax of."""

    def __init__(self, eng):
        import repro.serving.engine as jengine
        self.gaps = {}
        self._eng = eng
        self._jengine = jengine
        self._pending = None
        decode = eng._decode

        def recorded_decode(*args):
            out = decode(*args)
            rows = out[0][:, 0] if eng.ensemble is None else out[0]
            rows = np.asarray(rows)
            for i, req in enumerate(eng.active):
                if req is not None:
                    self.gaps.setdefault(req.rid, []).append(
                        top2_gap(rows[i]))
            return out

        eng._decode = recorded_decode
        if eng.ensemble is not None:
            prefill_step = eng._ens_prefill

            def recorded_prefill(*args):
                out = prefill_step(*args)
                self._pending = top2_gap(np.asarray(out[0])[0])
                return out

            eng._ens_prefill = recorded_prefill
        admit = eng.admit

        def recorded_admit(req):
            ok = admit(req)
            if ok:
                self.gaps[req.rid] = [self._pending]
            return ok

        eng.admit = recorded_admit

    @contextlib.contextmanager
    def plain_prefill(self):
        """Patch the reference engine module's ``prefill`` while a plain
        engine runs, so admissions record their first token's gap."""
        orig = self._jengine.prefill

        def recorded(*args, **kw):
            out = orig(*args, **kw)
            self._pending = top2_gap(np.asarray(out[0])[0, -1])
            return out

        self._jengine.prefill = recorded
        try:
            yield self
        finally:
            self._jengine.prefill = orig


def assert_streams_match(want: dict, got: dict, gaps, tol: float = TOL,
                         log=None) -> int:
    """Hold the port's streams ``got`` to the reference's ``want``.

    Args:
      want: ``{rid: tokens}`` of the reference.
      got: ``{rid: tokens}`` of the port.
      gaps: :attr:`GapRecorder.gaps` of the reference's run, or a tuple of
        several runs' gaps (``{rid: [(gap, scale), ...]}`` each): a
        divergence is then let off after a near-tie in any of them.
      tol: the tie tolerance, relative to the row's largest entry.
      log: called with a line for each divergence let off (``None``:
        silent).

    Returns:
      The number of streams that diverged after a near-tie (the rest of
      such a stream is not compared).  Raises ``AssertionError`` on a
      divergence after a clear argmax or on a length mismatch.
    """
    assert set(want) == set(got)
    if isinstance(gaps, dict):
        gaps = (gaps,)
    let_off = 0
    for rid in want:
        w, g = list(want[rid]), list(got[rid])
        assert len(w) == len(g), (rid, w, g)
        for j, (a, b) in enumerate(zip(w, g)):
            if a == b:
                continue
            ties = [run[rid][j] for run in gaps if len(run.get(rid, ())) > j]
            assert any(gap <= tol * scale for gap, scale in ties), (
                f"request {rid} token {j}: {b} vs {a} after a clear argmax "
                f"(top-2 gap, largest |entry|: {ties})")
            if log is not None:
                log(f"request {rid} parts at token {j} ({b} vs {a}) on a "
                    f"near-tie of the two largest logits, (gap, largest "
                    f"|entry|) {ties}")
            let_off += 1
            break
    return let_off
