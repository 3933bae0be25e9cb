"""``python -m repro_torch.audit`` — run both audit gates back to back.

Subcommands delegate to the section CLIs:

* ``python -m repro_torch.audit sweep [--quick] [--seed S] [--device D]``
* ``python -m repro_torch.audit leeway [--dims ...] [--baseline FILE] ...``

With no subcommand, the quick sweep and the default leeway
certification both run (extra arguments go to both, e.g.
``--device cpu``) and the exit code is the total violation count
(``scripts/torch_run_audit.py`` wraps the same entry with the checked-in
baseline path).
"""
from __future__ import annotations

import sys

from repro_torch.audit import leeway, sweep


def main(argv=None) -> int:
    """Dispatch to the sweep / leeway CLIs (or run both).

    Args:
      argv: command-line arguments (``None`` = ``sys.argv[1:]``); the
        first token may be ``sweep`` or ``leeway``, the rest is passed
        through to that CLI.

    Returns:
      Process exit code: the total number of violations.
    """
    args = list(sys.argv[1:] if argv is None else argv)
    if args and args[0] == "sweep":
        return sweep.main(args[1:])
    if args and args[0] == "leeway":
        return leeway.main(args[1:])
    return sweep.main(["--quick"] + args) + leeway.main(args)


if __name__ == "__main__":
    raise SystemExit(main())
