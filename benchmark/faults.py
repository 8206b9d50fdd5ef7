"""Faults planted in the timed path underneath a run, which the check has
to find: ``benchmark/tests/test_bench_faults.py`` runs each cell whole
with each at tiny sizes on the CPU, and ``calibrate.py --fault`` reads them
at a cell's own size on the card. The benchmark's own runs never plant one.

Each model family names its own faults: its ``faults(fault, beam_width)``
(``families/<family>.py``) gives the attributes a fault replaces, and
``planted`` puts them in and takes them out again.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def planted(family, fault: str | None, beam_width: int = 1):
    """The timed path with ``family``'s ``fault`` planted (nothing where None)."""
    plan = family.faults(fault, beam_width) if fault is not None else []
    saved = [(m, n, getattr(m, n)) for m, n, _ in plan]
    for m, n, new in plan:
        setattr(m, n, new)
    try:
        yield
    finally:
        for m, n, old in saved:
            setattr(m, n, old)
