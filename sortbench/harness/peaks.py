"""Published peaks of the card, and the least bytes a call needs.

NVIDIA H100 SXM data sheet: 3.35 TB/s of HBM3 (80 GB), at the full
power limit of 700 W.  The byte arithmetic is the ``bound_ms`` of the
repository's ``chip_smoke.py`` for a sort (each input key read once,
each output element written once), frozen here."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12


def sort_min_bytes(n: int) -> int:
    """The least DRAM traffic of a sort of ``n`` 4-byte keys (the port's
    keys are int32 or uint32 at every p): every key read once and every
    output element (a key, or an int32 permutation entry) written once."""
    return 4 * n + 4 * n


def bound_s(nbytes: int) -> float:
    """The least time in which the card moves ``nbytes``."""
    return nbytes / HBM_BYTES_PER_S
