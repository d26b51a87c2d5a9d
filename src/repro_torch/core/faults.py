"""Deterministic fault injection + the typed store-error hierarchy.

The out-of-core sort spills through real I/O (disk ``.npy`` fragments,
mesh collectives), and real I/O fails: a torn write, a transient
``EIO``, a device that drops out mid-collective.  This module is the
*contract* for those failures across the stream subsystem:

* a **typed error hierarchy** every :class:`~repro_torch.stream.chunks.
  PlacementStore` boundary raises through — :class:`TransientStoreError`
  (retryable: the same call may succeed immediately), :class:`
  CorruptFragmentError` (the bytes came back wrong — detected, never
  silently consumed), :class:`StorePermanentError` (retrying is futile;
  callers degrade — the device store fails over to disk);
* a **deterministic, seeded fault-injection registry**: tests install a
  :class:`FaultPlan` (which *site* fails, on which hit, with which
  *kind*) and every store I/O boundary polls it (:func:`poll`), so the
  chaos suite can drive every failure path on purpose — same plan, same
  failure, every run.  ``REPRO_FAULTS`` carries a plan into
  subprocesses;
* a **bounded retry/backoff helper** (:func:`with_retries`):
  transient failures — injected or classified from real ``OSError``\\ s —
  retry up to ``REPRO_STORE_RETRIES`` times with exponential backoff
  (sleeps are skipped while an injection plan is active: chaos runs must
  not wait on wall clock), then surface as the typed error.

Sites register at import (:func:`register_site`) so the chaos matrix can
parametrize over :func:`registered_sites` and never silently miss a new
I/O boundary.
"""

from __future__ import annotations

import dataclasses
import errno
import os
import threading
import time
import zlib
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.obs import metrics, trace

__all__ = [
    "CorruptFragmentError",
    "FaultPlan",
    "FaultSpec",
    "StoreError",
    "StorePermanentError",
    "TransientStoreError",
    "active_plan",
    "classify_oserror",
    "env_plan",
    "inject",
    "poll",
    "register_site",
    "registered_sites",
    "store_retries",
    "with_retries",
]

KINDS = ("transient", "corrupt", "permanent")

#: env var carrying a fault plan spec into subprocesses (see
#: :meth:`FaultPlan.parse`); read once at first poll.
FAULTS_ENV = "REPRO_FAULTS"

#: env var bounding transient retries (attempts = retries + 1).
RETRIES_ENV = "REPRO_STORE_RETRIES"
DEFAULT_RETRIES = 2

#: first backoff sleep; doubles per retry, capped at _BACKOFF_CAP_S.
#: Never slept while an injection plan is active.
_BACKOFF_BASE_S = 0.01
_BACKOFF_CAP_S = 0.5


# --------------------------------------------------------------------------
# typed errors
# --------------------------------------------------------------------------


class StoreError(RuntimeError):
    """Base of every typed placement-store failure."""

    def __init__(self, site: str, detail: str = ""):
        self.site = site
        super().__init__(f"[{site}] {detail}" if detail else site)


class TransientStoreError(StoreError):
    """A failure the same call may immediately recover from (EIO-class
    hiccup, injected transient).  Retried by :func:`with_retries`; only
    surfaces when the retry budget is exhausted."""


class CorruptFragmentError(StoreError):
    """Stored bytes failed verification (CRC mismatch, unparseable
    fragment).  Never retried — the data on the medium is wrong — and
    never silently consumed: detection at load is the whole point."""


class StorePermanentError(StoreError):
    """Retrying is futile (medium gone, collective dead).  Callers
    degrade: the external sort fails a device store's remaining
    partitions over to disk."""


#: real-OSError errnos worth retrying; everything else is permanent.
_TRANSIENT_ERRNOS = frozenset(
    getattr(errno, name) for name in
    ("EINTR", "EAGAIN", "EBUSY", "EIO", "ETIMEDOUT") if hasattr(errno, name))


def classify_oserror(e: OSError) -> str:
    """``"transient"`` (worth retrying) or ``"permanent"``."""
    return "transient" if e.errno in _TRANSIENT_ERRNOS else "permanent"


# --------------------------------------------------------------------------
# fault plans
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One injected failure: ``site`` fails with ``kind`` on its
    ``nth`` hit (1-based), for ``times`` consecutive hits.  A
    ``permanent`` fault ignores ``times`` — once dead, always dead
    (that is what permanent means)."""

    site: str
    kind: str
    nth: int = 1
    times: int = 1

    def __post_init__(self):
        assert self.kind in KINDS, f"unknown fault kind {self.kind!r}"
        assert self.nth >= 1 and self.times >= 1

    def fires(self, hit: int) -> bool:
        if self.kind == "permanent":
            return hit >= self.nth
        return self.nth <= hit < self.nth + self.times


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A set of :class:`FaultSpec`\\ s, installed via :func:`inject` (or
    the ``REPRO_FAULTS`` env for subprocesses)."""

    specs: Tuple[FaultSpec, ...]

    @classmethod
    def single(cls, site: str, kind: str, seed: int = 0,
               window: int = 4) -> "FaultPlan":
        """One fault at ``site``, firing on a *seed-determined* hit in
        ``[1, window]`` — the chaos matrix's way of moving the failure
        around deterministically without enumerating call counts."""
        h = zlib.crc32(f"{site}|{kind}|{seed}".encode())
        return cls((FaultSpec(site, kind, nth=1 + h % max(window, 1)),))

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        """Parse ``"site:kind[:nth[:times]]"`` specs, comma-separated —
        the ``REPRO_FAULTS`` wire format (e.g.
        ``"run_store.put:transient:2,run_store.get:corrupt"``)."""
        specs = []
        for item in spec.split(","):
            item = item.strip()
            if not item:
                continue
            parts = item.split(":")
            assert 2 <= len(parts) <= 4, f"bad fault spec {item!r}"
            site, kind = parts[0], parts[1]
            nth = int(parts[2]) if len(parts) > 2 else 1
            times = int(parts[3]) if len(parts) > 3 else 1
            specs.append(FaultSpec(site, kind, nth=nth, times=times))
        return cls(tuple(specs))

    def spec_for(self, site: str) -> Optional[FaultSpec]:
        for s in self.specs:
            if s.site == site:
                return s
        return None


def env_plan() -> Optional[FaultPlan]:
    """The plan ``REPRO_FAULTS`` carries, or None."""
    spec = os.environ.get(FAULTS_ENV, "").strip()
    return FaultPlan.parse(spec) if spec else None


# --------------------------------------------------------------------------
# the registry
# --------------------------------------------------------------------------

_SITES: List[str] = []


def register_site(name: str) -> str:
    """Declare an injection site (module import time).  Returns the name
    so call sites can bind it to a constant."""
    if name not in _SITES:
        _SITES.append(name)
    return name


def registered_sites() -> Tuple[str, ...]:
    """Every declared site — the chaos matrix parametrizes over this, so
    a new I/O boundary is chaos-tested the moment it registers."""
    return tuple(_SITES)


class _Injector:
    """An installed plan plus its hit counters and fired log."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.hits: Dict[str, int] = {}
        #: (site, kind, hit) per fired fault — tests assert the fault
        #: actually happened (a chaos run that never fired proves nothing)
        self.fired: List[Tuple[str, str, int]] = []
        self._lock = threading.Lock()

    def poll(self, site: str) -> Optional[str]:
        with self._lock:
            hit = self.hits.get(site, 0) + 1
            self.hits[site] = hit
            spec = self.plan.spec_for(site)
            if spec is not None and spec.fires(hit):
                self.fired.append((site, spec.kind, hit))
                return spec.kind
        return None


_active: Optional[_Injector] = None
_env_checked = False


class inject:
    """Context manager installing a :class:`FaultPlan`; yields the
    injector so tests can assert on ``.fired``.  Nesting is a test bug
    and asserts."""

    def __init__(self, plan: FaultPlan):
        self._plan = plan

    def __enter__(self) -> _Injector:
        global _active
        assert _active is None, "fault plans do not nest"
        _active = _Injector(self._plan)
        return _active

    def __exit__(self, *exc) -> None:
        global _active
        _active = None


def active_plan() -> Optional[_Injector]:
    """The installed injector (env plan auto-installed on first ask)."""
    global _active, _env_checked
    if _active is None and not _env_checked:
        _env_checked = True
        plan = env_plan()
        if plan is not None:
            _active = _Injector(plan)
    return _active


def poll(site: str) -> Optional[str]:
    """One hit at ``site``.  Raising kinds raise here (``transient`` →
    :class:`TransientStoreError`, ``permanent`` →
    :class:`StorePermanentError`); ``"corrupt"`` is *returned* for the
    caller to apply to its own bytes (corruption is data damage, not an
    exception — the store's verification must catch it)."""
    inj = active_plan()
    if inj is None:
        return None
    kind = inj.poll(site)
    if kind is not None:
        # a fired fault marks whatever span is active when it hits, so
        # traces show *where in the pipeline* each injection landed
        active = trace.current()
        if active is not None:
            active.annotate("faults", f"{site}:{kind}")
    if kind == "transient":
        raise TransientStoreError(site, "injected transient fault")
    if kind == "permanent":
        raise StorePermanentError(site, "injected permanent fault")
    return kind


# --------------------------------------------------------------------------
# retry / backoff
# --------------------------------------------------------------------------


def store_retries() -> int:
    """Transient retry budget (``REPRO_STORE_RETRIES``, default 2).
    Read per call so tests flip it without re-importing."""
    try:
        return max(0, int(os.environ.get(RETRIES_ENV, str(DEFAULT_RETRIES))))
    except ValueError:
        return DEFAULT_RETRIES


def with_retries(site: str, attempt: Callable[[], object],
                 on_retry: Optional[Callable[[], None]] = None):
    """Run ``attempt`` with the transient-retry contract.

    :class:`TransientStoreError` (injected or raised by the store) and
    transient-classified ``OSError``\\ s retry up to
    ``REPRO_STORE_RETRIES`` times with bounded exponential backoff —
    skipped entirely while an injection plan is active, so chaos runs
    never sleep.  Exhausted transients surface as
    :class:`TransientStoreError`; permanent-classified ``OSError``\\ s
    surface immediately as :class:`StorePermanentError`;
    :class:`CorruptFragmentError` and :class:`StorePermanentError` pass
    straight through (retrying cannot help either).  ``on_retry`` is the
    caller's event counter hook, invoked once per retried failure.

    Every retried failure also emits a structured ``store.retry`` event
    (site, attempt index, backoff, exception class) through the
    :mod:`repro_torch.obs.metrics` registry, so chaos tests assert retry
    *counts* — not just final outcomes.
    """
    retries = store_retries()
    delay = _BACKOFF_BASE_S
    for i in range(retries + 1):
        err: BaseException
        try:
            return attempt()
        except (CorruptFragmentError, StorePermanentError):
            raise
        except TransientStoreError as e:
            if i == retries:
                raise
            err = e
        except OSError as e:
            if classify_oserror(e) == "permanent":
                raise StorePermanentError(site, str(e)) from e
            if i == retries:
                raise TransientStoreError(site, str(e)) from e
            err = e
        backoff_s = delay if active_plan() is None else 0.0
        metrics.event("store.retry", site=site, attempt=i,
                      backoff_s=backoff_s, error=type(err).__name__)
        if on_retry is not None:
            on_retry()
        if active_plan() is None:  # injected chaos must not wait on clock
            time.sleep(delay)
            delay = min(delay * 2, _BACKOFF_CAP_S)
    raise AssertionError("unreachable")
