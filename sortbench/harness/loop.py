"""Seeds, the traffic order, the closed request loop and the sample of
answers that is judged once the window has closed."""

from __future__ import annotations

import dataclasses
import time
import traceback
from typing import Any, Callable, Iterator

import numpy as np
import torch

# streams of one seed: each use draws from its own generator
STREAM_ORDER, STREAM_SAMPLE = 1, 2


def host_rng(seed: int, stream: int) -> np.random.Generator:
    """The host generator of one stream of ``seed`` (any whole number)."""
    return np.random.default_rng([seed % (1 << 64), stream])


def device_gen(seed: int, stream: int, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from ``(seed, stream)``."""
    return torch.Generator(device=device).manual_seed(
        int(host_rng(seed, stream).integers(1 << 62)))


def traffic_order(traffic: dict, seed: int) -> Iterator[str]:
    """The mix's request kinds without end: blocks that hold each kind as
    often as its share says, each block in an order drawn from ``seed``.
    Every seed gets the same kinds in the same proportion."""
    block = [k for k, share in traffic["kinds"].items()
             for _ in range(int(share))]
    rng = host_rng(seed, STREAM_ORDER)
    while True:
        for i in rng.permutation(len(block)):
            yield block[i]


@dataclasses.dataclass
class Outcome:
    """What one request gave, once its result is materialised as the
    client gets it: what is kept for the judge, and the work done (keys
    sorted)."""

    judged: Any
    work: int


@dataclasses.dataclass
class Request:
    kind: str
    t0: float
    t1: float
    ok: bool
    work: int


def copy_into(held, new):
    """``new`` written into ``held``'s tensors where the two have one
    structure, shape and type (a device copy, no allocation); ``new``
    itself where they do not."""
    if isinstance(held, torch.Tensor) and isinstance(new, torch.Tensor) \
            and held.shape == new.shape and held.dtype == new.dtype:
        return held.copy_(new)
    if isinstance(held, (tuple, list)) and type(held) is type(new) \
            and len(held) == len(new):
        return type(new)(copy_into(h, n) for h, n in zip(held, new))
    if isinstance(held, dict) and isinstance(new, dict) \
            and held.keys() == new.keys():
        return {k: copy_into(held[k], new[k]) for k in new}
    return new


class Sample:
    """One answer a request kind, judged once the window has closed.

    Before the window a moment is drawn from the seed for each kind, a
    share of the window's seconds; the answer judged is the kind's first
    that completes at or after that moment, or its first in the window
    where none does.  The kind's first answer is held from the start and
    the one taken at the moment is copied into its tensors, once, so the
    device's allocations follow one pattern whatever the seed draws.
    (Held by reference instead, the answer kept moved to another block
    at a moment the seed set: the runs of one seed agreed, and six seeds
    spread by 1.2 % in the sort's rate.)"""

    def __init__(self, seed: int, kinds, seconds: float):
        rng = host_rng(seed, STREAM_SAMPLE)
        self.at = {k: float(rng.random()) * seconds for k in kinds}
        self.kept: dict = {}
        self.taken: set = set()

    def offer(self, kind: str, judged, t: float) -> None:
        """The answer of a ``kind`` request completed ``t`` seconds into
        the window."""
        if kind not in self.kept:
            self.kept[kind] = judged
        elif kind in self.taken or t < self.at[kind]:
            return
        else:
            self.kept[kind] = copy_into(self.kept[kind], judged)
        if t >= self.at[kind]:
            self.taken.add(kind)

    def drain(self):
        """The kept answers as (kind, answer) pairs, each let go of as the
        next is taken."""
        while self.kept:
            yield self.kept.popitem()


@dataclasses.dataclass
class Window:
    requests: list
    t0: float
    t1: float
    errors: list

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    @property
    def done(self) -> list:
        return [r for r in self.requests if r.ok]

    @property
    def failed(self) -> int:
        return sum(not r.ok for r in self.requests)


def request(mod, state, j: int) -> Outcome:
    """Request ``j`` of a kind: the port's call (``mod.call``), then the
    client's handling of its result (``mod.deliver``)."""
    return mod.deliver(state, j, mod.call(state, j))


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def closed_loop(order: Iterator[str], kinds: dict, states: dict,
                counters: dict, seconds: float, device,
                sample: Sample | None = None,
                label: Callable[[str], Any] | None = None,
                min_requests: int = 1) -> Window:
    """One client: the next request is issued when the previous one has
    returned, until ``seconds`` have passed since the first was issued
    and at least ``min_requests`` were issued.  A request is timed from
    its issue until its result is ready (it ends in a device
    synchronisation); one that raises counts as failed."""
    requests, errors = [], []
    t_start = time.perf_counter()
    t_end = t_start
    while t_end - t_start < seconds or len(requests) < min_requests:
        kind = next(order)
        j = counters[kind]
        counters[kind] = j + 1
        t0 = time.perf_counter()
        try:
            if label is None:
                out = request(kinds[kind], states[kind], j)
                synchronize(device)
            else:
                with label(kind):
                    out = request(kinds[kind], states[kind], j)
                    synchronize(device)
        except Exception:  # a failed request: recorded, the loop goes on
            t_end = time.perf_counter()
            requests.append(Request(kind, t0, t_end, False, 0))
            errors.append(f"{kind} #{j}: {traceback.format_exc(limit=4)}")
            continue
        t_end = time.perf_counter()
        requests.append(Request(kind, t0, t_end, True, out.work))
        if sample is not None:
            sample.offer(kind, out.judged, t_end - t_start)
        del out
    return Window(requests, t_start, t_end, errors)
