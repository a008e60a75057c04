"""Deterministic fault injection for the serving stack.

Mirror of ``src/repro/serve/faults.py`` (which imports nothing from its
package either); :func:`corrupt` works on tensors. The scheduler sites
have no caller in the port until ``serve/scheduler.py`` is ported
(ROADMAP.md, queue 1).

Every recovery path in the scheduler/session/denoise stack is driven by
faults that are *seeded and site-addressable*: a :class:`Fault` names a
site (a fixed probe point in the code), an arrival index at that site,
and a kind. Install a :class:`FaultInjector` with :func:`inject`; probe
points call :func:`fire` and apply whatever comes back. With no injector
installed, ``fire`` returns ``None`` and the probes are no-ops — the
production path pays one global read per site.

Sites (the full set, with the kinds each accepts):

============================  ==========================================
``session.serve``             ``error``, ``resource_exhausted`` — raised
                              at the top of :meth:`ServeSession.serve`.
``scheduler.policy``          ``error`` — raised inside the dispatch
                              policy under the scheduler lock (kills the
                              dispatch thread unless handled).
``scheduler.take``            ``error`` — raised mid-batch-assembly in
                              ``_take_locked`` (the historical silent-
                              hang site).
``scheduler.dispatch``        ``error``, ``stall`` — fires in the
                              dispatch loop after the batch is taken;
                              ``stall`` sleeps ``value`` seconds.
``denoise.step``              ``poison_nan``, ``poison_inf``, ``drift``
                              — data corruption instead of raising:
                              poison kinds hit the step OUTPUT (the int8
                              path launders input NaNs through
                              quantization), ``drift`` scales the step
                              INPUT so the temporal Δs really saturate.
============================  ==========================================

Faults are one-shot: each (site, arrival-index) pair fires at most once,
and the injector records what fired in ``.fired`` so tests and the chaos
smoke can assert the schedule actually executed.
"""

from __future__ import annotations

import random
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field


class InjectedFault(RuntimeError):
    """An injected runner/scheduler failure (deterministic, seeded)."""

    def __init__(self, fault: "Fault"):
        super().__init__(
            f"injected fault: {fault.kind} at {fault.site}[{fault.at}]"
        )
        self.fault = fault


class ResourceExhausted(InjectedFault):
    """Simulated allocator/backend RESOURCE_EXHAUSTED failure."""


class NumericalFault(RuntimeError):
    """Non-finite denoise output that survived the watchdog's re-anchor."""

    def __init__(self, step: int):
        super().__init__(f"non-finite denoise output at step {step}")
        self.step = step


# site -> kinds it accepts. Keep in sync with the probe points listed in
# the module docstring; tests iterate this mapping.
SITE_KINDS = {
    "session.serve": ("error", "resource_exhausted"),
    "scheduler.policy": ("error",),
    "scheduler.take": ("error",),
    "scheduler.dispatch": ("error", "stall"),
    "denoise.step": ("poison_nan", "poison_inf", "drift"),
}
SITES = tuple(SITE_KINDS)

_NEEDS_VALUE = ("stall", "drift")


@dataclass(frozen=True)
class Fault:
    """One scheduled failure: fire `kind` at the `at`-th arrival at `site`.

    `value` is the stall duration in seconds for ``stall`` and the
    multiplicative blow-up factor for ``drift``; ignored otherwise.
    """

    site: str
    at: int
    kind: str
    value: float = 0.0

    def __post_init__(self):
        if self.site not in SITE_KINDS:
            raise ValueError(f"unknown fault site {self.site!r} (one of {SITES})")
        if self.kind not in SITE_KINDS[self.site]:
            raise ValueError(
                f"site {self.site!r} does not support kind {self.kind!r} "
                f"(supports {SITE_KINDS[self.site]})"
            )
        if self.at < 0:
            raise ValueError(f"fault arrival index must be >= 0, got {self.at}")
        if self.kind in _NEEDS_VALUE and not self.value > 0:
            raise ValueError(f"{self.kind!r} fault needs a positive value")


@dataclass
class FaultInjector:
    """Deterministic schedule of faults, consumed by arrival order per site."""

    faults: tuple = ()
    fired: list = field(default_factory=list)

    def __post_init__(self):
        self.faults = tuple(self.faults)
        by_site: dict = {s: {} for s in SITES}
        for f in self.faults:
            if not isinstance(f, Fault):
                raise TypeError(f"expected Fault, got {type(f).__name__}")
            if f.at in by_site[f.site]:
                raise ValueError(f"duplicate fault at {f.site}[{f.at}]")
            by_site[f.site][f.at] = f
        self._by_site = by_site
        self._arrivals = {s: 0 for s in SITES}
        self._lock = threading.Lock()

    def check(self, site: str):
        """Record an arrival at `site`; return the Fault due now, if any."""
        with self._lock:
            n = self._arrivals[site]
            self._arrivals[site] = n + 1
            fault = self._by_site[site].get(n)
            if fault is not None:
                self.fired.append(fault)
            return fault

    def arrivals(self, site: str) -> int:
        with self._lock:
            return self._arrivals[site]


_install_lock = threading.Lock()
_installed: FaultInjector | None = None


@contextmanager
def inject(injector: FaultInjector):
    """Install `injector` process-wide for the duration of the block."""
    global _installed
    with _install_lock:
        if _installed is not None:
            raise RuntimeError("a FaultInjector is already installed")
        _installed = injector
    try:
        yield injector
    finally:
        with _install_lock:
            _installed = None


def fire(site: str):
    """Probe point: returns the Fault due at `site` now, or None."""
    inj = _installed
    if inj is None:
        return None
    return inj.check(site)


def perform(fault: Fault) -> None:
    """Execute a control-flow fault (raise or stall). Not for poison kinds."""
    if fault.kind == "error":
        raise InjectedFault(fault)
    if fault.kind == "resource_exhausted":
        raise ResourceExhausted(fault)
    if fault.kind == "stall":
        time.sleep(fault.value)
        return
    raise ValueError(f"perform() cannot execute fault kind {fault.kind!r}")


def corrupt(fault: Fault, x):
    """Apply a data-corruption fault to tensor `x`, returning the poisoned copy."""
    if fault.kind in ("poison_nan", "poison_inf"):
        out = x.clone()
        out[(0,) * x.dim()] = float("nan") if fault.kind == "poison_nan" else float("inf")
        return out
    if fault.kind == "drift":
        return x * fault.value
    raise ValueError(f"corrupt() cannot apply fault kind {fault.kind!r}")


def chaos_schedule(
    seed: int,
    n_faults: int = 3,
    *,
    sites: tuple = SITES,
    max_at: int = 8,
) -> FaultInjector:
    """Seeded random fault schedule over `sites` (deduped by (site, at))."""
    rng = random.Random(seed)
    chosen: dict = {}
    for _ in range(n_faults * 8):
        if len(chosen) >= n_faults:
            break
        site = rng.choice(list(sites))
        at = rng.randrange(max_at)
        if (site, at) in chosen:
            continue
        kind = rng.choice(list(SITE_KINDS[site]))
        value = 0.0
        if kind == "stall":
            value = 0.05
        elif kind == "drift":
            value = 64.0
        chosen[(site, at)] = Fault(site=site, at=at, kind=kind, value=value)
    return FaultInjector(faults=tuple(chosen.values()))
