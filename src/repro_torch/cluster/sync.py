"""Pluggable synchronization semantics (paper §2.4) — the port of the
reference's ``cluster/sync.py``, pure Python and unchanged.

BSP / ASP / SSP collapse to one rule — a worker that has finished ``done``
iterations may start another only while ``done - min_active <= bound`` —
so every policy is a small frozen object exposing that bound and the event
loop makes exactly one polymorphic call per pop.  There is no
``if sync == ...`` ladder in the hot loop; new semantics (e.g. grouped or
adaptive staleness) are new ``SyncPolicy`` subclasses, not new branches.
"""
from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class SyncPolicy:
    """Base policy: permits a worker iteration based on the staleness gap."""
    name = "sync"

    def bound(self) -> float:
        raise NotImplementedError

    def allows(self, done_iters: int, min_active_iters: int) -> bool:
        """May a worker with ``done_iters`` completed iterations run its next
        one, given the slowest *active* worker is at ``min_active_iters``?"""
        return done_iters - min_active_iters <= self.bound()


@dataclass(frozen=True)
class BSP(SyncPolicy):
    """Bulk-synchronous: nobody runs ahead (staleness bound 0)."""
    name = "bsp"

    def bound(self) -> float:
        return 0


@dataclass(frozen=True)
class ASP(SyncPolicy):
    """Fully asynchronous: the gap is unbounded."""
    name = "asp"

    def bound(self) -> float:
        return math.inf


@dataclass(frozen=True)
class SSP(SyncPolicy):
    """Stale-synchronous with slack ``staleness``: bsp == ssp(0),
    asp == ssp(inf) (paper §2.4)."""
    staleness: int = 3
    name = "ssp"

    def bound(self) -> float:
        return self.staleness


def as_policy(sync, staleness: int = 3) -> SyncPolicy:
    """Coerce the legacy string spelling ("bsp"/"asp"/"ssp") to a policy;
    policies pass through unchanged."""
    if isinstance(sync, SyncPolicy):
        return sync
    table = {"bsp": BSP(), "asp": ASP(), "ssp": SSP(staleness)}
    try:
        return table[sync]
    except KeyError:
        raise ValueError(f"unknown sync policy {sync!r} "
                         f"(expected SyncPolicy or one of {sorted(table)})")
