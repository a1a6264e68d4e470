"""Straggler mitigation and fault-tolerance policy (a copy of
``repro.runtime.straggler``, host-only logic the port may not import).

Per-host heartbeats with an EWMA of step latencies; a host is a straggler
when its latency stays above ``threshold`` x the fleet median for
``patience`` consecutive checks; the mitigation ladder moves a
straggler's data shard to a backup host (``data.pipeline.SyntheticLM``'s
batches are a pure function of (seed, step, host), so any host can compute
them), then evicts a host that misses heartbeats, after which the job
restarts on the survivors from the last checkpoint
(``checkpoint.manager``). ``runtime.train.train_loop`` records every
step's latency here.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

__all__ = ["HostState", "StragglerPolicy"]


@dataclasses.dataclass
class HostState:
    ewma_s: float = 0.0
    slow_streak: int = 0
    last_seen: float = 0.0
    evicted: bool = False


class StragglerPolicy:
    def __init__(self, n_hosts: int, threshold: float = 1.5, patience: int = 3,
                 heartbeat_timeout_s: float = 60.0, alpha: float = 0.3):
        self.hosts: Dict[int, HostState] = {i: HostState() for i in range(n_hosts)}
        self.threshold = threshold
        self.patience = patience
        self.timeout = heartbeat_timeout_s
        self.alpha = alpha

    # -- telemetry ----------------------------------------------------------
    def record(self, host: int, step_latency_s: float, now: Optional[float] = None):
        st = self.hosts[host]
        st.ewma_s = (
            step_latency_s if st.ewma_s == 0.0
            else self.alpha * step_latency_s + (1 - self.alpha) * st.ewma_s
        )
        st.last_seen = time.time() if now is None else now

    def _median_ewma(self) -> float:
        vals = sorted(s.ewma_s for s in self.hosts.values() if not s.evicted and s.ewma_s > 0)
        return vals[len(vals) // 2] if vals else 0.0

    # -- decisions ----------------------------------------------------------
    def stragglers(self) -> List[int]:
        med = self._median_ewma()
        out = []
        if med <= 0:
            return out
        for i, st in self.hosts.items():
            if st.evicted:
                continue
            if st.ewma_s > self.threshold * med:
                st.slow_streak += 1
            else:
                st.slow_streak = 0
            if st.slow_streak >= self.patience:
                out.append(i)
        return out

    def dead_hosts(self, now: Optional[float] = None) -> List[int]:
        now = time.time() if now is None else now
        return [
            i for i, st in self.hosts.items()
            if not st.evicted and st.last_seen and now - st.last_seen > self.timeout
        ]

    def reassign_shard(self, straggler: int) -> int:
        """Backup host for a straggler's data shard: the next live host.
        (The stateless pipeline lets the backup compute batch(step, straggler)
        directly — no data transfer.)"""
        live = [i for i, s in self.hosts.items() if not s.evicted and i != straggler]
        assert live, "no live hosts left"
        return live[straggler % len(live)]

    def evict(self, host: int):
        self.hosts[host].evicted = True

    def live_count(self) -> int:
        return sum(not s.evicted for s in self.hosts.values())
