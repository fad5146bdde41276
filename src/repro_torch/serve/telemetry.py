"""Streaming serving telemetry: bounded-memory percentiles and counters.

A copy of the JAX package's ``serve/telemetry.py`` (pure numpy), kept here so
the port imports nothing of that package; the draws, the state and the
summaries are the same, bit for bit.

A continuous-batching engine cannot keep every observation — at
millions-of-requests/day scale the join-latency trace alone would dwarf the
solver state — but its SLO story is told in tails, not means. So every
metric streams through a :class:`StreamingStat`: an exact running mean and
variance (Welford) plus a fixed-capacity uniform reservoir (Vitter's
algorithm R) that quantile queries read from. The reservoir is an unbiased
uniform sample of the full stream, so its empirical quantiles are
consistent estimates of the stream's — the same contract a t-digest gives,
with a simpler (and exactly serializable) state.

Telemetry is part of the engine's kill/restore tick-parity surface: the
reservoir VALUES and the sampler's rng state both ride ``state_dict``, so a
restored engine's percentiles — and its subsequent sampling decisions — are
bitwise identical to the replica that died.
"""
from __future__ import annotations

import numpy as np

__all__ = ["StreamingStat", "ServeTelemetry"]


class StreamingStat:
    """Reservoir-sampled quantiles + exact Welford mean/variance."""

    def __init__(self, capacity: int = 1024, seed: int = 0):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.seed = int(seed)
        self._rng = np.random.default_rng(self.seed)
        self._res: list = []
        self._n = 0
        self._mean = 0.0
        self._m2 = 0.0
        self._max = -np.inf
        self._min = np.inf

    def add(self, x: float) -> None:
        x = float(x)
        self._n += 1
        d = x - self._mean
        self._mean += d / self._n
        self._m2 += d * (x - self._mean)
        self._max = max(self._max, x)
        self._min = min(self._min, x)
        if len(self._res) < self.capacity:
            self._res.append(x)
        else:
            # algorithm R: element n replaces a reservoir slot w.p. cap/n
            j = int(self._rng.integers(0, self._n))
            if j < self.capacity:
                self._res[j] = x

    @property
    def count(self) -> int:
        return self._n

    def mean(self) -> float:
        return float(self._mean) if self._n else 0.0

    def var(self) -> float:
        return float(self._m2 / self._n) if self._n else 0.0

    def max(self) -> float:
        return float(self._max) if self._n else 0.0

    def min(self) -> float:
        return float(self._min) if self._n else 0.0

    def quantile(self, q: float) -> float:
        if not self._res:
            return 0.0
        return float(np.quantile(np.asarray(self._res, np.float64), q))

    def summary(self) -> dict:
        return {
            "count": self._n,
            "mean": self.mean(),
            "var": self.var(),
            "min": self.min(),
            "max": self.max(),
            "p50": self.quantile(0.50),
            "p90": self.quantile(0.90),
            "p99": self.quantile(0.99),
        }

    def merge(self, other: "StreamingStat") -> "StreamingStat":
        """Fold another stat into this one (for sharded-replica rollups).

        The moment fields combine exactly — weighted (parallel) Welford:
        with ``n = n1 + n2`` and ``d = mean2 - mean1``,

            mean = mean1 + d * n2 / n
            m2   = m2_1 + m2_2 + d^2 * n1 * n2 / n

        so merged mean/var/min/max/count equal those of the concatenated
        stream bit-for-bit (up to float round-off). The reservoir cannot
        combine exactly — each side kept only a uniform sample — so it is
        subsampled: every kept slot is drawn from side 1 with probability
        ``n1 / n`` (without replacement within each side), which preserves
        the every-element-equally-likely invariant quantile queries rest
        on. The draws come from ``self``'s own rng, never a simulation
        stream; merging is deterministic given both states.
        """
        if other.capacity != self.capacity:
            raise ValueError(
                f"reservoir capacities differ: {self.capacity} vs "
                f"{other.capacity}")
        if other._n == 0:
            return self
        if self._n == 0:
            self._res = list(other._res)
            self._n = other._n
            self._mean = other._mean
            self._m2 = other._m2
            self._max = other._max
            self._min = other._min
            return self
        n1, n2 = self._n, other._n
        n = n1 + n2
        d = other._mean - self._mean
        self._mean += d * n2 / n
        self._m2 += other._m2 + d * d * n1 * n2 / n
        self._max = max(self._max, other._max)
        self._min = min(self._min, other._min)
        self._n = n
        pool1 = list(self._res)
        pool2 = list(other._res)
        self._rng.shuffle(pool1)
        self._rng.shuffle(pool2)
        merged: list = []
        want = min(self.capacity, len(pool1) + len(pool2))
        i = j = 0
        while len(merged) < want:
            # weight each side by how many stream elements its pool stands
            # in for, so the merged reservoir stays uniform over the union
            w1 = n1 if i < len(pool1) else 0
            w2 = n2 if j < len(pool2) else 0
            if self._rng.random() * (w1 + w2) < w1:
                merged.append(pool1[i])
                i += 1
            else:
                merged.append(pool2[j])
                j += 1
        self._res = merged
        return self

    # ------------------------------------------------------------ state
    def state_dict(self) -> dict:
        return {
            "capacity": self.capacity,
            "seed": self.seed,
            "reservoir": list(self._res),
            "n": self._n,
            "mean": self._mean,
            "m2": self._m2,
            "max": None if not self._n else self._max,
            "min": None if not self._n else self._min,
            "rng_state": self._rng.bit_generator.state,
        }

    @classmethod
    def from_state_dict(cls, d: dict) -> "StreamingStat":
        s = cls(capacity=d["capacity"], seed=d.get("seed", 0))
        s._res = [float(x) for x in d["reservoir"]]
        s._n = int(d["n"])
        s._mean = float(d["mean"])
        s._m2 = float(d["m2"])
        s._max = -np.inf if d.get("max") is None else float(d["max"])
        s._min = np.inf if d.get("min") is None else float(d["min"])
        if d.get("rng_state") is not None:
            s._rng.bit_generator.state = d["rng_state"]
        return s


# metric name -> what one sample means (doc + construction table)
_METRICS = {
    "join_latency_s": "retired instance's end-to-end makespan (sim seconds)",
    "queue_wait_ticks": "admission-queue residence of an admitted instance",
    "solver_tick_us": "wall-clock of one batched solve tick (all launches)",
    "rows_per_launch": "real (un-padded) rows riding one family launch",
    "row_occupancy": "real rows / padded rows of one launch (bucket fill)",
    "live_instances": "live-instance count sampled once per tick",
}


class ServeTelemetry:
    """The engine's metric bundle: one :class:`StreamingStat` per metric
    in ``_METRICS`` plus monotone counters (admitted / retired / launches /
    slo_misses / ticks). ``summary()`` is the serve_trace payload."""

    def __init__(self, capacity: int = 2048, seed: int = 0):
        self.stats = {name: StreamingStat(capacity=capacity, seed=seed + i)
                      for i, name in enumerate(_METRICS)}
        self.counters = {"admitted": 0, "retired": 0, "launches": 0,
                         "slo_misses": 0, "ticks": 0}

    def add(self, name: str, value: float) -> None:
        self.stats[name].add(value)

    def bump(self, name: str, by: int = 1) -> None:
        self.counters[name] += int(by)

    def summary(self) -> dict:
        out = {name: stat.summary() for name, stat in self.stats.items()}
        out["counters"] = dict(self.counters)
        return out

    # ------------------------------------------------------------ state
    def state_dict(self) -> dict:
        return {"stats": {n: s.state_dict() for n, s in self.stats.items()},
                "counters": dict(self.counters)}

    @classmethod
    def from_state_dict(cls, d: dict) -> "ServeTelemetry":
        t = cls()
        for name, sd in d.get("stats", {}).items():
            t.stats[name] = StreamingStat.from_state_dict(sd)
        t.counters.update(d.get("counters", {}))
        return t
