"""In-process typed message bus + deterministic replay scheduler — a copy
of ``lvislam_tpu.utils.bus`` (pure Python; the port keeps its own).

The TPU-native replacement for the reference's entire communication layer
(SURVEY.md §2.7): ROS 2 DDS pub/sub with tuned QoS depths
(`lidar_odometry/src/utility.h:414-470`), TF2 broadcast, intra-process
comms, multi-threaded executors and mutex-guarded queues all collapse into
one single-threaded, timestamp-ordered event loop. Every replay is
bit-identical (the determinism the multi-process reference cannot have,
SURVEY.md §5 "race detection: structurally impossible").

- `Bus.publish(topic, stamp, msg)` enqueues; `Bus.subscribe(topic, fn)`
  registers a handler; `Scheduler.run()` drains events in (stamp, seq)
  order — seq breaks ties deterministically in publish order.
- bounded depths reproduce the reference's QoS drop behavior when a
  consumer lags (depth-1 best-effort clouds etc.);
- `set_dropout(topic, p, seed)` injects seeded sensor dropout for failure/
  recovery testing (SURVEY.md §5: the reference has no fault injection).
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
from collections import defaultdict, deque
from typing import Any, Callable


@dataclasses.dataclass
class Event:
    stamp: float
    seq: int
    topic: str
    msg: Any

    def __lt__(self, other):
        return (self.stamp, self.seq) < (other.stamp, other.seq)


class Bus:
    def __init__(self):
        self._subs: dict[str, list[Callable]] = defaultdict(list)
        self._queue: list[Event] = []
        self._seq = itertools.count()
        self._depth: dict[str, int] = {}
        self._pending_per_topic: dict[str, deque] = defaultdict(deque)
        self.latest: dict[str, Any] = {}  # TF-style last-value store
        self._dropout: dict[str, Any] = {}  # topic -> (prob, rng)

    def set_dropout(self, topic: str, prob: float, seed: int = 0):
        """Deterministic fault injection: drop each message on `topic` with
        probability `prob` (seeded — replays stay bit-identical)."""
        import numpy as _np

        self._dropout[topic] = (prob, _np.random.default_rng(seed))

    def set_depth(self, topic: str, depth: int):
        """QoS depth (`utility.h:414-470`): older undelivered messages on
        this topic are dropped beyond `depth`."""
        self._depth[topic] = depth

    def subscribe(self, topic: str, fn: Callable[[float, Any], None]):
        self._subs[topic].append(fn)

    def publish(self, topic: str, stamp: float, msg: Any):
        drop = self._dropout.get(topic)
        if drop is not None and drop[1].random() < drop[0]:
            return
        ev = Event(stamp, next(self._seq), topic, msg)
        heapq.heappush(self._queue, ev)
        pend = self._pending_per_topic[topic]
        pend.append(ev)
        depth = self._depth.get(topic)
        if depth is not None:
            while len(pend) > depth:
                dropped = pend.popleft()
                dropped.topic = None  # tombstone: skipped at dispatch

    def step(self) -> bool:
        """Dispatch the earliest event. Returns False when drained."""
        while self._queue:
            ev = heapq.heappop(self._queue)
            if ev.topic is None:
                continue
            pend = self._pending_per_topic[ev.topic]
            if pend and pend[0] is ev:
                pend.popleft()
            self.latest[ev.topic] = (ev.stamp, ev.msg)
            for fn in self._subs[ev.topic]:
                fn(ev.stamp, ev.msg)
            return True
        return False

    def run(self, until: float | None = None):
        while self._queue:
            if until is not None and self._queue[0].stamp > until:
                break
            self.step()
