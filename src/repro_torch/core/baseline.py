"""Broker-style pub/sub baseline — the comparison system (§1 Fig 1, §5.1).

(Copied from the JAX package's ``core/baseline.py``, whose package
``__init__`` imports jax.)

The paper compares Cascade with Kafka-Direct/Flink-style interconnects whose
stage-to-stage handoff involves: a broker node, per-topic logs, serialization
into wire buffers, consumer polling, and lock contention between producer and
consumer threads.  This module implements that architecture faithfully *in
the same process* so the comparison isolates the data path (both systems pay
identical Python/JAX costs for the stage compute itself):

- ``Broker`` — central component with per-topic queues; every publish
  *serializes* the payload (marshalling copy), appends under a topic lock,
  and wakes consumers; consumers *poll* and deserialize (second copy).
- lock contention: producers and consumers contend on the same topic lock —
  the exact effect the paper identified in Kafka-Direct when publisher and
  subscriber run on different nodes.
- optional ``batch_linger_s``: the throughput-over-latency knob (Kafka's
  linger.ms); with a backlog, consumers drain mini-batches.

``BrokerPipeline`` runs a chain of stage fns with a broker hop between every
pair of stages — the no-op pipeline benchmark runs the identical lambdas on
this and on the Cascade fast path.
"""
from __future__ import annotations

import pickle
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Sequence

from .objects import monotonic_ns


class Topic:
    def __init__(self, name: str) -> None:
        self.name = name
        self.log: deque[tuple[int, bytes]] = deque()
        self.lock = threading.Lock()          # producer/consumer contention
        self.not_empty = threading.Condition(self.lock)
        self.next_offset = 0


class Broker:
    def __init__(self, *, batch_linger_s: float = 0.0) -> None:
        self.topics: dict[str, Topic] = {}
        self.batch_linger_s = batch_linger_s
        self._meta = threading.Lock()

    def topic(self, name: str) -> Topic:
        with self._meta:
            t = self.topics.get(name)
            if t is None:
                t = self.topics[name] = Topic(name)
            return t

    def publish(self, topic: str, payload: Any) -> int:
        wire = pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL)  # copy #1
        t = self.topic(topic)
        if self.batch_linger_s:
            time.sleep(self.batch_linger_s)   # intentional batching delay
        with t.not_empty:
            off = t.next_offset
            t.next_offset += 1
            t.log.append((off, wire))
            t.not_empty.notify_all()
        return off

    def poll(self, topic: str, *, timeout_s: float = 5.0, max_records: int = 64) -> list[Any]:
        t = self.topic(topic)
        deadline = time.monotonic() + timeout_s
        with t.not_empty:
            while not t.log:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return []
                t.not_empty.wait(remaining)
            batch = []
            while t.log and len(batch) < max_records:
                _, wire = t.log.popleft()
                batch.append(wire)
        return [pickle.loads(w) for w in batch]  # copy #2


@dataclass
class _StageWorker:
    broker: Broker
    in_topic: str
    out_topic: str | None
    fn: Callable[[Any], Any]

    def start(self) -> threading.Thread:
        th = threading.Thread(target=self._loop, daemon=True)
        th.start()
        return th

    def _loop(self) -> None:
        while True:
            for item in self.broker.poll(self.in_topic, timeout_s=0.25):
                if item is None:  # poison pill
                    return
                out = self.fn(item)
                if self.out_topic is not None:
                    self.broker.publish(self.out_topic, out)


class BrokerPipeline:
    """Chain of stages with broker handoffs (the measured anti-pattern)."""

    def __init__(self, stage_fns: Sequence[Callable[[Any], Any]],
                 *, batch_linger_s: float = 0.0) -> None:
        self.broker = Broker(batch_linger_s=batch_linger_s)
        self.n = len(stage_fns)
        self._threads = []
        for i, fn in enumerate(stage_fns):
            w = _StageWorker(
                broker=self.broker,
                in_topic=f"stage-{i}",
                out_topic=f"stage-{i + 1}" if i + 1 < self.n else "sink",
                fn=fn,
            )
            self._threads.append(w.start())

    def send(self, payload: Any) -> None:
        self.broker.publish("stage-0", payload)

    def recv(self, *, timeout_s: float = 10.0) -> Any:
        out = self.broker.poll("sink", timeout_s=timeout_s, max_records=1)
        if not out:
            raise TimeoutError("pipeline produced no output")
        return out[0]

    def roundtrip(self, payload: Any) -> tuple[Any, float]:
        t0 = monotonic_ns()
        self.send(payload)
        out = self.recv()
        return out, (monotonic_ns() - t0) / 1e3  # us

    def stop(self) -> None:
        for i in range(self.n):
            self.broker.publish(f"stage-{i}", None)
