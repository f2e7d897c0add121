"""Cross-slot batching queue for staged pairing work (copy of
consensus_specs_tpu/streaming/queue.py: numpy only, the same bucket and
FIFO order).

A `VerificationQueue` holds STAGED groups — each one aggregate-verify's
pairing inputs, already host-staged to limb arrays by
`TorchBackend.stage_indexed_batch` — bucketed by pair count (the shape
axis of the grouped pairing). Groups accumulate ACROSS
slots until a bucket reaches the target occupancy (>= 128 groups per
launch by default: the shape where the shared-squaring Miller loop and
the batched final exponentiation actually fill a device batch, vs the
handful of groups one block contributes), at which point
`take_batches()` hands full batches to the pipeline. `partial=True`
drains the remainder — the fork-choice-deadline flush.

Depth is mirrored into the `firehose.queue_depth` gauge on every
mutation so /metrics and /healthz read the live backlog.
"""
from __future__ import annotations

import collections
from typing import Deque, Dict, List, Tuple

import numpy as np

from ._metrics import counter as _counter
from ._metrics import gauge as _gauge


class VerificationQueue:
    """Staged pairing groups, bucketed by pair count, accumulated across
    slots toward `target_groups` per device launch."""

    def __init__(self, target_groups: int = 128):
        assert target_groups >= 1
        self.target_groups = int(target_groups)
        # pair count -> deque of (key, g1 [count,2,L], g2 [count,2,2,L])
        self._buckets: Dict[int, Deque[tuple]] = {}
        self._depth = 0
        _gauge("firehose.queue_depth").set(0)   # registered from birth:
        # /metrics must show the backlog row before the first aggregate

    # -- state ----------------------------------------------------------

    @property
    def depth(self) -> int:
        """Total groups queued (the /healthz backlog)."""
        return self._depth

    def bucket_depths(self) -> Dict[int, int]:
        return {c: len(dq) for c, dq in self._buckets.items()}

    # -- mutation -------------------------------------------------------

    def push(self, key, pairs) -> None:
        """Enqueue one group: `pairs` = [(g1 [2,L], g2 [2,2,L])...] limb
        arrays (the stage_indexed_batch group shape). `key` is the
        caller's verdict handle (the verifier's content digest)."""
        count = len(pairs)
        assert count >= 1, "empty groups are decided at staging, not queued"
        g1 = np.stack([a for a, _ in pairs])
        g2 = np.stack([b for _, b in pairs])
        self._buckets.setdefault(count, collections.deque()).append(
            (key, g1, g2))
        self._depth += 1
        _counter("firehose.enqueued").inc()
        _gauge("firehose.queue_depth").set(self._depth)

    def take_batches(self, partial: bool = False
                     ) -> List[Tuple[int, list]]:
        """Pop dispatchable batches: every full `target_groups` run per
        bucket, plus — with `partial=True` (the deadline flush) — each
        bucket's remainder. Returns [(pair_count, members)] with members
        = [(key, g1, g2)] in FIFO order."""
        out: List[Tuple[int, list]] = []
        for count in sorted(self._buckets):
            dq = self._buckets[count]
            while len(dq) >= self.target_groups:
                out.append((count, [dq.popleft()
                                    for _ in range(self.target_groups)]))
            if partial and dq:
                out.append((count, [dq.popleft() for _ in range(len(dq))]))
        for count in [c for c, dq in self._buckets.items() if not dq]:
            del self._buckets[count]
        taken = sum(len(m) for _, m in out)
        if taken:
            self._depth -= taken
            _gauge("firehose.queue_depth").set(self._depth)
        return out
