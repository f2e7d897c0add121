"""Replay pytest-xdist's `--dist load` schedule from measured test times.

    python -m pytest tests/ -q -m 'not slow' --collect-only -p no:randomly | grep '::' > ids.txt
    python3 tools/xdist_replay.py ids.txt run.xml [--workers 6] [--extra 0 22 50]

`ids.txt` is the collection in order, `run.xml` the junit file of a run
(each test's time). The replay follows xdist 3.x's LoadScheduling: each
worker first gets `len(collection) // workers // 4` consecutive tests; a
worker left with fewer than `pending // workers // 4` is topped up to
`pending // workers // 2` from the head of the pending list, unless its
last test took 0.1 s or more and it still holds two. It prints the
replayed wall (the last worker's end), each worker's last test, and with
--extra the wall after adding that many instant tests at the end of the
collection: the chunk boundaries, and so which heavy tests share a worker,
move with the collection's size. Each test keeps its measured time: where
tests of one process share compiled programs (the JAX package's pairing
tests), a test moved to another worker compiles them again and the real
wall can be longer than the replay's.
"""
from __future__ import annotations

import argparse
import heapq
import xml.etree.ElementTree as ET


def junit_times(path: str) -> dict:
    """{test id: seconds} from a junit file (ids as pytest prints them)."""
    times = {}
    for case in ET.parse(path).getroot().iter("testcase"):
        module = case.get("classname").split(".")[-1]
        times[f"tests/{module}.py::{case.get('name')}"] = float(case.get("time"))
    return times


def replay(order, times, workers: int = 6, default: float = 0.5):
    """(wall seconds, {worker: (end, last test)}) of one replayed run."""
    def dur(i):
        return times.get(order[i], default)

    pending = list(range(len(order)))
    chunk = max(len(order) // workers // 4, 2)
    queues = []
    for _ in range(workers):
        queues.append(pending[:chunk])
        pending = pending[chunk:]
    events = [(dur(q[0]), k) for k, q in enumerate(queues) if q]
    heapq.heapify(events)
    last, wall = {}, 0.0
    while events:
        t, k = heapq.heappop(events)
        done = queues[k].pop(0)
        wall = max(wall, t)
        last[k] = (t, order[done])
        if pending:
            low = max(2, len(pending) // workers // 4)
            high = max(2, len(pending) // workers // 2)
            if len(queues[k]) < low and not (dur(done) >= 0.1 and len(queues[k]) >= 2):
                n = high - len(queues[k])
                queues[k] += pending[:n]
                pending = pending[n:]
        if queues[k]:
            heapq.heappush(events, (t + dur(queues[k][0]), k))
    return wall, last


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("ids", help="the collection, one test id a line, in order")
    ap.add_argument("junit", help="a run's junit file")
    ap.add_argument("--workers", type=int, default=6)
    ap.add_argument("--extra", type=int, nargs="*", default=[])
    args = ap.parse_args()
    with open(args.ids) as f:
        order = [line.strip() for line in f if "::" in line]
    times = junit_times(args.junit)
    wall, last = replay(order, times, args.workers)
    print(f"{len(order)} tests, first chunks of {len(order) // args.workers // 4}:"
          f" replayed wall {wall:.1f} s")
    for k, (t, test) in sorted(last.items(), key=lambda kv: kv[1][0]):
        print(f"  worker {k}: ends at {t:.1f} s with {test}")
    for extra in args.extra:
        grown = order + [f"tests/extra.py::t{i}" for i in range(extra)]
        print(f"+{extra} instant tests ({len(grown)}, chunks of"
              f" {len(grown) // args.workers // 4}): replayed wall"
              f" {replay(grown, times, args.workers)[0]:.1f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
