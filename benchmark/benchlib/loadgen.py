"""Open-loop HTTP load for the caption server, in a process of its own.

    python3 loadgen.py '<json arguments>'

The schedule is a function of the seed: ``count`` requests over
``seconds``, separated by a fixed multiset of exponential gaps (a Poisson
process's, drawn once for every seed alike) in an order drawn from the seed,
each one video's features with a frame count from a fixed multiset, in an
order drawn from the seed. It builds every request's body, prints ``ready``,
reads the window's start (a ``time.monotonic`` reading) from standard input,
sends each request when it is due from a pool of threads, and writes one
JSON line per request: index, due, sent and done times, status, caption.
It imports nothing of the program and touches no card.
"""

from __future__ import annotations

import http.client
import json
import os
import queue
import sys
import threading
import time
from typing import Dict, List

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchlib.data import request_body, video_features  # noqa: E402

SPLIT = 9  # the served videos' split number in ``benchlib.data``


def schedule(seed: int, rate: float, seconds: float, frames) -> tuple:
    """(offsets [s] sorted, frame count per request): the same set of gaps
    between arrivals and the same set of sizes for every seed, each in
    another order."""
    count = int(round(rate * seconds))
    gaps = np.random.default_rng([count, 78]).exponential(1.0, count + 1)
    rng = np.random.default_rng([int(seed) % (1 << 63), 77])
    gaps = rng.permutation(gaps)
    offsets = seconds * np.cumsum(gaps)[:count] / gaps.sum()
    span = np.arange(frames[0], frames[1] + 1)
    sizes = rng.permutation(np.resize(span, count))
    return offsets, sizes


def request_features(seed: int, index: int, frames: int, dim: int) -> np.ndarray:
    return video_features(seed, SPLIT, index, (frames, frames), dim)


def post(host: str, port: int, body: bytes, timeout: float) -> tuple:
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        conn.request("POST", "/v1/caption", body=body,
                     headers={"Content-Type": "application/octet-stream"})
        resp = conn.getresponse()
        payload = json.loads(resp.read() or b"{}")
        return resp.status, payload.get("caption")
    finally:
        conn.close()


def main() -> None:
    a = json.loads(sys.argv[1])
    offsets, sizes = schedule(a["seed"], a["rate"], a["seconds"], a["frames"])
    bodies = {i: request_body(request_features(a["seed"], i, int(sizes[i]), a["dim"]))
              for i in range(len(offsets))}
    print("ready", flush=True)
    start = float(sys.stdin.readline())
    todo: "queue.Queue" = queue.Queue()
    results: List[Dict] = []
    lock = threading.Lock()

    def worker():
        while True:
            i = todo.get()
            if i is None:
                return
            due = start + offsets[i]
            sent = time.monotonic()
            try:
                status, caption = post(a["host"], a["port"], bodies[i], a["timeout"])
            except OSError as e:  # refused, reset, timed out: never answered
                status, caption = 0, f"{type(e).__name__}: {e}"
            done = time.monotonic()
            with lock:
                results.append({"i": i, "due": due, "sent": sent, "done": done,
                                "status": status, "caption": caption})

    threads = [threading.Thread(target=worker, daemon=True) for _ in range(a["threads"])]
    for t in threads:
        t.start()
    for i in range(len(offsets)):
        wait = start + offsets[i] - time.monotonic()
        if wait > 0:
            time.sleep(wait)
        todo.put(i)
    for _ in threads:
        todo.put(None)
    for t in threads:
        t.join()
    with open(a["out"], "w") as f:
        for r in results:
            f.write(json.dumps(r) + "\n")


if __name__ == "__main__":
    main()
