#!/usr/bin/env python3
"""Find the caption server's knee: one set-up of a serving cell, then one
open-loop window per offered rate.

    python3 benchmark/sweep.py --workload msvd-serve --seed <n> --seconds <s> --rates 200 400 ...

For each rate it prints one JSON line: the offered and completed rates, p50
and p95 latency from due to answer, the generator's lateness, the median
latency of the window's first and second halves and the deepest the
server's queue got (a queue that grows through the window shows in both).
The knee is the highest rate whose completed rate keeps up with the offered
one and whose queue does not grow; a serving cell runs at a fixed share of
it. Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", default="msvd-serve")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    args = p.parse_args(argv)
    sys.path[:0] = [HERE, ROOT]
    import torch

    from benchlib.cells import load_cell
    from benchlib.context import Context
    from benchlib.weights import dims_of, make_weights
    from benchlib.hoststats import percentile
    from drivers import serve as drv  # noqa: F401 (the serve driver's own pieces)

    cell = load_cell(args.workload)
    device = torch.device("cuda", 0)
    tmp = tempfile.mkdtemp(prefix="bench-sweep-")
    try:
        ctx = Context(cell, args.seed, args.seconds, False, device, tmp, time.perf_counter(),
                      dims_of(cell.config))
        from benchlib import data
        from vct_tpu_torch.config import Config
        from vct_tpu_torch.serve import serve

        vocab = os.path.join(tmp, "vocab.txt")
        data.write_vocab(vocab, ctx.dims["vocab"])
        ckpt = os.path.join(tmp, "weights.pth")
        torch.save({k: v.cpu() for k, v in make_weights(ctx.dims, args.seed, device).items()},
                   ckpt)
        t = cell.traffic
        server = serve(Config.from_dict(ctx.program_config(vocab)), ckpt, device=device,
                       host="127.0.0.1", port=0, max_batch=int(t["max_batch"]),
                       batch_timeout_ms=float(t["batch_timeout_ms"]), log=lambda *_: None)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        port = server.server_address[1]
        drv.warm(port, ctx, int(t["warm_requests"]))
        for rate in args.rates:
            depth = [0]
            stop = threading.Event()

            def sample():
                while not stop.is_set():
                    depth[0] = max(depth[0], server.service._queue.qsize())
                    time.sleep(0.005)

            th = threading.Thread(target=sample, daemon=True)
            th.start()
            win = drv.serve_window(ctx, server.service, port, rate)
            stop.set()
            th.join()
            rows = win["rows"]
            s = drv.summarize(rows, args.seconds, float(t["timeout_s"]))
            half = len(rows) // 2
            lat = lambda rs: percentile([(r["done"] - r["due"]) * 1e3 for r in rs
                                             if r["status"] == 200], 0.5)
            batches = win["after"]["batches"] - win["before"]["batches"]
            print(json.dumps({"offered_per_s": rate, **s,
                              "first_half_p50_ms": lat(rows[:half]),
                              "second_half_p50_ms": lat(rows[half:]),
                              "max_queue": depth[0],
                              "rows_per_batch": (win["after"]["requests"]
                                                 - win["before"]["requests"]) / max(1, batches),
                              "card": torch.cuda.get_device_name(0)}), flush=True)
        server.shutdown()
        server.server_close()
        server.service.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
