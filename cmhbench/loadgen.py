"""Open-loop load generator: a child process of the standard library alone.

    python -m cmhbench.loadgen <schedule.json> <port> <results.json>

The schedule is a list of ``[due_s, path, body]``: each request is sent at
its due time after the start, whatever is still outstanding, from a pool
of sender threads, and is timed from when it was due. The results file
holds the start (wall clock), and for each request its lateness (when it
was sent against when it was due), its latency, its HTTP status and its
reply; a request that fails or passes ``TIMEOUT_S`` has no latency.
"""

from __future__ import annotations

import http.client
import json
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

TIMEOUT_S = 60.0
SENDERS = 256


def _send(port: int, path: str, body: bytes, due: float, out: dict) -> None:
    sent = time.monotonic()
    out["late_s"] = sent - due
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT_S)
        try:
            conn.request("POST", path, body, {"Content-Type": "application/json"})
            resp = conn.getresponse()
            data = resp.read()
            done = time.monotonic()
            out["status"] = resp.status
            out["reply"] = json.loads(data) if resp.status == 200 else data.decode()[:200]
            out["latency_s"] = done - due if done - due <= TIMEOUT_S else None
        finally:
            conn.close()
    except (OSError, http.client.HTTPException, ValueError) as e:
        out["status"], out["error"], out["latency_s"] = None, repr(e), None


def drive(schedule, port: int) -> dict:
    results = [{} for _ in schedule]
    lead = 0.2          # the first request is due this long after the start
    t0 = time.monotonic() + lead
    start_wall = time.time() + lead
    with ThreadPoolExecutor(max_workers=SENDERS) as pool:
        futures = []
        for (due, path, body), out in zip(schedule, results):
            at = t0 + due
            wait = at - time.monotonic()
            if wait > 0:
                time.sleep(wait)
            futures.append(pool.submit(_send, port, path, json.dumps(body).encode(), at, out))
        for f in futures:
            f.result()
    return {"start_wall": start_wall, "results": results}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    with open(argv[0]) as f:
        schedule = json.load(f)
    out = drive(schedule, int(argv[1]))
    with open(argv[2], "w") as f:
        json.dump(out, f)
    return 0


if __name__ == "__main__":
    threading.stack_size(512 * 1024)
    sys.exit(main())
