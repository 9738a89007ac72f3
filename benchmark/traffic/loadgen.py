"""The serve cell's load generator, a process of its own (stdlib only).

    python loadgen.py PLAN.json

PLAN holds the server's URL, the warm-up requests and the open-loop
schedule: for each request its send time in seconds after the start and
the JPEG it posts. The generator reads commands on stdin: `warm` posts the
warm-up requests (waves of concurrent posts) and answers `warmed`; `go`
starts the schedule's clock, posts each request at its time from a pool of
sender threads whatever the earlier ones are doing, waits for every
response, and prints one JSON line: for each request its scheduled and
actual send times and its completion time (seconds from the start, on this
process's monotonic clock), its HTTP status, and the answer.
"""
from __future__ import annotations

import http.client
import json
import queue
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor


def post(host: str, port: int, body: bytes, timeout: float):
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        conn.request("POST", "/predict", body,
                     {"Content-Type": "application/octet-stream"})
        resp = conn.getresponse()
        data = resp.read()
        return resp.status, data
    finally:
        conn.close()


def main() -> int:
    with open(sys.argv[1]) as f:
        plan = json.load(f)
    host, port, timeout = plan["host"], plan["port"], plan["timeout_s"]
    blobs = {}
    for path in plan["files"]:
        with open(path, "rb") as f:
            blobs[path] = f.read()
    for line in sys.stdin:
        cmd = line.strip()
        if cmd == "warm":
            for wave in plan["warmup"]:
                with ThreadPoolExecutor(len(wave)) as pool:
                    for status, _ in pool.map(
                            lambda p: post(host, port, blobs[p], timeout),
                            wave):
                        if status != 200:
                            raise RuntimeError(f"warm-up answered {status}")
            print("warmed", flush=True)
        elif cmd == "go":
            print(json.dumps(run_schedule(plan, blobs)), flush=True)
            return 0
    return 1


def run_schedule(plan: dict, blobs: dict) -> dict:
    host, port, timeout = plan["host"], plan["port"], plan["timeout_s"]
    schedule = plan["schedule"]
    results = [None] * len(schedule)
    todo: queue.Queue = queue.Queue()
    t0 = time.monotonic()

    def sender():
        while True:
            job = todo.get()
            if job is None:
                return
            i, at, path = job
            sent = time.monotonic() - t0
            try:
                status, data = post(host, port, blobs[path], timeout)
                answer = json.loads(data) if status == 200 else None
            except (OSError, http.client.HTTPException) as e:
                status, answer = 0, {"error": repr(e)[:200]}
            results[i] = {"at": at, "sent": sent,
                          "done": time.monotonic() - t0, "status": status,
                          "file": path, "answer": answer}

    threads = [threading.Thread(target=sender, daemon=True)
               for _ in range(plan["senders"])]
    for t in threads:
        t.start()
    for i, (at, path) in enumerate(schedule):
        delay = at - (time.monotonic() - t0)
        if delay > 0:
            time.sleep(delay)
        todo.put((i, at, path))
    for _ in threads:
        todo.put(None)
    for t in threads:
        t.join()
    return {"requests": results}


if __name__ == "__main__":
    sys.exit(main())
