"""The HTTP load generator, run as a process of its own so that it shares no
interpreter lock with the server's threads; standard library only.

    python -m benchmark.loadgen PLAN.json

PLAN: {"port", "kind": "open" | "closed", "clients", "seconds", "wait_s",
"requests": [[id, due_s or null, body], ...]}. It prints "ready", waits for
"go T0" on standard input (T0 on the host's monotonic clock, which every
process shares), then sends: an open loop each request at T0 + due from a
pool of threads, a closed loop `clients` callers that each send the next
request when the last returns, until T0 + seconds. It waits for the
answers (at most `wait_s` after the window), prints one JSON line of
results (per request: id, sent, done, status, audio bytes, and for a
request not answered with 200 its `error`: the exception, or the status
and the start of the body) and keeps the
WAV bodies; "dump PATH ID ..." writes those requests' 16-bit samples to
PATH (.npy files in one .npz, by id) and it exits.
"""

from __future__ import annotations

import http.client
import io
import json
import queue
import sys
import threading
import time
import wave
import zipfile

POOL = 256  # open loop: the most requests in flight
ERROR_BYTES = 200  # of a refused request's body, kept as its error


def _post(port: int, body: bytes, timeout: float):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", "/tts", body, {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _npy_int16(samples: bytes) -> bytes:
    header = "{'descr': '<i2', 'fortran_order': False, 'shape': (%d,), }" % (len(samples) // 2)
    header += " " * (63 - (len(header) + 10) % 64) + "\n"
    return b"\x93NUMPY\x01\x00" + len(header).to_bytes(2, "little") + header.encode() + samples


def main(plan_path: str) -> None:
    plan = json.load(open(plan_path))
    port, seconds, wait_s = plan["port"], plan["seconds"], plan["wait_s"]
    reqs = plan["requests"]
    results = {}
    bodies = {}
    lock = threading.Lock()

    def send(rid, body):
        sent = time.monotonic()
        error = None
        try:
            status, data = _post(port, body.encode(), timeout=seconds + wait_s)
        except Exception as e:  # refused, reset, timed out or malformed: a failed request
            status, data = 0, b""
            error = f"{type(e).__name__}: {e}"
        done = time.monotonic()
        if error is None and status != 200:
            error = f"status {status}: {data[:ERROR_BYTES].decode('utf-8', 'replace')}"
        with lock:
            results[rid] = {"id": rid, "sent": sent, "done": done, "status": status,
                            "bytes": len(data), "error": error}
            if status == 200:
                bodies[rid] = data

    print("ready", flush=True)
    cmd = sys.stdin.readline().split()
    t0 = float(cmd[1])
    end = t0 + seconds
    threads = []
    if plan["kind"] == "open":
        work: "queue.Queue" = queue.Queue()

        def worker():
            while True:
                item = work.get()
                if item is None:
                    return
                send(*item)

        threads = [threading.Thread(target=worker, daemon=True) for _ in range(POOL)]
        for t in threads:
            t.start()
        late = []
        for rid, due, body in reqs:
            at = t0 + due
            now = time.monotonic()
            if at > now:
                time.sleep(at - now)
            late.append(time.monotonic() - at)
            work.put((rid, body))
        for _ in threads:
            work.put(None)
    else:
        late = []
        nxt = iter(reqs)

        def client():
            while time.monotonic() < end:
                with lock:
                    item = next(nxt, None)
                if item is None:
                    return
                send(item[0], item[2])

        time.sleep(max(0.0, t0 - time.monotonic()))
        threads = [threading.Thread(target=client, daemon=True) for _ in range(plan["clients"])]
        for t in threads:
            t.start()
    for t in threads:
        t.join(timeout=max(0.0, end + wait_s - time.monotonic()))
    with lock:
        out = {"t0": t0, "late_s": late, "results": list(results.values())}
    print(json.dumps(out), flush=True)
    cmd = sys.stdin.readline().split()
    if cmd and cmd[0] == "dump":
        with zipfile.ZipFile(cmd[1], "w") as z:
            for rid in map(int, cmd[2:]):
                with wave.open(io.BytesIO(bodies[rid])) as w:
                    z.writestr(f"{rid}.npy", _npy_int16(w.readframes(w.getnframes())))
        print("dumped", flush=True)


if __name__ == "__main__":
    main(sys.argv[1])
