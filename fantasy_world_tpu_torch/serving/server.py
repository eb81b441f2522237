"""Batched generation server (``serving/server.py``): an HTTP job API over
the samplers.

Jobs are submitted over HTTP; one worker thread, which owns the card,
drains the queue and runs compatible jobs through one CFG-batched denoise
(``FantasyWorldSampler.generate_videos``: B clips = a CFG batch of 2B
rows); the results are exported to disk and polled by job id.

Standard library only (http.server, threading): the server is IO-light,
and all the heavy work stays in the worker thread. The one exception is
the CUDA allocator: a server turns on its expandable segments
(``expandable_segments``), since a served batch of full-width clips on a
cache that earlier phases left fragmented runs out of memory with gigabytes
reserved but unallocated (``tools/torch_serve_oom_probe.py``).

    POST /v1/generate   {"prompt": ..., "image_path": ..., ...} -> {"job_id"}
    GET  /v1/jobs/<id>  -> {"status": queued|running|done|error, ...}
    GET  /v1/health     -> {"ok": true, "queued": N}

Jobs batch together when the settings that shape the denoise match
(``BATCH_KEY_FIELDS`` and whether a camera path is given); the worker takes
up to ``max_batch`` same-key jobs a cycle, after a ``linger_s`` wait that
lets a burst fill the batch, and defers jobs of another key to later
cycles. A failure marks every job of its batch as failed (the fault wall
is batch-granular), and the server goes on.
"""
from __future__ import annotations

import json
import os
import queue
import threading
import time
import uuid
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional


BATCH_KEY_FIELDS = ("height", "width", "num_frames", "sample_steps",
                    "cfg_scale", "neg_prompt", "tea_cache_l1_thresh",
                    "using_scale")

DEFAULTS = {
    "neg_prompt": "", "height": 336, "width": 592, "num_frames": 81,
    "sample_steps": 50, "cfg_scale": 5.0, "using_scale": True, "seed": None,
    "tea_cache_l1_thresh": None,   # per-job TeaCache: the whole batch
                                   # shares one skip plan
}


ALLOC_CONF = "PYTORCH_CUDA_ALLOC_CONF"


def expandable_segments() -> str:
    """Serve from expandable CUDA allocator segments, which grow in place
    instead of leaving per-size holes. Before CUDA starts the setting goes
    into ``PYTORCH_CUDA_ALLOC_CONF``; once it runs, into the allocator,
    for the segments it makes from then on. A ``PYTORCH_CUDA_ALLOC_CONF``
    the caller set wins. Ranks that share a card
    (``parallel.distributed.ranks_per_card``) keep the default segments:
    they map each other's staging buffers through CUDA IPC, which refuses
    an expandable segment on a kernel without the pidfd_open syscall.
    Returns what was done: "env", "runtime", "caller" or "shared"."""
    if os.environ.get(ALLOC_CONF):
        return "caller"
    import torch
    from ..parallel.distributed import ranks_per_card
    if ranks_per_card() > 1:
        return "shared"
    if not torch.cuda.is_initialized():
        os.environ[ALLOC_CONF] = "expandable_segments:True"
        return "env"
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    return "runtime"


@dataclass
class Job:
    id: str
    request: Dict
    status: str = "queued"            # queued | running | done | error
    result: Optional[Dict] = None
    error: Optional[str] = None
    submitted: float = field(default_factory=time.time)
    finished: Optional[float] = None
    progress: Optional[Dict] = None   # {"done": N, "total": M} while running

    def batch_key(self):
        # camera presence is part of the key: the batch_fn takes all-or-
        # none camera jobs; using_scale is in BATCH_KEY_FIELDS so that one
        # job cannot turn the scale normalization off for its batchmates
        return tuple(self.request.get(k, DEFAULTS.get(k))
                     for k in BATCH_KEY_FIELDS) \
            + (bool(self.request.get("camera_json")),)

    def public(self) -> Dict:
        out = {"job_id": self.id, "status": self.status,
               "submitted": self.submitted}
        if self.progress is not None and self.status == "running":
            out["progress"] = self.progress
        if self.result is not None:
            out["result"] = self.result
        if self.error is not None:
            out["error"] = self.error
        if self.finished is not None:
            out["finished"] = self.finished
        return out


class BatchWorker(threading.Thread):
    """Single consumer of the job queue; owns the device.

    batch_fn(jobs) -> list of JSON-serializable result dicts, one per job
    (same order). An exception marks every job in the batch as error.
    """

    def __init__(self, batch_fn: Callable[[List[Job]], List[Dict]],
                 max_batch: int = 4, linger_s: float = 0.2):
        super().__init__(daemon=True, name="generation-worker")
        self.batch_fn = batch_fn
        self.max_batch = max_batch
        self.linger_s = linger_s
        self.queue: "queue.Queue[Optional[Job]]" = queue.Queue()
        self._pending: List[Job] = []     # same-key jobs deferred to later cycles
        self._plock = threading.Lock()    # guards _pending: the shutdown
                                          # path's stranded() drains it
                                          # while run() may still append
        self._stopping = False

    def submit(self, job: Job) -> None:
        self.queue.put(job)

    def stop(self) -> None:
        self._stopping = True
        self.queue.put(None)

    def stranded(self) -> List[Job]:
        """Jobs still queued/deferred after stop(): the owner marks them
        terminal so pollers don't wait forever on status 'queued'."""
        with self._plock:
            out, self._pending = list(self._pending), []
        while True:
            try:
                j = self.queue.get_nowait()
            except queue.Empty:
                break
            if j is not None:
                out.append(j)
        return out

    def _take(self, timeout: Optional[float]) -> Optional[Job]:
        try:
            return self.queue.get(timeout=timeout)
        except queue.Empty:
            return None

    def _drain_batch(self) -> List[Job]:
        """Block for one job, linger for more, keep only same-key ones;
        different-key jobs go to _pending for the next cycle."""
        with self._plock:
            first = self._pending.pop(0) if self._pending else None
        if first is None:
            first = self._take(None)
            if first is None:
                return []
        batch, key = [first], first.batch_key()
        deadline = time.time() + self.linger_s
        # first scan any deferred jobs, then the live queue until linger ends
        with self._plock:
            keep = []
            for job in self._pending:
                if len(batch) < self.max_batch and job.batch_key() == key:
                    batch.append(job)
                else:
                    keep.append(job)
            self._pending = keep
        while len(batch) < self.max_batch:
            job = self._take(max(0.0, deadline - time.time()))
            if job is None:
                if self._stopping or time.time() >= deadline:
                    break
                continue
            if job.batch_key() == key:
                batch.append(job)
            else:
                with self._plock:
                    self._pending.append(job)
        return batch

    def run(self) -> None:
        while not self._stopping:
            batch = self._drain_batch()
            if not batch:
                if self._stopping:
                    return
                continue
            for job in batch:
                job.status = "running"
            try:
                results = self.batch_fn(batch)
                if len(results) != len(batch):
                    raise RuntimeError(
                        f"batch_fn returned {len(results)} results for "
                        f"{len(batch)} jobs")
                for job, res in zip(batch, results):
                    job.result, job.status = res, "done"
                    job.finished = time.time()
            except Exception as e:          # noqa: BLE001 -- job-level fault wall
                for job in batch:
                    job.status, job.error = "error", f"{type(e).__name__}: {e}"
                    job.finished = time.time()


class GenerationServer:
    """HTTP front over a BatchWorker + job registry."""

    def __init__(self, batch_fn, host: str = "127.0.0.1", port: int = 8000,
                 max_batch: int = 4, linger_s: float = 0.2,
                 validate_fn: Optional[Callable[[Dict], Optional[str]]] = None,
                 auth_token: Optional[str] = None,
                 retention_s: Optional[float] = 3600.0,
                 max_body_bytes: int = 16 << 20):
        """validate_fn(request) -> error string | None: per-job validation
        at POST time, so a malformed job is rejected with a 400 instead of
        erroring its whole batch at run time (the fault wall in
        BatchWorker.run is batch-granular). auth_token: require
        'Authorization: Bearer <token>' on generate/jobs endpoints --
        mandatory when binding a non-loopback host, since requests carry
        raw filesystem paths. retention_s: finished jobs older than this
        are pruned on the next submit. The CUDA allocator's expandable
        segments go on (``expandable_segments``)."""
        expandable_segments()
        self.jobs: Dict[str, Job] = {}
        self.validate_fn = validate_fn
        self.auth_token = auth_token
        self.retention_s = retention_s
        self.max_body_bytes = max_body_bytes
        self._lock = threading.Lock()
        self.worker = BatchWorker(batch_fn, max_batch=max_batch,
                                  linger_s=linger_s)
        handler = self._make_handler()
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self.port = self.httpd.server_address[1]    # resolved when port=0

    # -- job registry ----------------------------------------------------------

    def _prune_locked(self) -> None:
        if self.retention_s is None:
            return
        cut = time.time() - self.retention_s
        for k in [k for k, j in self.jobs.items()
                  if j.finished is not None and j.finished < cut]:
            del self.jobs[k]

    def submit(self, request: Dict) -> Job:
        job = Job(id=uuid.uuid4().hex[:12], request=request)
        with self._lock:
            self._prune_locked()
            self.jobs[job.id] = job
        self.worker.submit(job)
        return job

    def get(self, job_id: str) -> Optional[Job]:
        with self._lock:
            return self.jobs.get(job_id)

    def queued_count(self) -> int:
        with self._lock:
            return sum(j.status == "queued" for j in self.jobs.values())

    # -- lifecycle --------------------------------------------------------------

    def start(self) -> None:
        self.worker.start()
        threading.Thread(target=self.httpd.serve_forever, daemon=True,
                         name="generation-http").start()

    def serve_forever(self) -> None:
        self.worker.start()
        self.httpd.serve_forever()

    def shutdown(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()       # release the listen socket NOW
        self.worker.stop()
        if self.worker.is_alive():
            self.worker.join(timeout=5.0)   # let an in-flight batch finish
        for job in self.worker.stranded():
            job.status, job.error = "error", "server shutdown"
            job.finished = time.time()

    # -- http -------------------------------------------------------------------

    def _make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def _send(self, code: int, payload: Dict):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _authorized(self) -> bool:
                if server.auth_token is None:
                    return True
                import hmac
                return hmac.compare_digest(
                    self.headers.get("Authorization", ""),
                    f"Bearer {server.auth_token}")

            def do_POST(self):
                from urllib.parse import urlsplit
                if urlsplit(self.path).path != "/v1/generate":
                    return self._send(404, {"error": "not found"})
                if not self._authorized():
                    return self._send(401, {"error": "unauthorized"})
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                except ValueError:
                    return self._send(400, {"error": "bad content-length"})
                if n < 0 or n > server.max_body_bytes:
                    # negative would make read() block to EOF; huge would
                    # buffer the whole body before json.loads
                    return self._send(413, {
                        "error": f"body must be 0..{server.max_body_bytes} "
                                 f"bytes"})
                try:
                    req = json.loads(self.rfile.read(n) or b"{}")
                except (ValueError, json.JSONDecodeError) as e:
                    return self._send(400, {"error": f"bad json: {e}"})
                if not isinstance(req, dict) or "prompt" not in req:
                    return self._send(400, {"error": "'prompt' is required"})
                if server.validate_fn is not None:
                    err = server.validate_fn(req)
                    if err:
                        return self._send(400, {"error": err})
                job = server.submit(req)
                self._send(202, {"job_id": job.id, "status": job.status})

            def do_GET(self):
                # strip query strings: polling clients append cache-busting
                # params
                from urllib.parse import urlsplit
                path = urlsplit(self.path).path
                if path == "/v1/health":
                    return self._send(200, {"ok": True,
                                            "queued": server.queued_count()})
                if path.startswith("/v1/jobs/"):
                    if not self._authorized():
                        return self._send(401, {"error": "unauthorized"})
                    job = server.get(path.rsplit("/", 1)[1])
                    if job is None:
                        return self._send(404, {"error": "unknown job"})
                    return self._send(200, job.public())
                self._send(404, {"error": "not found"})

            def log_message(self, *a):     # quiet; the worker logs itself
                pass

        return Handler
