"""The port's serving layer: the job server (``serving/server.py``) under
the six cases of ``tests/test_serving.py``, the serve CLI's batch
functions on a tiny sampler (each job of a batch equals
``generate_video`` with its seed; Wan2.2 jobs one at a time), and
``python -m fantasy_world_tpu_torch.cli.serve --device cpu --port 0`` on
the tiny reference-layout checkpoint, answering a POST to ``done`` in a
fresh interpreter that never imports JAX."""
import argparse
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from fantasy_world_tpu_torch.cli.serve import (make_batch_fn,
                                               make_validate_fn)
from fantasy_world_tpu_torch.serving.server import GenerationServer, Job

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _post(port, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/generate",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req) as r:
        return json.loads(r.read()), r.status


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}") as r:
        return json.loads(r.read()), r.status


def _wait_done(port, job_id, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        body, _ = _get(port, f"/v1/jobs/{job_id}")
        if body["status"] in ("done", "error"):
            return body
        time.sleep(0.02)
    raise TimeoutError(f"job {job_id} not done")


@pytest.fixture()
def server():
    calls = []

    def batch_fn(jobs):
        calls.append([j.request["prompt"] for j in jobs])
        out = []
        for j in jobs:
            if j.request["prompt"] == "boom":
                raise RuntimeError("synthetic failure")
            out.append({"echo": j.request["prompt"],
                        "batch_size": len(jobs)})
        return out

    srv = GenerationServer(batch_fn, port=0, max_batch=4, linger_s=0.15)
    srv.calls = calls
    srv.start()
    yield srv
    srv.shutdown()


def test_submit_poll_and_batching(server):
    port = server.port
    body, status = _get(port, "/v1/health")
    assert status == 200 and body["ok"]
    ids = [_post(port, {"prompt": f"p{i}"})[0]["job_id"] for i in range(3)]
    results = [_wait_done(port, i) for i in ids]
    assert all(r["status"] == "done" for r in results)
    assert [r["result"]["echo"] for r in results] == ["p0", "p1", "p2"]
    assert any(len(c) > 1 for c in server.calls), server.calls


def test_shape_mismatch_splits_batches(server):
    port = server.port
    a = _post(port, {"prompt": "a", "height": 336})[0]["job_id"]
    b = _post(port, {"prompt": "b", "height": 480})[0]["job_id"]
    ra, rb = _wait_done(port, a), _wait_done(port, b)
    assert ra["status"] == rb["status"] == "done"
    for call in server.calls:
        assert not ({"a", "b"} <= set(call))


def test_job_progress_reporting():
    release = []

    def batch_fn(jobs):
        for j in jobs:
            j.progress = {"done": 2, "total": 4}
        while not release:
            time.sleep(0.01)
        return [{"echo": j.request["prompt"]} for j in jobs]

    srv = GenerationServer(batch_fn, port=0, max_batch=1, linger_s=0.01)
    srv.start()
    try:
        jid = _post(srv.port, {"prompt": "p"})[0]["job_id"]
        deadline = time.time() + 5.0
        body = {}
        while time.time() < deadline:
            body, _ = _get(srv.port, f"/v1/jobs/{jid}")
            if body.get("progress"):
                break
            time.sleep(0.02)
        assert body.get("progress") == {"done": 2, "total": 4}
        release.append(1)
        done = _wait_done(srv.port, jid)
        assert done["status"] == "done" and "progress" not in done
    finally:
        release.append(1)
        srv.shutdown()


def test_error_isolation_and_validation(server):
    port = server.port
    jid = _post(port, {"prompt": "boom"})[0]["job_id"]
    r = _wait_done(port, jid)
    assert r["status"] == "error" and "synthetic failure" in r["error"]
    ok = _post(port, {"prompt": "fine"})[0]["job_id"]
    assert _wait_done(port, ok)["status"] == "done"
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(port, {"no_prompt": 1})
    assert ei.value.code == 400
    body, _ = _get(port, "/v1/health")
    assert body["ok"]
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(port, "/v1/jobs/doesnotexist")
    assert ei.value.code == 404


def test_server_turns_on_expandable_segments(monkeypatch):
    """Before CUDA starts, a server puts expandable segments into
    PYTORCH_CUDA_ALLOC_CONF; a value the caller set is left as it is."""
    from fantasy_world_tpu_torch.serving.server import (ALLOC_CONF,
                                                        expandable_segments)
    monkeypatch.delenv(ALLOC_CONF, raising=False)
    srv = GenerationServer(lambda jobs: [{} for _ in jobs], port=0)
    try:
        assert os.environ[ALLOC_CONF] == "expandable_segments:True"
    finally:
        srv.httpd.server_close()
    monkeypatch.setenv(ALLOC_CONF, "expandable_segments:False")
    assert expandable_segments() == "caller"
    assert os.environ[ALLOC_CONF] == "expandable_segments:False"


def test_ranks_sharing_a_card_keep_the_default_segments(monkeypatch):
    """Two local ranks with no card of their own each (here: the CPU, no
    cards) map each other's staging buffers through CUDA IPC, which an
    expandable segment refuses on kernels without pidfd_open: neither
    serve's start nor a server turns expandable segments on for them."""
    from fantasy_world_tpu_torch.serving.server import (ALLOC_CONF,
                                                        expandable_segments)
    monkeypatch.delenv(ALLOC_CONF, raising=False)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    assert expandable_segments() == "shared"
    srv = GenerationServer(lambda jobs: [{} for _ in jobs], port=0)
    srv.httpd.server_close()
    assert ALLOC_CONF not in os.environ


def test_make_batch_fn22_per_job_loop(tmp_path):
    """--variant wan22: one generate_video per job, each job its own
    export directory, progress only on its own job."""
    calls = []

    class StubSampler:
        def generate_video(self, **kw):
            calls.append(kw)
            if kw.get("progress_callback"):
                kw["progress_callback"](1, 3)
            return np.zeros((5, 8, 8, 3), np.uint8), {}

        @staticmethod
        def export(video, pred, out_dir, **kw):
            os.makedirs(out_dir, exist_ok=True)
            path = os.path.join(out_dir, "video.mp4")
            with open(path, "wb") as f:
                f.write(b"x")
            return {"video": path, "ply": None}

    args = argparse.Namespace(segment_size=2, output_root=str(tmp_path))
    fn = make_batch_fn(StubSampler(), args, wan22=True)
    jobs = [Job(id=f"j{i}", request={"prompt": f"p{i}",
                                     "image_path": "img.png"})
            for i in range(2)]
    out = fn(jobs)
    assert len(out) == len(calls) == 2
    assert calls[0]["prompt"] == "p0" and calls[1]["prompt"] == "p1"
    assert calls[0]["seed"] == 42 and calls[0]["segment_size"] == 2
    assert jobs[0].progress == jobs[1].progress == {"done": 1, "total": 3}
    assert all(o["frames"] == 5 and o["video"] == "video.mp4" for o in out)
    assert {o["output_dir"].rsplit("/", 1)[-1] for o in out} == {"j0", "j1"}


def test_camera_and_scale_split_batches():
    base = {"prompt": "p", "image_path": "i.png", "height": 64, "width": 64}
    j_cam = Job(id="1", request={**base, "camera_json": "c.json"})
    j_plain = Job(id="2", request=dict(base))
    j_noscale = Job(id="3", request={**base, "using_scale": False})
    assert j_cam.batch_key() != j_plain.batch_key()
    assert j_noscale.batch_key() != j_plain.batch_key()
    assert Job(id="4", request=dict(base)).batch_key() == j_plain.batch_key()


def test_validate_fn_confines_paths(tmp_path):
    img = tmp_path / "in" / "img.png"
    img.parent.mkdir()
    img.write_bytes(b"x")
    validate = make_validate_fn(argparse.Namespace(
        io_root=str(tmp_path / "in")))
    assert validate({"image_path": str(img)}) is None
    assert "outside --io_root" in validate(
        {"image_path": str(tmp_path / "elsewhere.png")})
    assert "not found" in validate({"image_path": str(img) + "x"})
    assert "outside --io_root" in validate({
        "image_path": str(img), "output_dir": str(tmp_path / "out")})
    assert "'seed'" in validate({"image_path": str(img), "seed": "7"})
    assert "'height'" in validate({"image_path": str(img), "height": 0})


# ---------------------------------------------------------------------------
# on a tiny sampler and its checkpoint files
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    import test_torch_sampler as ts
    root = tmp_path_factory.mktemp("serve")
    env = ts.make_env(root)
    wan, model = ts._write_reference_layout(root, env["modules"],
                                            np.random.default_rng(7))
    return {"env": env, "wan": wan, "model": model, "ts": ts}


def test_make_batch_fn_rows_equal_single_clips(tiny, tmp_path):
    """A 2-job batch through one generate_videos call: each job's exported
    clip is ``generate_video`` with its own prompt, image and seed."""
    ts, env = tiny["ts"], tiny["env"]
    sampler = ts._torch_sampler(env, env["modules"])
    seen = {}
    export = sampler.export

    def recording_export(video, pred, out_dir, **kw):
        seen[os.path.basename(out_dir)] = (video, pred)
        return export(video, pred, out_dir, **kw)
    sampler.export = recording_export
    req = {"image_path": env["image_path"], "camera_json": env["cams"],
           "height": ts.H, "width": ts.W, "num_frames": ts.FRAMES,
           "sample_steps": 1, "neg_prompt": ts.NEG, "using_scale": False}
    jobs = [Job(id="a", request={**req, "prompt": ts.PROMPT, "seed": 5}),
            Job(id="b", request={**req, "prompt": "a valley", "seed": 9})]
    assert jobs[0].batch_key() == jobs[1].batch_key()
    fn = make_batch_fn(sampler, argparse.Namespace(
        segment_size=1, output_root=str(tmp_path)))
    out = fn(jobs)
    assert [o["output_dir"] for o in out] == [str(tmp_path / j)
                                              for j in "ab"]
    assert jobs[0].progress == {"done": 1, "total": 1}
    with open(env["cams"]) as fh:
        cams = ts.cameras_json_to_camera_list(json.load(fh),
                                              image_size=(ts.H, ts.W))
    for job in jobs:
        video, pred = seen[job.id]
        one = sampler.generate_video(
            job.request["prompt"], ts.NEG, image_path=env["image_path"],
            camera_params=cams, using_scale=False, seed=job.request["seed"],
            height=ts.H, width=ts.W, num_frames=ts.FRAMES, sample_steps=1)
        assert np.abs(video.astype(int) - one[0].astype(int)).max() <= 1
        for k, v in one[1].items():
            err = np.abs(pred[k] - v).max() / max(np.abs(v).max(), 1e-12)
            assert err <= 1e-4, (job.id, k, err)
        assert os.path.isfile(os.path.join(tmp_path, job.id,
                                           "recon_confthresh1.0.ply"))


def test_serve_cli_answers_a_request(tiny, tmp_path):
    """``cli.serve --device cpu --port 0`` in a fresh interpreter: one POST
    polled from queued to done with its progress, the outputs on disk, a
    clean stop on SIGINT, and no JAX module loaded."""
    ts, env = tiny["ts"], tiny["env"]
    code = (
        "import sys\n"
        "from fantasy_world_tpu_torch.cli.serve import main\n"
        "main(sys.argv[1:])\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'fantasy_world_tpu')]\n"
        "assert not bad, bad\n"
        "print('clean', flush=True)\n")
    env_vars = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    # a server that never comes up must not hold the suite
    watchdog = threading.Timer(300, lambda: proc.kill())
    proc = subprocess.Popen(
        [sys.executable, "-c", code, "--device", "cpu", "--port", "0",
         "--ckpt_dir", tiny["wan"], "--model_ckpt", tiny["model"],
         "--tokenizer_path", env["tok"], "--output_root",
         str(tmp_path / "out"), "--segment_size", "1", "--linger_s",
         "0.05", "--io_root", str(tiny["wan"].rsplit("/", 1)[0])],
        cwd=REPO, env=env_vars, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    watchdog.start()
    try:
        line = proc.stdout.readline()
        assert line.startswith("serving on http://127.0.0.1:"), (
            line, proc.stderr.read() if proc.poll() is not None else "")
        port = int(line.split(":")[2].split()[0])
        jid, status = _post(port, {
            "prompt": ts.PROMPT, "image_path": env["image_path"],
            "camera_json": env["cams"], "height": ts.H, "width": ts.W,
            "num_frames": ts.FRAMES, "sample_steps": 3, "seed": 3})
        assert status == 202 and jid["status"] == "queued"
        seen = set()
        deadline = time.time() + 120
        while time.time() < deadline:
            body, _ = _get(port, f"/v1/jobs/{jid['job_id']}")
            seen.add((body["status"], json.dumps(body.get("progress"))))
            if body["status"] in ("done", "error"):
                break
            time.sleep(0.05)
        assert body["status"] == "done", body
        assert body["result"]["frames"] == ts.FRAMES
        out_dir = body["result"]["output_dir"]
        assert out_dir == str(tmp_path / "out" / jid["job_id"])
        assert os.listdir(out_dir)
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(port, {"prompt": "p",
                         "image_path": str(tmp_path / "elsewhere.png")})
        assert ei.value.code == 400
    finally:
        proc.send_signal(signal.SIGINT)
        out, err = proc.communicate(timeout=60)
        watchdog.cancel()
    assert proc.returncode == 0, err[-3000:]
    assert "clean" in out
    # steps 2 and 3 run after the first steps' progress is reported
    assert any(s == "running" and p != "null" for s, p in seen), seen


@pytest.mark.parametrize("extra,cuda,want", [
    ((), False, "--device cpu"),
    (("--device", "cpu", "--mesh_seq", "2"), True,
     "--mesh_seq: a 1x2x1 mesh needs 2 processes"),
    (("--device", "cpu", "--ulysses"), True, "--ulysses"),
    (("--device", "cpu", "--variant", "wan22"), True, "--model_ckpt_high")])
def test_serve_cli_exits(tiny, monkeypatch, extra, cuda, want):
    """Without a card and without --device cpu the server exits, as do a
    mesh without torchrun (naming the process count it needs), --ulysses
    without seq ranks and a variant without its checkpoints; it never
    starts listening."""
    from fantasy_world_tpu_torch.cli import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cuda)
    monkeypatch.setattr(serve, "make_batch_fn", None)
    with pytest.raises(SystemExit) as exc:
        serve.main(["--ckpt_dir", tiny["wan"], "--model_ckpt", tiny["model"],
                    "--port", "0", *extra])
    assert want in str(exc.value)


def test_served_mesh_survives_idling_past_the_group_timeout(tmp_path):
    """A served 1x1x2 mesh whose process group times out after 2 s idles
    for 5 s, then serves a job: the follower waits for the batch over the
    control group (no time limit), the batch's own collective still runs
    over the default group, and the stop ends both ranks (the spawn raises
    if either fails). Over the default group the follower's wait would
    time out after 2 s."""
    import torch_mesh_workers as workers
    from fantasy_world_tpu_torch.parallel import distributed
    out = tmp_path / "follower.json"
    distributed.spawn(workers.idle_serve_case, 2, 5.0, str(tmp_path / "o"),
                      str(out), timeout_s=2.0)
    got = json.loads(out.read_text())
    assert got == {"batches": 1, "calls": [[["p"], 2]]}


def test_serve_cli_mesh_under_torchrun(tiny, tmp_path):
    """``torchrun --nproc_per_node 2 -m ...cli.serve --device cpu
    --mesh_model 2``: rank 0 serves, rank 1 follows. Two POSTs are batched
    as one B = 2 run on both ranks; the exported clips equal the
    one-process server's batch function on the same checkpoint; SIGINT to
    rank 0 stops the server, the stop reaches rank 1, and every rank and
    torchrun exit 0."""
    import re
    from fantasy_world_tpu_torch.sampler import FantasyWorldSampler
    ts, env = tiny["ts"], tiny["env"]
    env_vars = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env_vars["OMP_NUM_THREADS"] = "1"
    out_root = tmp_path / "mesh"
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "fantasy_world_tpu_torch.cli.serve",
         "--device", "cpu", "--port", "0", "--mesh_model", "2",
         "--ckpt_dir", tiny["wan"], "--model_ckpt", tiny["model"],
         "--tokenizer_path", env["tok"], "--output_root", str(out_root),
         "--max_batch", "2", "--linger_s", "5"],
        cwd=REPO, env=env_vars, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    # a server that never comes up must not hold the suite
    watchdog = threading.Timer(400, lambda: proc.kill())
    watchdog.start()
    req = {"image_path": env["image_path"], "camera_json": env["cams"],
           "height": ts.H, "width": ts.W, "num_frames": ts.FRAMES,
           "sample_steps": 2, "neg_prompt": ts.NEG}
    reqs = [{**req, "prompt": ts.PROMPT, "seed": 5},
            {**req, "prompt": "a valley", "seed": 9}]
    lines = []
    try:
        while True:
            line = proc.stdout.readline()
            assert line, (lines, proc.stderr.read())
            lines.append(line)
            m = re.search(r"serving on http://127.0.0.1:(\d+) .*pid=(\d+)",
                          line)
            if m:
                port, pid = int(m.group(1)), int(m.group(2))
                break
        assert "2 ranks (1x1x2 mesh)" in line
        ids = [_post(port, r)[0]["job_id"] for r in reqs]
        done = [_wait_done(port, i, timeout=300) for i in ids]
        assert [d["status"] for d in done] == ["done", "done"], done
    finally:
        if "pid" in locals():
            os.kill(pid, signal.SIGINT)
        out, err = proc.communicate(timeout=120)
        watchdog.cancel()
    out = "".join(lines) + out
    assert proc.returncode == 0, err[-3000:]
    assert "[serve] rank 0: stopped" in out
    # one batch of two jobs on the follower
    assert "[serve] rank 1: 1 batches, stopped" in out
    sampler = FantasyWorldSampler.from_checkpoint(
        tiny["wan"], tiny["model"], device="cpu", dtype=torch.float32,
        tokenizer_path=env["tok"])
    jobs = [Job(id=d["job_id"], request=r) for d, r in zip(done, reqs)]
    make_batch_fn(sampler, argparse.Namespace(
        segment_size=None, output_root=str(tmp_path / "one")))(jobs)
    for d in done:
        one, mesh = tmp_path / "one" / d["job_id"], out_root / d["job_id"]
        assert d["result"]["output_dir"] == str(mesh)
        assert sorted(os.listdir(one)) == sorted(os.listdir(mesh))
        for name in os.listdir(one):
            if name.endswith(".npy"):
                a, b = (np.load(p / name).astype(int) for p in (one, mesh))
                assert a.shape == b.shape and np.abs(a - b).max() <= 1
        from test_torch_multigpu import PRED_TOL, _ply
        (ha, a), (hb, b) = (_ply(p / "recon_confthresh1.0.ply")
                            for p in (one, mesh))
        assert ha == hb
        np.testing.assert_allclose(b["xyz"], a["xyz"], rtol=PRED_TOL,
                                   atol=PRED_TOL)
