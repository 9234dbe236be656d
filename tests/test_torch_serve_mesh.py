"""Serving over a ("data", "space") mesh (tmdiff_tpu_torch/serve/mesh.py and
`python -m tmdiff_tpu_torch.serve` under torchrun) on the CPU.

Worlds of 2 and 4 gloo ranks spawned by parallel/dryrun.py run
tests/torch_mesh_workers.py::serve: the unchanged InferenceEngine on a
MeshLeader at rank 0, `follow` on every other rank. Each world serves 8
concurrent requests of mixed sensors and shapes (4 and 8 bands, 16x16,
max_batch 4), then one more alone (a bucket of 1, below a data axis of 2:
the replication fallback), with `dpm++` (4 steps) and `ddim_cached`, on
(2, 1), (1, 2) and (2, 2), and `ddim_cached` on a bf16 model on (1, 2) and
(2, 2) (the bf16 halo exchange and gather); and the JAX engine test
`tests/test_sharded_sampling.py::test_engine_on_meshed_sampler` on (4, 1).
Each served image is held against the one-process port at its placement
(seed, bucket, row), its batch rebuilt from the placements, to MESH_RTOL of
its scale; every follower ran as many batches as rank 0.

Then the entry point itself under torchrun on two CPU ranks with
`--mesh-space 2`: HTTP replies against their one-process replays, /v1/stats
against the JAX server's keys, and SIGINT to every rank (as torchrun
forwards a terminal's): each prints its launch line and exits 0, so
torchrun does too, within STOP_TIMEOUT. And the two refusals.
Widths (8, 16, 32, 64), T = 10.
"""
import io
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from tmdiff_tpu.serve import InferenceEngine as JaxInferenceEngine
from tmdiff_tpu.serve import make_server as jax_make_server
from tmdiff_tpu_torch.diffusion.schedules import NoiseSchedule
from tmdiff_tpu_torch.models.wavbest import WavBEST
from tmdiff_tpu_torch.parallel.dryrun import run_world
from tmdiff_tpu_torch.pipeline import Pansharpener
from tmdiff_tpu_torch.serve import __main__ as serve_main
from tmdiff_tpu_torch.serve import serve_forever_in_thread
from tmdiff_tpu_torch.train import checkpoint as ckpt_lib
from tmdiff_tpu_torch.train.trainer import Trainer

torch.set_num_threads(2)

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)
CHANNELS = (8, 16, 32, 64)
N_TIMESTEP = 10
# a served image against its one-process replay, of the image's scale: the
# same arithmetic on row and batch shards (meshed sampling measures 0 here)
MESH_RTOL = 1e-5
STOP_TIMEOUT = 60.0
SAMPLERS = {"dpm++": dict(method="dpm++", steps=4),
            "ddim_cached": dict(method="ddim_cached", steps=4,
                                sampler_kw={"refresh_every": 2, "cache_level": 2})}
ENGINE = dict(max_batch=4, max_delay_ms=150.0)
SENSORS = (("QB", 4), ("WV3", 8), ("GF2", 4), ("WV2", 8))


def _request(rng, sensor, bands, size=16):
    ms = rng.uniform(0.1, 0.9, (bands, size, size)).astype(np.float32)
    pan = (ms.mean(0, keepdims=True)
           + 0.05 * rng.standard_normal((1, size, size))).astype(np.float32)
    return pan, ms, sensor


def _waves(seed=0):
    """8 concurrent requests of mixed sensors (two shapes), then one alone."""
    rng = np.random.default_rng(seed)
    first = [_request(rng, *SENSORS[i % 4]) for i in range(8)]
    return [first, [_request(rng, "GF2", 4)]]


@pytest.fixture(scope="module")
def weights():
    model = WavBEST(CHANNELS, device="cpu", seed=7)
    return {k: v.numpy() for k, v in model.state_dict().items()}


def _serve_task(mesh, sampler, dtype="float32", waves=None, engine=ENGINE):
    kw = dict(SAMPLERS[sampler])
    engine_kw = dict(engine, method=kw.pop("method"), steps=kw.pop("steps"),
                     sampler_kw=kw.pop("sampler_kw", None))
    return engine_kw, ("serve", (mesh, None, CHANNELS, dtype, waves or _waves(), engine_kw), {})


def _cases():
    """(world size, [(case label, engine kw, task)]) of both worlds."""
    two = [(m, s, "float32") for m in ((2, 1), (1, 2)) for s in SAMPLERS]
    two += [((1, 2), "ddim_cached", "bfloat16")]
    four = [((2, 2), s, "float32") for s in SAMPLERS] + [((2, 2), "ddim_cached", "bfloat16")]
    worlds = {}
    for n, cases in ((2, two), (4, four)):
        worlds[n] = [((m, s, d), *_serve_task(m, s, d)) for m, s, d in cases]
    # the JAX engine test on a meshed sampler: every rank on "data", 4 sensors, one batch
    rng = np.random.default_rng(0)
    wave = [(rng.random((1, 16, 16), np.float32), rng.random((4, 16, 16), np.float32), s)
            for s in ("QB", "WV3", "GF2", "WV2")]
    engine_kw = dict(method="regression", max_batch=4, max_delay_ms=200.0)
    worlds[4].append((((4, 1), "regression", "float32"), engine_kw,
                      ("serve", ((4, 1), None, CHANNELS, "float32", [wave], engine_kw), {})))
    return worlds


CASES = _cases()


@pytest.fixture(scope="module")
def worlds(weights):
    """Both worlds, started together: their results by case label."""
    def run(n):
        tasks = []
        for _, _, (name, args, kw) in CASES[n]:
            args = list(args)
            args[1] = weights
            tasks.append((name, tuple(args), kw))
        return run_world("torch_mesh_workers:run_all", n, (tasks,), sys_path=[TESTS],
                         threads=1, timeout=300)

    with ThreadPoolExecutor(2) as pool:
        futs = {n: pool.submit(run, n) for n in CASES}
        results = {n: f.result() for n, f in futs.items()}
    return {label: [ranks[i] for ranks in results[n]]
            for n in CASES for i, (label, _, _) in enumerate(CASES[n])}


def _replays(weights, dtype, engine_kw, waves, placements):
    """Each request's image from a one-process Pansharpener at its placement:
    every served batch rebuilt from the placements (its rows in order, the
    last repeated up to the bucket) and sampled once."""
    model = WavBEST(CHANNELS, device="cpu", dtype=getattr(torch, dtype))
    model.load_state_dict({k: torch.as_tensor(v) for k, v in weights.items()})
    sharp = Pansharpener(model, n_timestep=N_TIMESTEP, device="cpu")
    requests = [r for wave in waves for r in wave]
    batches = {}
    for req, pl in zip(requests, placements):
        batches.setdefault((pl["seed"], pl["bucket"]), {})[pl["row"]] = req
    out = {}
    for (seed, bucket), rows in batches.items():
        order = [rows[i] for i in range(len(rows))]
        order += [order[-1]] * (bucket - len(order))
        imgs = sharp.sample({"PAN": np.stack([r[0] for r in order]),
                             "MS": np.stack([r[1] for r in order])},
                            sensor=[r[2] for r in order], method=engine_kw["method"],
                            steps=engine_kw.get("steps"), seed=seed,
                            **(engine_kw.get("sampler_kw") or {}))
        out.update({(seed, row): imgs[row] for row in rows})
    return [out[(pl["seed"], pl["row"])] for pl in placements]


def _gap(a, b) -> float:
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("label", [label for n in CASES for label, _, _ in CASES[n]],
                         ids=lambda l: f"{l[0][0]}x{l[0][1]}-{l[1]}-{l[2]}")
def test_served_images_equal_their_replays(worlds, weights, label):
    """Every image the meshed engine served equals its one-process replay at
    its placement to MESH_RTOL of scale; the batching is the engine's (the
    8 requests in two full buckets of 4, one per shape, then a bucket of 1;
    the JAX engine case in one batch of 4); every rank ran each batch, and
    the followers saw one broadcast more (the stop)."""
    engine_kw = next(kw for n in CASES for lab, kw, _ in CASES[n] if lab == label)
    waves = next(t[1][4] for n in CASES for lab, _, t in CASES[n] if lab == label)
    ranks = worlds[label]
    lead = ranks[0]
    n_requests = sum(len(w) for w in waves)
    assert len(lead["images"]) == n_requests
    if label[1] == "regression":
        assert lead["engine"]["batches"] == 1 and lead["engine"]["batch_size_hist"] == {4: 1}
    else:
        assert lead["engine"]["batch_size_hist"] == {4: 2, 1: 1}
        assert sorted((p["seed"], p["bucket"]) for p in lead["placements"]) == (
            [(0, 4)] * 4 + [(1, 4)] * 4 + [(2, 1)])
    n_batches = lead["engine"]["batches"]
    for r in ranks:
        assert r["stats"] == {"broadcasts": n_batches + 1, "batches": n_batches,
                              "failed_batches": 0}
    replays = _replays(weights, label[2], engine_kw, waves, lead["placements"])
    for (pan, ms, sensor), img, ref in zip([r for w in waves for r in w], lead["images"],
                                           replays):
        assert img.shape == ms.shape and np.isfinite(img).all()
        assert _gap(img, ref) <= MESH_RTOL, (sensor, _gap(img, ref))


def test_a_failing_batch_resolves_its_futures_and_serving_goes_on():
    """A batch that fails alike on every rank (an MS height that the mesh
    shards but WavBEST's three halvings refuse) resolves its futures with
    the error on rank 0, and the next batch is served: the engine lives on,
    every rank counts one failed batch, and the world exits cleanly."""
    rng = np.random.default_rng(1)
    bad = [(rng.random((1, 20, 16), np.float32), rng.random((4, 20, 16), np.float32), "QB")]
    good = [_request(rng, "QB", 4)]
    weights = {k: v.numpy() for k, v in WavBEST(CHANNELS, device="cpu", seed=7)
               .state_dict().items()}
    engine_kw = dict(method="regression", max_batch=1, max_delay_ms=1.0)
    ranks = run_world("torch_mesh_workers:serve", 2,
                      ((2, 1), weights, CHANNELS, "float32", [bad, good], engine_kw),
                      sys_path=[TESTS], threads=1, timeout=120)
    lead = ranks[0]
    assert "divisible by 8" in lead["errors"][0] and lead["errors"][1] is None
    assert lead["images"][1].shape == (4, 16, 16)
    for r in ranks:
        assert r["stats"] == {"broadcasts": 3, "batches": 1, "failed_batches": 1}


# -- the entry point under torchrun ---------------------------------------------


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _post(base, **arrays):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    req = urllib.request.Request(f"{base}/v1/pansharpen", data=buf.getvalue(), method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return dict(np.load(io.BytesIO(r.read())))


def _get(base, path):
    with urllib.request.urlopen(f"{base}{path}", timeout=30) as r:
        return json.load(r)


def _children(pid):
    with open(f"/proc/{pid}/task/{pid}/children") as f:
        return [int(p) for p in f.read().split()]


class _ZeroSharp:
    """A stand-in sampler for the JAX engine: zeros of the MS shape."""

    def sample(self, batch, **kw):
        return np.zeros_like(np.asarray(batch["MS"]))


def _jax_stats_keys():
    engine = JaxInferenceEngine(_ZeroSharp(), method="regression", max_batch=2)
    server = jax_make_server(engine, "127.0.0.1", 0)
    serve_forever_in_thread(server)
    try:
        return set(_get(f"http://127.0.0.1:{server.server_address[1]}", "/v1/stats"))
    finally:
        server.shutdown()
        server.server_close()
        engine.shutdown()


def _config(tmp_path, **serve):
    cfg = {"name": "serve_mesh_test", "path": {"checkpoint": "checkpoint"},
           "model": {"beta_schedule": {"val": {"schedule": "cosine",
                                               "n_timestep": N_TIMESTEP}},
                     "unet": {"channel_multiplier": list(CHANNELS)}},
           "serve": serve}
    path = tmp_path / "serve.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def test_torchrun_serves_over_a_mesh_and_stops_on_sigint(tmp_path):
    """`python -m torch.distributed.run --nproc-per-node 2 -m
    tmdiff_tpu_torch.serve --device cpu --mesh-space 2` with a port
    checkpoint: rank 0 names the mesh, warms up, binds; three concurrent
    HTTP requests (two sensors) equal their one-process replays to
    MESH_RTOL of scale; /v1/stats has the JAX server's keys (and the port's
    `task_groups`) and counts the warm-up's and the requests; SIGINT to both
    ranks stops both with exit 0 within STOP_TIMEOUT, each printing its
    tagged launch line."""
    model = WavBEST(CHANNELS, device="cpu", seed=3)
    root = str(tmp_path / "checkpoint")
    ckpt_lib.save_checkpoint(root, Trainer(model, NoiseSchedule.create("cosine", N_TIMESTEP))
                             .init_state())
    cfg = _config(tmp_path, sampler="dpm++", steps=3, max_batch=2, max_delay_ms=100.0,
                  warmup="4,16,16")
    port = _free_port()
    log_path = tmp_path / "serve.log"
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
             "2", "-m", "tmdiff_tpu_torch.serve", "-c", cfg, "--ckpt", root, "--device", "cpu",
             "--mesh-space", "2", "--host", "127.0.0.1", "--port", str(port)],
            cwd=str(tmp_path), env=env, stdout=log, stderr=subprocess.STDOUT)
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 180
        while True:
            assert proc.poll() is None, log_path.read_text()[-3000:]
            assert time.monotonic() < deadline, "not healthy in time"
            try:
                if _get(base, "/healthz") == {"ok": True}:
                    break
            except (urllib.error.URLError, ConnectionError, OSError):
                time.sleep(0.3)
        rng = np.random.default_rng(5)
        reqs = [_request(rng, s, 4) for s in ("QB", "GF2", "QB")]
        with ThreadPoolExecutor(3) as pool:
            replies = list(pool.map(lambda r: _post(base, pan=r[0], ms=r[1], sensor=r[2]),
                                    reqs))
        stats = _get(base, "/v1/stats")
        workers = _children(proc.pid)
        assert len(workers) == 2
        for pid in workers:
            os.kill(pid, signal.SIGINT)
        t0 = time.monotonic()
        code = proc.wait(timeout=STOP_TIMEOUT)
        stop_s = time.monotonic() - t0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    out = log_path.read_text()
    assert code == 0, out[-3000:]
    assert stop_s < STOP_TIMEOUT
    assert "serving over SPMD mesh {'data': 1, 'space': 2}" in out
    lines = [json.loads(l[l.index("{"):]) for l in out.splitlines() if '{"kernel_launches"' in l]
    assert sorted(l["rank"] for l in lines) == [0, 1]
    assert all(l["mesh"]["failed_batches"] == 0 for l in lines)
    assert len({l["mesh"]["batches"] for l in lines}) == 1
    # the JAX server's keys, and the port's count of distinct tasks a batch
    # (0: these requests carry no task)
    assert set(stats) == _jax_stats_keys() | {"task_groups"} and stats["task_groups"] == 0
    assert stats["requests"] == 3 + 3  # the warm-up's buckets of 1 and 2, then the requests
    placements = [{k: int(r[k]) for k in ("seed", "bucket", "row")} for r in replies]
    replays = _replays({k: v.numpy() for k, v in model.state_dict().items()}, "float32",
                       dict(method="dpm++", steps=3), [reqs], placements)
    for reply, ref in zip(replies, replays):
        assert _gap(reply["sr"], ref) <= MESH_RTOL


def test_mesh_space_refusals(tmp_path, monkeypatch, capsys):
    """--mesh-space above 1 in one process is refused naming torchrun; a
    space that does not divide the world is refused; one that divides it
    passes."""
    cfg = _config(tmp_path)
    argv = ["-c", cfg, "--ckpt", "x", "--device", "cpu", "--mesh-space", "2"]
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(SystemExit):
        serve_main.prepare(argv)
    assert "torchrun" in capsys.readouterr().err
    monkeypatch.setenv("WORLD_SIZE", "3")
    with pytest.raises(SystemExit):
        serve_main.prepare(argv)
    assert "does not divide the world of 3 ranks" in capsys.readouterr().err
    monkeypatch.setenv("WORLD_SIZE", "4")
    args, _, _ = serve_main.prepare(argv)
    assert args.mesh_space == 2
