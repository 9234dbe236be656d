"""The port's serving path (tmdiff_tpu_torch/serve) on the CPU: every engine,
HTTP and preset case of tests/test_serve.py run against the port's engine,
on a Pansharpener filled from the same flax params as the JAX suite's
`shared_sharp` (channels (4, 8, 8, 16), 4 bands, 16x16, T = 10), plus the
entry point's own contracts: its argv overlay and sampler settings against
the JAX functions, the /v1/stats schema against the JAX server's, the
device default, the refusals, a bf16 EMA checkpoint served end to end, and
serve_controlnet.json's controlled model answering a request with a hint
and a task over HTTP.
"""
import argparse
import io
import json
import os
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from tmdiff_tpu.serve import InferenceEngine as JaxInferenceEngine
from tmdiff_tpu.serve import make_server as jax_make_server
from tmdiff_tpu.serve.__main__ import apply_serve_defaults as jax_apply_serve_defaults
from tmdiff_tpu.serve.__main__ import build_sampler_kw as jax_build_sampler_kw
from tmdiff_tpu_torch.config import parse_config
from tmdiff_tpu_torch.models.wavbest import WavBEST
from tmdiff_tpu_torch.pipeline import Pansharpener
from tmdiff_tpu_torch.serve import InferenceEngine, make_server, serve_forever_in_thread
from tmdiff_tpu_torch.serve import __main__ as serve_main
from tmdiff_tpu_torch.serve.engine import EngineOverloaded
from tmdiff_tpu_torch.utils.weights import from_flax

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRESETS = os.path.join(REPO, "tmdiff_tpu_torch", "config", "presets")
CHANNELS = (4, 8, 8, 16)


@pytest.fixture(scope="module")
def sharp(shared_sharp):
    """The port's Pansharpener on the JAX suite's shared weights."""
    model = from_flax(WavBEST(CHANNELS, device="cpu"),
                      jax.tree.map(np.asarray, shared_sharp.params))
    return Pansharpener(model, n_timestep=10, device="cpu")


def _image(seed, bands=4, size=16):
    rng = np.random.default_rng(seed)
    return (rng.random((1, size, size), np.float32),
            rng.random((bands, size, size), np.float32))


def _in_unit_range(out):
    return np.isfinite(out).all() and out.min() >= 0 and out.max() <= 1


@pytest.fixture
def engine_of(sharp):
    """engine_of(**kw): a port engine on `sharp`, shut down after the test."""
    made = []

    def make(**kw):
        made.append(InferenceEngine(kw.pop("sharp", sharp), **kw))
        return made[-1]

    yield make
    for e in made:
        e.shutdown()


def test_engine_batches_concurrent_requests(sharp, engine_of):
    """Four concurrent requests ride one batch of 4 with no padding, and
    each slot equals the direct sampler output for the stacked batch at the
    same seed (atol 1e-6)."""
    engine = engine_of(method="regression", max_batch=4, max_delay_ms=200.0)
    pans, mss = zip(*[_image(i) for i in range(4)])
    futs = [engine.submit(p, m, "QB") for p, m in zip(pans, mss)]
    outs = [f.result(timeout=120) for f in futs]
    for ms, out in zip(mss, outs):
        assert out.shape == ms.shape and _in_unit_range(out)
    assert engine.stats["batches"] == 1
    assert engine.stats["batch_size_hist"] == {4: 1}
    assert engine.stats["padded_slots"] == 0
    assert [f.placement for f in futs] == [{"seed": 0, "bucket": 4, "row": i} for i in range(4)]
    direct = sharp.sample({"PAN": np.stack(pans), "MS": np.stack(mss)}, sensor="QB",
                          method="regression", seed=0)
    np.testing.assert_allclose(np.stack(outs), direct, atol=1e-6)


@pytest.mark.parametrize("method,steps,sampler_kw", [
    ("ddim", 2, None),  # a distilled few-NFE deployment is an engine setting
    ("ddim_cached", 4, {"refresh_every": 2, "cache_level": 3, "forecast": True}),
    ("ddim_cached", 4, {"cache_level": 3, "refresh_mask": (True, False, False, True),
                        "refresh_mask_static": True}),  # a searched schedule
], ids=["distilled-ddim", "ddim_cached-sampler_kw", "searched-refresh-mask"])
def test_engine_serves_method_settings(sharp, engine_of, method, steps, sampler_kw):
    """`steps` and `sampler_kw` go to Pansharpener.sample as given: the
    engine's image equals the direct call's at seed 0 (atol 1e-6)."""
    engine = engine_of(method=method, steps=steps, max_batch=1, max_delay_ms=50.0,
                       sampler_kw=sampler_kw)
    pan, ms = _image(0)
    out = engine.submit(pan, ms, "QB").result(timeout=120)
    assert out.shape == ms.shape and _in_unit_range(out)
    direct = sharp.sample({"PAN": pan[None], "MS": ms[None]}, sensor="QB", method=method,
                          steps=steps, seed=0, **(sampler_kw or {}))
    np.testing.assert_allclose(out, direct[0], atol=1e-6)


def test_engine_cobatches_mixed_guidance(sharp, engine_of):
    """Requests at different CFG scales ride one batch as a (B,) guidance
    vector; each row equals the direct run with that vector (atol 1e-6)."""
    engine = engine_of(method="dpm++_cfg", steps=4, max_batch=2, max_delay_ms=200.0)
    (p0, m0), (p1, m1) = _image(0), _image(1)
    f0 = engine.submit(p0, m0, "QB", guidance=1.5)
    f1 = engine.submit(p1, m1, "QB", guidance=2.5)
    out = [f.result(timeout=120) for f in (f0, f1)]
    assert engine.stats["batches"] == 1
    direct = sharp.sample({"PAN": np.stack([p0, p1]), "MS": np.stack([m0, m1])}, sensor="QB",
                          method="dpm++_cfg", steps=4, seed=0,
                          guidance=np.array([1.5, 2.5], np.float32))
    np.testing.assert_allclose(out[0], direct[0], atol=1e-6)
    np.testing.assert_allclose(out[1], direct[1], atol=1e-6)


def test_engine_pads_to_bucket_and_mixes_groups(engine_of):
    """Three co-batchable requests and one of another shape: two batches,
    the group of three padded to the bucket of 4 by repeating its last."""
    engine = engine_of(method="regression", max_batch=4, max_delay_ms=150.0)
    p16, m16 = _image(0)
    p8, m8 = _image(1, size=8)
    futs = [engine.submit(p16, m16, "QB"), engine.submit(p8, m8, "QB"),
            engine.submit(p16, m16, "QB"), engine.submit(p16, m16, "QB")]
    outs = [f.result(timeout=120) for f in futs]
    assert outs[0].shape == m16.shape and outs[1].shape == m8.shape
    assert engine.stats["requests"] == 4 and engine.stats["batches"] == 2
    assert engine.stats["padded_slots"] == 1
    assert futs[3].placement == {"seed": 0, "bucket": 4, "row": 2}
    assert futs[1].placement == {"seed": 1, "bucket": 1, "row": 0}
    assert all(_in_unit_range(o) for o in outs)


def test_mixed_sensor_batch_conditions_per_sample(sharp):
    """A list of sensors conditions each row on its own prompt: with a fixed
    x_init, row 0 is bit for bit the same across calls and row 1 changes
    with its sensor."""
    pan, ms = _image(11)
    batch = {"PAN": np.stack([pan, pan]), "MS": np.stack([ms, ms])}
    x_init = np.random.default_rng(5).standard_normal(batch["MS"].shape).astype(np.float32)
    same = sharp.sample(batch, sensor=["QB", "QB"], method="dpm++", steps=4, x_init=x_init)
    mixed = sharp.sample(batch, sensor=["QB", "WV3"], method="dpm++", steps=4, x_init=x_init)
    np.testing.assert_array_equal(same[0], mixed[0])
    assert not np.array_equal(same[1], mixed[1])


def test_engine_coalesces_mixed_sensors(engine_of):
    engine = engine_of(method="regression", max_batch=4, max_delay_ms=200.0)
    futs = [engine.submit(*_image(i), sensor)
            for i, sensor in enumerate(["QB", "WV3", "GF2", "WV2"])]
    outs = [f.result(timeout=120) for f in futs]
    assert engine.stats["batches"] == 1
    assert all(np.isfinite(o).all() for o in outs)


def test_engine_error_propagates_without_killing_worker(engine_of):
    engine = engine_of(method="regression", max_batch=2, max_delay_ms=5.0)
    with pytest.raises(ValueError, match="one image per request"):
        engine.submit(np.zeros((2, 1, 16, 16)), np.zeros((4, 16, 16)))
    with pytest.raises(ValueError, match="spatial dims"):
        engine.submit(np.zeros((1, 16, 16)), np.zeros((3, 15, 15)))
    with pytest.raises(ValueError, match="dpm\\+\\+_cfg"):
        engine.submit(*_image(2), "QB", guidance=2.0)
    # passes the checks, fails in the sampler (15 is not a multiple of 8)
    bad = engine.submit(np.zeros((1, 15, 15)), np.zeros((3, 15, 15)))
    with pytest.raises(ValueError, match="divisible by 8"):
        bad.result(timeout=120)
    p, m = _image(3)
    assert engine.submit(p, m, "QB").result(timeout=120).shape == m.shape


class SlowSharp:
    """A sampler stand-in that stalls until released, and counts calls."""

    def __init__(self):
        self.release = threading.Event()
        self.calls = 0

    def sample(self, batch, sensor, method, steps, seed, **kw):
        self.release.wait(30)
        self.calls += 1
        return np.zeros_like(batch["MS"])


def test_engine_backpressure(engine_of):
    """Submits beyond max_queue raise EngineOverloaded while the work in
    flight completes."""
    slow = SlowSharp()
    engine = engine_of(sharp=slow, method="regression", max_batch=1, max_delay_ms=1.0,
                       max_queue=2)
    try:
        pan, ms = _image(0)
        first = engine.submit(pan, ms)
        time.sleep(0.3)  # the worker takes it and stalls
        backlog = [engine.submit(pan, ms) for _ in range(2)]
        with pytest.raises(EngineOverloaded):
            engine.submit(pan, ms)
        assert engine.stats["rejected"] == 1
        slow.release.set()
        assert first.result(timeout=60).shape == ms.shape
        for f in backlog:
            f.result(timeout=60)
    finally:
        slow.release.set()


def test_engine_shutdown_fails_leftovers():
    """shutdown() runs the group being collected and fails the requests of
    another shape that wait behind it."""
    slow = SlowSharp()
    slow.release.set()
    engine = InferenceEngine(slow, method="regression", max_batch=4, max_delay_ms=2000.0)
    a = engine.submit(*_image(0))
    b = engine.submit(*_image(1, size=8))
    time.sleep(0.2)
    engine.shutdown()
    assert a.result(timeout=10).shape == (4, 16, 16)
    with pytest.raises(RuntimeError, match="shut down"):
        b.result(timeout=10)


def _post(base, **arrays):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    req = urllib.request.Request(f"{base}/v1/pansharpen", data=buf.getvalue(), method="POST",
                                 headers={"Content-Type": "application/octet-stream"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return np.load(io.BytesIO(r.read()))


def _get(base, path):
    with urllib.request.urlopen(f"{base}{path}", timeout=30) as r:
        return json.load(r)


@pytest.fixture
def served():
    """served(engine) -> base URL of an HTTP server on it, closed after."""
    servers = []

    def start(engine):
        server = make_server(engine, "127.0.0.1", 0)
        serve_forever_in_thread(server)
        servers.append(server)
        return f"http://127.0.0.1:{server.server_address[1]}"

    yield start
    for s in servers:
        s.shutdown()
        s.server_close()


def test_http_server_round_trip(sharp, engine_of, served):
    """healthz, a request (its placement reproduces it), stats, and 400 for
    a malformed body and for guidance on a non-CFG engine."""
    engine = engine_of(method="regression", max_batch=2, max_delay_ms=5.0)
    base = served(engine)
    assert _get(base, "/healthz") == {"ok": True}
    pan, ms = _image(7)
    reply = _post(base, pan=pan, ms=ms, sensor="QB")
    out = reply["sr"]
    assert out.shape == ms.shape and _in_unit_range(out)
    assert (int(reply["seed"]), int(reply["bucket"]), int(reply["row"])) == (0, 1, 0)
    direct = sharp.sample({"PAN": pan[None], "MS": ms[None]}, sensor="QB",
                          method="regression", seed=0)
    np.testing.assert_allclose(out, direct[0], atol=1e-6)
    stats = _get(base, "/v1/stats")
    assert stats["requests"] == 1 and stats["batches"] == 1
    req = urllib.request.Request(f"{base}/v1/pansharpen", data=b"not-an-npz", method="POST")
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=30)
    assert ei.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(base, pan=pan, ms=ms, sensor="QB", guidance=np.float32(2.0))
    assert ei.value.code == 400
    assert "dpm++_cfg" in json.loads(ei.value.read())["error"]


def test_http_overload_is_503_with_retry_after(engine_of, served):
    slow = SlowSharp()
    engine = engine_of(sharp=slow, method="regression", max_batch=1, max_delay_ms=1.0,
                       max_queue=0)
    base = served(engine)
    pan, ms = _image(0)
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(base, pan=pan, ms=ms)
    assert ei.value.code == 503 and ei.value.headers["Retry-After"] == "1"
    assert _get(base, "/v1/stats")["rejected"] == 1
    slow.release.set()


def test_stats_schema_equals_the_jax_server(served):
    """/v1/stats of the port's server and of the JAX package's, each on an
    engine with the same stand-in sampler after the same two requests:
    the same keys and the same counts, but the port's `task_groups` (the
    distinct tasks of its batches, 0 for requests without tasks), which
    the JAX package's engine does not count."""
    results = []
    for engine_cls, server_fn in ((InferenceEngine, make_server),
                                  (JaxInferenceEngine, jax_make_server)):
        slow = SlowSharp()
        slow.release.set()
        engine = engine_cls(slow, method="regression", max_batch=2, max_delay_ms=300.0)
        server = server_fn(engine, "127.0.0.1", 0)
        serve_forever_in_thread(server)
        base = f"http://127.0.0.1:{server.server_address[1]}"
        try:
            before = _get(base, "/v1/stats")
            threads = [threading.Thread(target=_post, args=(base,),
                                        kwargs=dict(zip(("pan", "ms"), _image(i))))
                       for i in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            after = _get(base, "/v1/stats")
        finally:
            server.shutdown()
            server.server_close()
            engine.shutdown()
        after.pop("mean_latency_ms")
        results.append((before, after))
    (port_before, port_after), (jax_before, jax_after) = results
    assert port_before.pop("task_groups") == port_after.pop("task_groups") == 0
    assert port_before.keys() == jax_before.keys() and port_before == jax_before
    assert port_after == jax_after == {"requests": 2, "batches": 1, "padded_slots": 0,
                                       "batch_size_hist": {"2": 1}, "rejected": 0}


# -- the entry point: presets, argv, sampler settings --------------------------


def _preset(name):
    return parse_config(os.path.join(PRESETS, name), phase="val", make_dirs=False)


def test_serve_preset_supplies_deployment_defaults():
    """serve_lowlatency.json's "serve" block becomes the flags' defaults
    (ddim 1 step, bf16, EMA, 5 ms, 4-band warm-up); explicit flags win."""
    opt = _preset("serve_lowlatency.json")
    assert int(opt["serve_bands"]) == 4
    p = serve_main.build_parser()
    argv = ["-c", "x", "--ckpt", "y"]
    args = p.parse_args(argv)
    serve_main.apply_serve_defaults(args, opt, p, argv)
    assert (args.sampler, args.steps) == ("ddim", 1)
    assert args.bf16 and args.use_ema
    assert args.max_delay_ms == 5.0 and args.warmup == "4,256,256"
    argv = ["-c", "x", "--ckpt", "y", "--sampler", "dpm++", "--steps", "20"]
    args = p.parse_args(argv)
    serve_main.apply_serve_defaults(args, opt, p, argv)
    assert (args.sampler, args.steps) == ("dpm++", 20) and args.bf16


def test_serve_quality_preset_supplies_cached_sampler():
    """serve_quality.json deploys ddim_cached, 20 steps, level 3, r = 2,
    forecast off, bf16, EMA, 8-band warm-up."""
    opt = _preset("serve_quality.json")
    assert int(opt["serve_bands"]) == 8
    p = serve_main.build_parser()
    argv = ["-c", "x", "--ckpt", "y"]
    args = p.parse_args(argv)
    serve_main.apply_serve_defaults(args, opt, p, argv)
    assert (args.sampler, args.steps) == ("ddim_cached", 20)
    assert (args.refresh_every, args.cache_level, args.forecast) == (2, 3, False)
    assert args.bf16 and args.use_ema and args.warmup == "8,256,256"
    assert serve_main.build_sampler_kw(args, p, argv) == {
        "refresh_every": 2, "cache_level": 3, "forecast": False}


def test_serve_preset_overlay_hardening():
    """Prefix abbreviations count as explicit flags, --no- forms beat a
    preset that enables a boolean, and preset values are checked by the
    action's type and choices like command-line tokens."""

    def mkparser():
        p = argparse.ArgumentParser()
        p.add_argument("--sampler", default="dpm++", choices=["dpm++", "ddim", "dpm++_cfg"])
        p.add_argument("--steps", type=int, default=None)
        p.add_argument("--bf16", action=argparse.BooleanOptionalAction, default=False)
        p.add_argument("--use-ema", action=argparse.BooleanOptionalAction, default=False)
        return p

    opt = {"serve": {"sampler": "ddim", "steps": 1, "bf16": True, "use_ema": True}}
    p = mkparser()
    args = p.parse_args(["--step", "20"])
    serve_main.apply_serve_defaults(args, opt, p, ["--step", "20"])
    assert args.steps == 20 and args.sampler == "ddim"
    p = mkparser()
    args = p.parse_args(["--no-bf16"])
    serve_main.apply_serve_defaults(args, opt, p, ["--no-bf16"])
    assert args.bf16 is False and args.use_ema is True
    p = mkparser()
    args = p.parse_args([])
    serve_main.apply_serve_defaults(args, {"serve": {"steps": "20"}}, p, [])
    assert args.steps == 20 and isinstance(args.steps, int)
    for bad in ({"steps": "twenty"}, {"sampler": "dimm"}, {"steps": True}):
        p = mkparser()
        args = p.parse_args([])
        with pytest.raises(SystemExit):
            serve_main.apply_serve_defaults(args, {"serve": bad}, p, [])


def test_build_sampler_kw_refresh_mask():
    """--refresh-mask parses a 0/1 (or comma'd) string into the engine's
    tuple with refresh_mask_static; malformed masks, length or leading-1
    violations, the forecast conflict and caching flags on another sampler
    all stop at start-up."""
    p = argparse.ArgumentParser()

    def ns(**over):
        base = dict(sampler="ddim_cached", steps=4, refresh_every=4, cache_level=3,
                    forecast=False, refresh_mask=None)
        base.update(over)
        return argparse.Namespace(**base)

    kw = serve_main.build_sampler_kw(ns(refresh_mask="1001"), p, [])
    assert kw["refresh_mask"] == (True, False, False, True) and kw["refresh_mask_static"] is True
    assert serve_main.build_sampler_kw(ns(refresh_mask="1,0,0,1"), p, [])["refresh_mask"] == (
        True, False, False, True)
    kw = serve_main.build_sampler_kw(ns(), p, [])
    assert "refresh_mask" not in kw and kw["refresh_every"] == 4
    for bad in (dict(refresh_mask="10x1"), dict(refresh_mask=""), dict(refresh_mask="10"),
                dict(refresh_mask="0110"), dict(refresh_mask="1001", forecast=True)):
        with pytest.raises(SystemExit):
            serve_main.build_sampler_kw(ns(**bad), p, [])
    with pytest.raises(SystemExit):
        serve_main.build_sampler_kw(ns(sampler="dpm++"), p, ["--refresh-mask=1001"])
    assert serve_main.build_sampler_kw(ns(sampler="dpm++"), p, []) is None


ARGV_CASES = [
    [],
    ["--steps", "8"],
    ["--step", "8"],                      # a prefix of --steps counts as explicit
    ["--no-bf16"],
    ["--no-use-ema", "--max-delay-ms", "2"],
    ["--sampler", "ddim", "--steps", "3"],
    ["--sampler", "ddim_cached", "--steps", "4", "--refresh-mask", "1,0,1,0"],
    ["--cache-level", "1", "--forecast"],
    ["--refresh-every=5"],
    ["--sampler=dpm++_cfg", "--guidance", "1.5"],
]


@pytest.mark.parametrize("preset", ["serve_quality.json", "serve_lowlatency.json"])
@pytest.mark.parametrize("extra", ARGV_CASES, ids=[" ".join(a) or "none" for a in ARGV_CASES])
def test_argv_semantics_equal_jax(preset, extra):
    """The port's apply_serve_defaults and build_sampler_kw give the JAX
    functions' args and sampler settings (or the same refusal) for each
    preset and argv, on the entry point's own parser."""
    opt = _preset(preset)
    argv = ["-c", os.path.join(PRESETS, preset), "--ckpt", "ckpt"] + extra
    outcome = []
    for overlay, kw_fn in ((serve_main.apply_serve_defaults, serve_main.build_sampler_kw),
                           (jax_apply_serve_defaults, jax_build_sampler_kw)):
        p = serve_main.build_parser()
        args = p.parse_args(argv)
        try:
            overlay(args, opt, p, argv)
            kw = kw_fn(args, p, argv)
        except SystemExit as e:
            outcome.append(("refused", e.code))
            continue
        outcome.append((vars(args), kw))
    assert outcome[0] == outcome[1]


# -- the entry point: device, refusals, a checkpoint served end to end ---------


def _config(tmp_path, **serve):
    cfg = {"name": "serve_test", "path": {"checkpoint": "checkpoint"},
           "model": {"beta_schedule": {"val": {"schedule": "cosine", "n_timestep": 10}},
                     "unet": {"channel_multiplier": list(CHANNELS)}},
           "serve": serve}
    path = tmp_path / "serve.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def test_device_defaults_to_cuda(tmp_path, monkeypatch):
    """Without --device the server asks for CUDA and, with no GPU, raises
    rather than serving on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args, opt, kw = serve_main.prepare(["-c", _config(tmp_path), "--ckpt", str(tmp_path)])
    assert args.device is None
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_main.build_engine(args, opt, kw)


def test_mesh_space_and_orbax_are_refused(tmp_path, monkeypatch, capsys):
    """--mesh-space above 1 in one process stops at start-up, naming
    torchrun (a mesh spans the ranks of a torchrun world; the meshed server
    is tests/test_torch_serve_mesh.py's); a JAX orbax checkpoint directory
    raises when it is loaded."""
    cfg = _config(tmp_path)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(SystemExit):
        serve_main.prepare(["-c", cfg, "--ckpt", "x", "--mesh-space", "2"])
    assert "start the server under torchrun" in capsys.readouterr().err
    orbax = tmp_path / "checkpoint" / "I5"
    (orbax / "default").mkdir(parents=True)
    (orbax / "_CHECKPOINT_METADATA").write_text("{}")
    for ckpt in (orbax, orbax.parent):
        args, opt, kw = serve_main.prepare(["-c", cfg, "--ckpt", str(ckpt), "--device", "cpu"])
        with pytest.raises(ValueError, match="orbax"):
            serve_main.build_engine(args, opt, kw)


def test_serves_a_bf16_ema_checkpoint_end_to_end(tmp_path, served):
    """A port checkpoint with distinct online and EMA weights, served with
    --bf16 --use-ema on the CPU: the reply equals a direct request on a bf16
    model holding the EMA weights, at the reply's placement; --no-use-ema
    serves the online weights."""
    from tmdiff_tpu_torch.diffusion.schedules import NoiseSchedule
    from tmdiff_tpu_torch.train import checkpoint as ckpt_lib
    from tmdiff_tpu_torch.train.trainer import Trainer

    model = WavBEST(CHANNELS, device="cpu", seed=3)
    state = Trainer(model, NoiseSchedule.create("cosine", 10)).init_state()
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for e in state.ema_params:
            e.add_(0.05 * torch.randn(e.shape, generator=gen))
    state.step = 7
    root = str(tmp_path / "checkpoint")
    ckpt_lib.save_checkpoint(root, state)
    cfg = _config(tmp_path, sampler="ddim", steps=2, bf16=True, use_ema=True, max_delay_ms=1.0)
    pan, ms = _image(4)
    for use_ema, ckpt in ((True, root), (False, os.path.join(root, "I7"))):
        argv = (["-c", cfg, "--ckpt", ckpt, "--device", "cpu"]
                + ([] if use_ema else ["--no-use-ema"]))
        args, opt, kw = serve_main.prepare(argv)
        engine = serve_main.build_engine(args, opt, kw)
        try:
            assert engine.sharp.model.dtype == torch.bfloat16 and engine.method == "ddim"
            reply = _post(served(engine), pan=pan, ms=ms, sensor="GF2")
        finally:
            engine.shutdown()
        ref_model = WavBEST(CHANNELS, device="cpu", dtype=torch.bfloat16)
        with torch.no_grad():
            weights = state.ema_params if use_ema else list(model.parameters())
            for p, w in zip(ref_model.parameters(), weights):
                p.copy_(w)
        b, row = int(reply["bucket"]), int(reply["row"])
        direct = Pansharpener(ref_model, n_timestep=10, device="cpu").sample(
            {"PAN": np.stack([pan] * b), "MS": np.stack([ms] * b)}, sensor=["GF2"] * b,
            method="ddim", steps=2, seed=int(reply["seed"]))
        np.testing.assert_array_equal(reply["sr"], direct[row])


def test_serves_the_controlnet_preset_with_a_hint_and_a_task(tmp_path, served):
    """serve_controlnet.json at small widths (channel_multiplier (8, 8, 16,
    16), a 2-step ddim, no warm-up), a port checkpoint of a
    ControlledLegacyUNet: the engine holds the controlled bf16 model, a
    request with a `hint` and a `task` is answered with the image a direct
    request gives at its placement, and a request without them is a 400."""
    from tmdiff_tpu_torch.config.config import load_commented_json
    from tmdiff_tpu_torch.diffusion.schedules import NoiseSchedule
    from tmdiff_tpu_torch.models.controlnet import ControlledLegacyUNet
    from tmdiff_tpu_torch.train import checkpoint as ckpt_lib
    from tmdiff_tpu_torch.train.trainer import Trainer

    small = (8, 8, 16, 16)
    model = ControlledLegacyUNet(small, device="cpu", seed=5)
    state = Trainer(model, NoiseSchedule.create("cosine", 10)).init_state()
    root = str(tmp_path / "checkpoint")
    ckpt_lib.save_checkpoint(root, state)
    cfg = load_commented_json(os.path.join(PRESETS, "serve_controlnet.json"))
    cfg["model"]["unet"]["channel_multiplier"] = list(small)
    cfg["model"]["beta_schedule"]["val"]["n_timestep"] = 10
    cfg["serve"].update(steps=2, warmup=None, max_delay_ms=1.0)
    path = tmp_path / "serve_controlnet.json"
    path.write_text(json.dumps(cfg))
    args, opt, kw = serve_main.prepare(["-c", str(path), "--ckpt", root, "--device", "cpu"])
    engine = serve_main.build_engine(args, opt, kw)
    pan, ms = _image(6, bands=8)
    hint = np.random.default_rng(6).random((16, 16, 3), np.float32)
    try:
        sharp = engine.sharp
        assert isinstance(sharp.model, ControlledLegacyUNet)
        assert sharp.model.dtype == torch.bfloat16 and engine.method == "ddim"
        base = served(engine)
        reply = _post(base, pan=pan, ms=ms, sensor="WV3", hint=hint, task="control_depth")
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base, pan=pan, ms=ms, sensor="WV3")
        assert ei.value.code == 400 and "hint" in json.loads(ei.value.read())["error"]
    finally:
        engine.shutdown()
    b, row = int(reply["bucket"]), int(reply["row"])
    direct = sharp.sample({"PAN": np.stack([pan] * b), "MS": np.stack([ms] * b),
                           "HINT": np.stack([hint] * b), "TASK": np.full(b, 3)},
                          sensor=["WV3"] * b, method="ddim", steps=2, seed=int(reply["seed"]))
    np.testing.assert_array_equal(reply["sr"], direct[row])
