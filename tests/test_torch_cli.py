"""The port's CLI (tmdiff_tpu_torch/cli.py) end to end on the CPU
(`--device cpu`), on synthetic h5 files, at widths (4, 8, 8, 16) and
16x16: the JAX package's tests/test_cli.py cases (train with validation,
.mat artifacts and a final checkpoint off the validation boundary; val from
a checkpoint; SIGTERM with a checkpoint, then `path.resume: "auto"`), the
reference `.pth` as a resume point, -p val with every --sampler choice, the
refusals, and one run of the same config through both CLIs side by side
(-p distill: tests/test_torch_distill.py)."""
import json
import os
import re
import signal
import threading
import time

import numpy as np
import pytest
import scipy.io as scio
import torch

from tmdiff_tpu_torch import cli
from tmdiff_tpu_torch.data.synthetic import write_h5
from tmdiff_tpu_torch.models.clip_text import clip_mode
from tmdiff_tpu_torch.train import checkpoint as ckpt_lib

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    paths = {}
    for i, sensor in enumerate(["qb", "gf2", "wv3"]):
        scale = 1023.0 if sensor == "gf2" else 2047.0
        paths[f"train_{sensor}"] = write_h5(str(root / f"train_{sensor}_data.h5"), n=6, bands=4,
                                            size=16, seed=i, img_scale=scale)
        paths[f"val_{sensor}"] = write_h5(str(root / f"test_{sensor}_data_RR.h5"), n=2, bands=4,
                                          size=16, seed=10 + i, img_scale=scale)
    cfg = {
        "name": "smoke",
        "path": {"log": "logs", "results": "results", "checkpoint": "checkpoint",
                 "resume": None},
        "datasets": {
            **{f"train_{s}": {"dataroot": paths[f"train_{s}"], "batch_size": 2,
                              "use_shuffle": True, "data_len": -1} for s in ("qb", "gf2", "wv3")},
            **{f"val_{s.upper()}": {"dataroot": paths[f"val_{s}"], "data_len": 1}
               for s in ("qb", "gf2", "wv3")},
        },
        "model": {
            "beta_schedule": {"train": {"schedule": "cosine", "n_timestep": 1000},
                              "val": {"schedule": "cosine", "n_timestep": 1000}},
            "init_type": "kaiming",
            "unet": {"channel_multiplier": [4, 8, 8, 16]},
            "diffusion": {"loss_type": "l1"},
        },
        # max_iter not a multiple of val_freq: the run must still end with a
        # checkpoint of its last step
        "train": {"val_freq": 3, "print_freq": 1, "max_iter": 4, "optimizer": {"lr": 1e-3},
                  "ckpt_keep": 1},
        "val_max_images": 1,
        "val_batch_size": 1,
    }
    return root, cfg


def _write(root, cfg, name):
    path = root / f"{name}.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def _experiment(root, name):
    """The run's experiments/{name}_{yymmdd_hhmmss} directory."""
    (exp,) = [d for d in (root / "experiments").iterdir()
              if re.fullmatch(rf"{re.escape(name)}_\d{{6}}_\d{{6}}", d.name)]
    return exp


def _train(root, cfg):
    cfg_path = _write(root, cfg, "smoke")
    cli.main(["-c", cfg_path, "-p", "train", "--device", "cpu", "-log_eval"])
    return _experiment(root, "smoke")


def test_train_phase_end_to_end(workspace, monkeypatch):
    root, cfg = workspace
    monkeypatch.chdir(root)
    exp = _train(root, cfg)
    assert (exp / "logs" / "train.log").exists() and (exp / "logs" / "val.log").exists()
    assert (exp / "provenance.json").exists()
    assert (exp / "code" / "tmdiff_tpu_torch" / "cli.py").exists()
    assert not (exp / "code" / "tmdiff_tpu_torch" / "build").exists()
    # a checkpoint at the validation boundary (3), pruned by ckpt_keep = 1,
    # and the final one (4)
    assert sorted(os.listdir(exp / "checkpoint")) == ["I4"]
    mats = sorted((exp / "results").rglob("output_mulExm_*.mat"))
    assert [m.parent.name for m in mats] == ["GF2", "QB", "WV3"]
    for m in mats:
        mat = scio.loadmat(str(m))
        assert mat["sr"].shape == (16, 16, 4) and str(mat["clip_mode"][0]) == clip_mode()
    lines = [json.loads(x) for x in (exp / "results" / "eval_metrics.jsonl").read_text()
             .splitlines()]
    assert {x["sensor"] for x in lines} == {"QB", "GF2", "WV3"}
    assert all(np.isfinite(x["ssim"]) and np.isfinite(x["sam"]) for x in lines)
    log = (exp / "logs" / "train.log").read_text()
    assert "Applied init_type [kaiming]" in log and "Final checkpoint: step 4" in log
    state = torch.load(str(exp / "checkpoint" / "I4" / ckpt_lib.STATE_FILE), weights_only=True)
    assert state["step"] == 4 and state["scheduler"]["last_epoch"] == 4


@pytest.mark.parametrize("resume", ["root", "step_dir", "pth"])
def test_val_phase_with_resume(workspace, monkeypatch, resume):
    """-p val from the checkpoint root, from one I{step} directory, or from
    a reference .pth exported from it, with the EMA weights."""
    root, cfg = workspace
    monkeypatch.chdir(root)
    if not (root / "experiments").exists():
        _train(root, cfg)
    ckpt_dir = _experiment(root, "smoke") / "checkpoint"
    if resume == "pth":
        monkeypatch.setenv("TMDIFF_ALLOW_FAKE_CLIP", "1")
        from tmdiff_tpu_torch.diffusion.schedules import NoiseSchedule
        from tmdiff_tpu_torch.models.wavbest import WavBEST
        from tmdiff_tpu_torch.train.trainer import Trainer

        state = Trainer(WavBEST((4, 8, 8, 16), device="cpu"),
                        NoiseSchedule.create("cosine", 1000)).init_state()
        ckpt_lib.restore_checkpoint(str(ckpt_dir), state)
        target = ckpt_lib.export_reference_checkpoint(state, str(root / "I4_gen.pth"))
    else:
        target = str(ckpt_dir if resume == "root" else ckpt_dir / "I4")
    val_cfg = json.loads(json.dumps(cfg))
    val_cfg["name"] = f"smoke_val_{resume}"
    val_cfg["path"]["resume"] = target
    val_cfg["train"]["use_ema_eval"] = resume != "pth"
    cli.main(["-c", _write(root, val_cfg, f"smoke_val_{resume}"), "-p", "val",
              "--device", "cpu"])
    exp = _experiment(root, f"smoke_val_{resume}")
    assert len(list(exp.rglob("output_mulExm_*.mat"))) == 3
    log = (exp / "logs" / "train.log").read_text()
    assert ("Imported reference torch checkpoint" if resume == "pth"
            else "Restored checkpoint") in log
    assert "step 4 QB" in (exp / "logs" / "val.log").read_text()


def test_auto_resume_and_preemption(workspace, monkeypatch):
    """A SIGTERM mid-training checkpoints the step it stopped after and ends
    the run; a re-run with `path.resume: "auto"` and a stable experiments
    root continues from that checkpoint (the JAX package's case)."""
    root, cfg = workspace
    monkeypatch.chdir(root)
    auto = json.loads(json.dumps(cfg))
    auto["name"] = "smoke_auto"
    auto["path"]["experiments_root"] = str(root / "exp_auto")
    auto["path"]["resume"] = "auto"
    auto["train"]["max_iter"] = 60  # not reached: SIGTERM ends each run first
    auto["train"]["val_freq"] = 1000
    cfg_path = _write(root, auto, "smoke_auto")
    log_path = root / "exp_auto" / "logs" / "train.log"
    ckpt_dir = str(root / "exp_auto" / "checkpoint")

    def run_until(marker):
        done = threading.Event()

        def killer():
            deadline = time.time() + 300
            while not done.is_set() and time.time() < deadline:
                try:
                    if marker in log_path.read_text():
                        os.kill(os.getpid(), signal.SIGTERM)
                        return
                except OSError:
                    pass
                time.sleep(0.05)

        thread = threading.Thread(target=killer, daemon=True)
        thread.start()
        try:
            cli.main(["-c", cfg_path, "-p", "train", "--device", "cpu"])
        finally:
            done.set()
            thread.join(10)
        assert not thread.is_alive()

    run_until("step 2 ")
    first = ckpt_lib.latest_step(ckpt_dir)
    assert first is not None and 2 <= first < 60, first
    assert "Preemption signal: checkpointed step" in log_path.read_text()
    run_until(f"step {first + 1} ")
    log = log_path.read_text()
    assert f"Auto-resumed from {ckpt_dir} at step {first}" in log
    second = ckpt_lib.latest_step(ckpt_dir)
    assert first < second < 60, (first, second)
    assert signal.getsignal(signal.SIGTERM) is signal.SIG_DFL


@pytest.mark.parametrize("argv,message", [
    (["-p", "serve"], "invalid choice: 'serve'"),
    (["-p", "val", "--sampler", "dpm++_cfg"], "invalid choice: 'dpm++_cfg'"),
    (["-p", "train", "--sampler", "euler"], "invalid choice: 'euler'"),
])
def test_cli_refuses_what_is_not_ported(argv, message, capsys):
    """The parser takes the JAX CLI's phases and samplers and refuses the
    rest as its parser does (the facade's dpm++_cfg and ddim_cached are not
    among the JAX CLI's --sampler choices)."""
    assert cli.PHASES == ("train", "val", "distill")
    assert cli.SAMPLERS == ("dpm++", "dpm++_noise", "ancestral", "regression", "ddim")
    with pytest.raises(SystemExit) as exc:
        cli.main(["-c", "unused.json", *argv])
    assert exc.value.code == 2 and message in capsys.readouterr().err


@pytest.mark.parametrize("sampler", cli.SAMPLERS)
def test_val_phase_with_each_sampler(workspace, monkeypatch, sampler):
    """-p val from the trained checkpoint with every --sampler choice: the
    .mat files of each sensor and finite scores. The ancestral sampler walks
    every step of the validation schedule: T = 20 keeps it short."""
    root, cfg = workspace
    monkeypatch.chdir(root)
    if not (root / "experiments").exists():
        _train(root, cfg)
    name = "smoke_sampler_" + sampler.replace("+", "p")
    val_cfg = json.loads(json.dumps(cfg))
    val_cfg["name"] = name
    val_cfg["path"]["resume"] = str(_experiment(root, "smoke") / "checkpoint")
    if sampler == "ancestral":
        val_cfg["model"]["beta_schedule"]["val"]["n_timestep"] = 20
    cli.main(["-c", _write(root, val_cfg, name), "-p", "val", "--device", "cpu",
              "--sampler", sampler])
    exp = _experiment(root, name)
    mats = sorted(exp.rglob("output_mulExm_*.mat"))
    assert [m.parent.name for m in mats] == ["GF2", "QB", "WV3"]
    val_log = (exp / "logs" / "val.log").read_text()
    scores = [float(v) for v in re.findall(r"'(?:ssim|sam)_\w+': ([-+\d.e]+)", val_log)]
    assert len(scores) == 6 and np.isfinite(scores).all(), val_log


def test_distill_needs_a_teacher(workspace, monkeypatch):
    root, cfg = workspace
    monkeypatch.chdir(root)
    no_teacher = json.loads(json.dumps(cfg))
    no_teacher["name"] = "smoke_no_teacher"
    with pytest.raises(ValueError, match="requires path.resume"):
        cli.main(["-c", _write(root, no_teacher, "smoke_no_teacher"), "-p", "distill",
                  "--device", "cpu"])


def test_cli_needs_a_card_unless_told(workspace, monkeypatch):
    """Without --device the run asks for CUDA and raises where there is
    none, before any data is read."""
    root, cfg = workspace
    monkeypatch.chdir(root)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    no_card = json.loads(json.dumps(cfg))
    no_card["name"] = "smoke_nocard"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["-c", _write(root, no_card, "smoke_nocard"), "-p", "train"])


class _Recorder:
    """Stands in for both packages' training and sampling where their
    numbers differ by construction (weights from other RNGs), and records
    what each CLI hands them: the init seed, every train batch with its
    prompt row, every sampler call. The predictions are the batch's MS with
    noise seeded by the call's seed, so equal inputs give equal scores."""

    def __init__(self):
        self.init_seeds, self.batches, self.samples = [], [], []
        self.preempt_at = None

    def sample(self, sharp, batch, sensor="QB", method="dpm++", seed=0, steps=None, **kw):
        ms = np.asarray(batch["MS"])
        self.samples.append((sensor, method, seed, steps, ms.shape))
        noise = 0.02 * np.random.default_rng(seed).standard_normal(ms.shape)
        return np.clip(ms + noise, 0, 1).astype(np.float32)

    def batch(self, step, batch, emb):
        self.batches.append((step, {k: np.asarray(batch[k]) for k in ("Res", "PAN", "MS")},
                             np.asarray(emb)))
        if step == self.preempt_at:
            os.kill(os.getpid(), signal.SIGTERM)  # handled before the loop's next check


def _patch_port(monkeypatch, rec):
    from tmdiff_tpu_torch import pipeline
    from tmdiff_tpu_torch.models import init_styles
    from tmdiff_tpu_torch.train.trainer import Trainer

    def apply_init_style(model, style, gen):
        rec.init_seeds.append((style, gen.initial_seed()))
        return apply(model, style, gen)

    def compiled_step(self):
        step = compiled(self)

        def recorded(state, batch, emb):
            given = {k: batch[k].clone() for k in ("Res", "PAN", "MS")}
            state, metrics = step(state, batch, emb)
            rec.batch(state.step, given, emb)
            return state, metrics

        return recorded

    # the CLI's loop steps through compiled_step in one process
    apply, compiled = init_styles.apply_init_style, Trainer.compiled_step
    monkeypatch.setattr(init_styles, "apply_init_style", apply_init_style)
    monkeypatch.setattr(Trainer, "compiled_step", compiled_step)
    monkeypatch.setattr(pipeline.Pansharpener, "sample",
                        lambda self, batch, **kw: rec.sample(self, batch, **kw))


def _patch_jax(monkeypatch, rec):
    """The JAX CLI with a four-element train state and a step that only
    counts: the CLI's own decisions (seeds, steps, checkpoints, validation)
    stay, the model's compile does not."""
    import jax
    import jax.numpy as jnp

    from tmdiff_tpu import pipeline
    from tmdiff_tpu.models import init_styles
    from tmdiff_tpu.train.trainer import Trainer, TrainState

    def init_state(self, batch, emb):
        w = {"w": jnp.arange(4, dtype=jnp.float32)}
        return TrainState(step=jnp.zeros((), jnp.int32), params=w, opt_state={"m": w["w"]},
                          ema_params={"w": w["w"] + 1})

    def train_step(self, state, batch, emb):
        state = state.replace(step=state.step + 1)
        rec.batch(int(state.step), batch, emb)
        return state, {"l_pix": jnp.float32(0.0)}

    def apply_init_style(params, style, key):
        rec.init_seeds.append((style, int(jax.random.key_data(key)[-1])))
        return params

    monkeypatch.setattr(Trainer, "init_state", init_state)
    monkeypatch.setattr(Trainer, "train_step", train_step)
    monkeypatch.setattr(init_styles, "apply_init_style", apply_init_style)
    monkeypatch.setattr(pipeline.Pansharpener, "sample",
                        lambda self, batch, **kw: rec.sample(self, batch, **kw))


# SSIM and SAM on tensors against jnp: float32 reductions in another order,
# the bar of test_torch_eval.py::test_metrics_torch_match_metrics_jnp
SCORE_RTOL = 2e-5
_EVENTS = [
    (r"step (\d+) (QB|GF2|WV3) ", "validated"),
    (r"step (\d+) \w+: ", "stepped"),
    (r"Applied init_type \[(\w+)\]", "init"),
    (r"Auto-resumed from (\S+) at step (\d+)", "auto-resumed"),
    (r"Auto-resume: no checkpoint in (\S+), fresh start", "fresh"),
    (r"Preemption signal: checkpointed step (\d+) to (\S+);", "preempted"),
    (r"Final checkpoint: step (\d+) to (\S+)", "final"),
    (r"Restored checkpoint from (\S+)", "restored"),
    (r"Begin Model Evaluation\.", "evaluating"),
]


def _events(log_path, exp_root):
    """The decisions a train.log records, in order, with the run's
    experiments root written as <exp>; the validation scores beside them."""
    events, scores = [], []
    for line in log_path.read_text().splitlines():
        msg = line.split(" - INFO: ", 1)[-1].replace(str(exp_root), "<exp>")
        for pattern, name in _EVENTS:
            m = re.match(pattern, msg)
            if m:
                events.append((name, *m.groups()))
                if name == "validated":
                    scores.append({k: float(v) for k, v in re.findall(
                        r"'(\w+)': (?:np\.float\d+\()?([-+\d.e]+)", msg)
                        if not k.startswith("sec_per_image")})
                break
    return events, scores


def _listing(root):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())


def test_train_resume_and_val_match_the_jax_cli(workspace, monkeypatch):
    """One config through both CLIs on the same h5 files: a SIGTERM after
    step 2, `resume: "auto"` on to max_iter 4 with validation at 3 (val_freq
    3, keep 2), then `-p val` from the checkpoint root. The port's training
    is real; the JAX package's step only counts (its numbers are held by
    test_torch_train.py), and both samplers give the same seeded
    predictions. The two runs must agree on the init seed (train.seed 5 ->
    12), the batches and prompt rows of every step, the sampler's calls,
    the checkpoints left after each run, the log's decisions and the
    validation scores, the .mat files and the metric lines."""
    from tmdiff_tpu import cli as jax_cli

    root, cfg = workspace
    monkeypatch.chdir(root)
    base = json.loads(json.dumps(cfg))
    base["path"]["resume"] = "auto"
    base["train"].update(seed=5, ckpt_keep=2, use_ema_eval=True)
    for s in ("QB", "GF2", "WV3"):
        base["datasets"][f"val_{s}"]["data_len"] = -1  # two scenes, two sampler calls
    base["val_max_images"] = 2
    runs = {}
    for name, run_cli, patch, extra in (("port", cli.main, _patch_port, ["--device", "cpu"]),
                                        ("jax", jax_cli.main, _patch_jax, [])):
        rec = _Recorder()
        with monkeypatch.context() as m:
            patch(m, rec)
            exp = root / f"parity_{name}"
            own = json.loads(json.dumps(base))
            own["name"] = f"parity_{name}"
            own["path"]["experiments_root"] = str(exp)
            train_cfg = _write(root, own, f"parity_{name}")
            ckpts, cli_runs = [], []
            for preempt_at in (2, None):
                rec.preempt_at = preempt_at
                run_cli(["-c", train_cfg, "-p", "train", "-log_eval", *extra])
                ckpts.append(sorted(os.listdir(exp / "checkpoint")))
                cli_runs.append(_events(exp / "logs" / "train.log", exp))
            val = json.loads(json.dumps(own))
            val["path"]["resume"] = str(exp / "checkpoint")
            val["path"]["experiments_root"] = str(root / f"parity_{name}_val")
            run_cli(["-c", _write(root, val, f"parity_{name}_val"), "-p", "val", "-log_eval",
                     *extra])
            val_events = _events(root / f"parity_{name}_val" / "logs" / "train.log", exp)
        runs[name] = (rec, ckpts, cli_runs, val_events, exp)
        assert signal.getsignal(signal.SIGTERM) is signal.SIG_DFL

    (rec, ckpts, cli_runs, val_events, exp), (jrec, jckpts, jcli_runs, jval, jexp) = (
        runs["port"], runs["jax"])
    assert ckpts == jckpts == [["I2"], ["I3", "I4"]]
    assert rec.init_seeds == jrec.init_seeds == [("kaiming", 12)] * 2
    assert [b[0] for b in rec.batches] == [b[0] for b in jrec.batches] == [1, 2, 3, 4]
    for (_, batch, emb), (_, jbatch, jemb) in zip(rec.batches, jrec.batches):
        for k in batch:
            np.testing.assert_array_equal(batch[k], jbatch[k], err_msg=k)
        np.testing.assert_allclose(emb, jemb, rtol=1e-6)
    assert rec.samples == jrec.samples and len(rec.samples) == 2 * 3 * 2
    assert [e for e, _ in cli_runs] == [e for e, _ in jcli_runs] == [
        [("init", "kaiming"), ("fresh", "<exp>/checkpoint"), ("stepped", "1"),
         ("stepped", "2"), ("preempted", "2", "<exp>/checkpoint/I2")],
        [("init", "kaiming"), ("auto-resumed", "<exp>/checkpoint", "2"), ("stepped", "3"),
         ("validated", "3", "QB"), ("validated", "3", "GF2"), ("validated", "3", "WV3"),
         ("stepped", "4"), ("final", "4", "<exp>/checkpoint/I4")]]
    assert val_events[0] == jval[0]
    assert [e[0] for e in val_events[0]] == ["restored", "evaluating"] + ["validated"] * 3
    for ours, ref in ((cli_runs[1][1], jcli_runs[1][1]), (val_events[1], jval[1])):
        assert len(ours) == len(ref) == 3
        for a, b in zip(ours, ref):
            assert a.keys() == b.keys()
            np.testing.assert_allclose([a[k] for k in a], [b[k] for k in a], rtol=SCORE_RTOL)
    for ours_root, ref_root in ((exp / "results", jexp / "results"),
                                (root / "parity_port_val" / "results",
                                 root / "parity_jax_val" / "results")):
        assert _listing(ours_root) == _listing(ref_root)
        for rel in _listing(ours_root):
            if rel.endswith(".mat"):
                a, b = scio.loadmat(str(ours_root / rel)), scio.loadmat(str(ref_root / rel))
                np.testing.assert_array_equal(a["sr"], b["sr"])
                assert str(a["clip_mode"][0]) == str(b["clip_mode"][0])
            else:
                lines = [json.loads(x) for x in (ours_root / rel).read_text().splitlines()]
                ref = [json.loads(x) for x in (ref_root / rel).read_text().splitlines()]
                assert [(x["idx"], x["sensor"]) for x in lines] == [
                    (x["idx"], x["sensor"]) for x in ref]
                np.testing.assert_allclose([[x["ssim"], x["sam"]] for x in lines],
                                           [[x["ssim"], x["sam"]] for x in ref],
                                           rtol=SCORE_RTOL)
