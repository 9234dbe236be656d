"""The ControlNet on the port's serving path on the CPU: the controlled legacy
UNet (models/controlnet.py, channels (8, 8, 16, 16), embed 16, inter 8, 4
bands, 16x16, every weight drawn from a seed with the zero convs non-zero,
as the benchmark draws them) through `Pansharpener.sample` and
`InferenceEngine`, held against the benchmark's plain reference of the
same model (portbench/references/controlnet.py, plain PyTorch in float32),
against its own int-task path and against the plain LegacyUNet.

Tolerances, each of the output's scale (the largest magnitude), and why:
  * REF_RTOL: a 3-step DDIM image of the float32 model against the float32
    reference: the port's plain 3x3x3 conv and its channels-last library
    convs sum in another order than F.conv3d (a few float32 steps an op;
    2.1e-7 seen);
  * BF16_RTOL: the bf16 model against the float32 reference: bf16
    activations over some 40 convs and 20 Linear layers a step (4.4e-3
    seen; with the control residuals dropped the image moves by 0.2);
  * ROWS_RTOL: a batch against its rows run alone: at batch 1 the Linear
    layers and the plain convs round their sums differently (3e-7 seen);
  * everything else bit for bit: the facade split, the hint-less model, the
    engine's rows against the sampler's batch.
"""
import os
import re

import numpy as np
import pytest
import torch

from portbench import inputs, reference, spec
from tmdiff_tpu_torch.models.controlnet import TASKS_TO_ID, ControlledLegacyUNet
from tmdiff_tpu_torch.models.legacy_unet import LegacyUNet
from tmdiff_tpu_torch.pipeline import Pansharpener
from tmdiff_tpu_torch.serve.engine import InferenceEngine

torch.set_num_threads(2)

CPU = torch.device("cpu")
MODEL = {"channel_multiplier": [8, 8, 16, 16], "embed_dim": 16, "inter_dim": 8,
         "hint_channels": 3, "tasks": 13, "only_mid_control": False,
         "control_scales": [1.0] * 5, "dtype": "float32"}
B, BANDS, SIZE, STEPS = 4, 4, 16, 3
TASKS = np.array([1, 5, 1, 12])
SENSORS = ["WV3", "QB", "GF2", "WV3"]
REF_RTOL = 2e-6
BF16_RTOL = 0.05
ROWS_RTOL = 1e-5

FAMILY = spec.load_file(spec.family_path(spec.ROOT, "controlnet"), "controlnet_family_test")


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.fixture(scope="module")
def weights():
    return inputs.make_weights(FAMILY.weight_spec(MODEL), 2**31 + 11, CPU)


def _model(weights, dtype="float32"):
    return FAMILY.build({**MODEL, "dtype": dtype}, weights, CPU)


@pytest.fixture(scope="module")
def model(weights):
    return _model(weights)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(3)
    return {"PAN": rng.random((B, 1, SIZE, SIZE), np.float32),
            "MS": rng.random((B, BANDS, SIZE, SIZE), np.float32),
            "HINT": rng.random((B, SIZE, SIZE, 3), np.float32), "TASK": TASKS,
            "x_T": rng.standard_normal((B, BANDS, SIZE, SIZE)).astype(np.float32),
            "t": torch.tensor([3.0, 250.0, 600.0, 999.0]),
            "prompt": torch.as_tensor(rng.standard_normal((B, 768)).astype(np.float32))}


def _forward_args(data, rows=slice(None)):
    t = lambda k: torch.as_tensor(data[k][rows])
    return (t("x_T"), data["t"][rows], t("PAN"), t("MS"), data["prompt"][rows])


def _reference_image(weights, data, sharp):
    ref = FAMILY.reference(weights, MODEL)
    sab = reference.sqrt_alpha_bar("cosine", 1000, CPU)
    t = lambda k: torch.as_tensor(data[k])
    with reference.products(), torch.no_grad():
        return reference.sample(ref, sab, t("PAN"), t("MS"), sharp.prompt_embedding(SENSORS),
                                t("x_T"), "ddim", STEPS,
                                extra={"hint": data["HINT"], "task": data["TASK"]}).numpy()


@pytest.mark.parametrize("dtype,rtol", [("float32", REF_RTOL), ("bfloat16", BF16_RTOL)])
def test_ddim_through_the_pansharpener_matches_the_plain_reference(weights, data, dtype, rtol):
    """Mixed tasks in one batch through `Pansharpener.sample(method="ddim")`
    against the benchmark's plain reference on the same weights and x_T;
    with the control residuals dropped the image moves by far more."""
    sharp = Pansharpener(_model(weights, dtype), n_timestep=1000, device=CPU)
    batch = {k: data[k] for k in ("PAN", "MS", "HINT", "TASK")}
    got = sharp.sample(batch, sensor=SENSORS, method="ddim", steps=STEPS, x_init=data["x_T"])
    want = _reference_image(weights, data, sharp)
    assert _rel(got, want) <= rtol
    sharp.model.control_scales = (0.0,) * 5
    dropped = sharp.sample(batch, sensor=SENSORS, method="ddim", steps=STEPS,
                           x_init=data["x_T"])
    assert _rel(dropped, want) > 20 * max(_rel(got, want), REF_RTOL)


def test_a_batch_of_mixed_tasks_equals_each_row_alone(model, data):
    """Rows of tasks 1, 5, 1, 12 in one batch, each against its row run
    alone with its own int task_id (the JAX package's path)."""
    hint = torch.as_tensor(data["HINT"])
    with torch.no_grad():
        mixed = model(*_forward_args(data), hint=hint, task_id=TASKS)
        for i, task in enumerate(TASKS):
            alone = model(*_forward_args(data, slice(i, i + 1)), hint=hint[i:i + 1],
                          task_id=int(task))
            assert _rel(mixed[i:i + 1], alone) <= ROWS_RTOL, i
        # a row's task changes its image, and no other row's
        other = model(*_forward_args(data), hint=hint, task_id=[1, 5, 2, 12])
    changed = [not torch.equal(mixed[i], other[i]) for i in range(B)]
    assert changed == [False, False, True, False]


@pytest.mark.parametrize("task", [5, TASKS, torch.as_tensor(TASKS)],
                         ids=["int", "array", "tensor"])
def test_the_facade_split_is_the_forward_bit_for_bit(model, data, task):
    hint = torch.as_tensor(data["HINT"])
    x_t, t, pan, ms, prompt = _forward_args(data)
    with torch.no_grad():
        cache = model.encode_condition(pan, ms, prompt, hint=hint, task=task)
        assert torch.equal(model.denoise(x_t, t, cache),
                           model(x_t, t, pan, ms, prompt, hint=hint, task_id=task))
        feat = model.task_features[5].numpy()
        assert torch.equal(model(x_t, t, pan, ms, prompt, hint=hint, task_id=5),
                           model(x_t, t, pan, ms, prompt, hint=hint, task_id=5, task_feat=feat))


def test_without_a_hint_it_is_the_legacy_unet_bit_for_bit(model, weights, data):
    base = LegacyUNet(tuple(MODEL["channel_multiplier"]), MODEL["embed_dim"],
                      MODEL["inter_dim"], device=CPU)
    base.load_state_dict({k: v for k, v in model.state_dict().items()
                          if k.split(".")[0] not in ("control", "task_hypernet", "task_features")})
    args = _forward_args(data)
    with torch.no_grad():
        assert torch.equal(model(*args), base(*args))
        cache = base.encode_condition(*args[2:])
        assert torch.equal(base.denoise(*args[:2], cache), base(*args))
    with pytest.raises(ValueError, match="task without a hint"):
        model.encode_condition(*args[2:], task=1)


def test_the_task_table_is_a_buffer_filled_from_the_task_prompts(model):
    from tmdiff_tpu_torch.models.controlnet import task_feature

    fresh = ControlledLegacyUNet((8, 8, 16, 16), embed_dim=16, inter_dim=8, device=CPU)
    assert fresh.task_features.shape == (13, 768)
    assert "task_features" not in dict(fresh.named_parameters())
    for name, i in TASKS_TO_ID.items():
        np.testing.assert_array_equal(fresh.task_features[i].numpy(), task_feature(name))
    assert not torch.equal(model.task_features, fresh.task_features)  # loaded, strict


@pytest.fixture
def engine_of():
    made = []

    def make(sharp, **kw):
        made.append(InferenceEngine(sharp, **kw))
        return made[-1]

    yield make
    for e in made:
        e.shutdown()


def _names(ids):
    names = {i: n for n, i in TASKS_TO_ID.items()}
    return [names[int(i)] for i in ids]


def test_the_engine_batches_requests_of_different_tasks(model, data, engine_of):
    """Four requests of three tasks ride one batch of 4; each image equals
    the sampler's batch at the same seed bit for bit, and its request run
    alone from its row of x_T to ROWS_RTOL."""
    sharp = Pansharpener(model, n_timestep=1000, device=CPU)
    engine = engine_of(sharp, method="ddim", steps=STEPS, max_batch=4, max_delay_ms=500.0)
    futs = [engine.submit(data["PAN"][i], data["MS"][i], SENSORS[i], hint=data["HINT"][i],
                          task=name) for i, name in enumerate(_names(TASKS))]
    got = [f.result() for f in futs]
    assert [f.placement for f in futs] == [{"seed": 0, "bucket": 4, "row": i} for i in range(B)]
    assert engine.stats["batches"] == 1 and engine.stats["task_groups"] == 3
    batch = {k: data[k] for k in ("PAN", "MS", "HINT", "TASK")}
    direct = sharp.sample(batch, sensor=SENSORS, method="ddim", steps=STEPS, seed=0)
    x_T = torch.randn((B, BANDS, SIZE, SIZE), generator=torch.Generator().manual_seed(0))
    for i in range(B):
        np.testing.assert_array_equal(got[i], direct[i])
        alone = sharp.sample({k: v[i:i + 1] for k, v in batch.items()}, sensor=[SENSORS[i]],
                             method="ddim", steps=STEPS, x_init=x_T[i:i + 1].numpy())
        assert _rel(got[i], alone[0]) <= ROWS_RTOL, i


def test_submit_refuses_a_bad_hint_or_task(model, data, engine_of):
    sharp = Pansharpener(model, n_timestep=1000, device=CPU)
    engine = engine_of(sharp, method="ddim", steps=STEPS)
    pan, ms, hint = data["PAN"][0], data["MS"][0], data["HINT"][0]
    bad = [(dict(hint=hint[..., :2], task="control_canny"), "hint shape"),
           (dict(hint=hint[:8], task="control_canny"), "hint shape"),
           (dict(hint=hint, task="control_sketch"), "unknown task"),
           (dict(hint=hint), "takes a hint"), (dict(task="control_canny"), "takes a hint"),
           (dict(), "takes a hint")]
    for kw, says in bad:
        with pytest.raises(ValueError, match=says):
            engine.submit(pan, ms, "WV3", **kw)
    assert engine.stats["requests"] == 0 and engine._queue.qsize() == 0


@pytest.mark.parametrize("plain", ["WavBEST", "LegacyUNet"])
def test_a_model_without_hints_refuses_them(data, engine_of, plain):
    from tmdiff_tpu_torch.models.wavbest import WavBEST

    net = {"WavBEST": WavBEST, "LegacyUNet": LegacyUNet}[plain]((8, 8, 16, 16), device=CPU)
    sharp = Pansharpener(net, n_timestep=10, device=CPU)
    engine = engine_of(sharp, method="ddim", steps=1)
    with pytest.raises(ValueError, match="takes no hint or task"):
        engine.submit(data["PAN"][0], data["MS"][0], "WV3", hint=data["HINT"][0],
                      task="control_canny")
    with pytest.raises(ValueError, match="takes no HINT or TASK"):
        sharp.sample({k: data[k] for k in ("PAN", "MS", "HINT", "TASK")}, method="ddim",
                     steps=1)


@pytest.mark.parametrize("method", ["ddim_cached", "dpm++_cfg"])
def test_the_cached_and_guided_samplers_refuse_the_model(model, data, method):
    sharp = Pansharpener(model, n_timestep=1000, device=CPU)
    batch = {k: data[k] for k in ("PAN", "MS", "HINT", "TASK")}
    with pytest.raises(ValueError, match=re.escape(f"does not run '{method}'")):
        sharp.sample(batch, sensor=SENSORS, method=method, steps=2)
    with pytest.raises(ValueError, match="one process"):
        model.use_mesh(object())
    assert model.use_mesh(None) is model


def test_the_engine_warms_up_the_controlled_model(model, engine_of):
    """warmup() submits a zero hint and the task of id 0 at every bucket."""
    seen = []

    class Spy:
        def __init__(self, sharp):
            self.sharp = sharp

        def sample(self, batch, **kw):
            seen.append((batch["HINT"].shape, batch["TASK"].tolist(), float(batch["HINT"].max())))
            return self.sharp.sample(batch, **kw)

    engine = engine_of(Spy(Pansharpener(model, n_timestep=1000, device=CPU)), method="ddim",
                       steps=1, max_batch=2)
    engine.warmup([(BANDS, SIZE, SIZE)], sensor="WV3")
    assert seen == [((1, SIZE, SIZE, 3), [0], 0.0), ((2, SIZE, SIZE, 3), [0, 0], 0.0)]
    assert engine.stats["task_groups"] == 2


def test_the_preset_builds_the_controlled_model():
    from tmdiff_tpu_torch.serve import __main__ as serve_main

    preset = os.path.join(spec.ROOT, "tmdiff_tpu_torch", "config", "presets",
                          "serve_controlnet.json")
    args, opt, kw = serve_main.prepare(["-c", preset, "--ckpt", "unused"])
    assert (args.sampler, args.steps, args.bf16, args.use_ema) == ("ddim", 20, True, True)
    assert kw is None and args.warmup == "8,256,256"
    control = opt["model"]["controlnet"]
    assert (control["hint_channels"], control["only_mid_control"],
            control["control_scales"]) == (3, False, [1.0] * 5)
