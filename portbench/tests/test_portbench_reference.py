"""The WavBEST family's plain reference (portbench/references/wavbest.py
over portbench/reference.py) against the port's plain path (the kernels'
plain versions on the CPU) at tiny sizes: the served images of both
samplers and three training steps, float32; and the controls' precisions."""
import numpy as np
import pytest
import torch

from portbench import inputs, reference, spec, train

torch.set_num_threads(2)
CH = (8, 16, 16, 32)
MODEL = {"channel_multiplier": list(CH), "embed_dim": 128, "inter_dim": 32}
FAMILY = spec.load("wavbest-fp32.train-joint").family
REF = FAMILY.REF


@pytest.fixture(scope="module")
def weights():
    return inputs.make_weights(FAMILY.weight_spec(MODEL), 2**31 + 19, "cpu")


def port_sharp(weights, dtype=torch.float32):
    from tmdiff_tpu_torch.pipeline import Pansharpener

    model = FAMILY.build({**MODEL, "dtype": str(dtype).split(".")[-1]}, weights, "cpu")
    sharp = Pansharpener(model, device="cpu")
    sensors = sorted(sharp.prompt_index, key=sharp.prompt_index.get)
    sharp.prompt_table.copy_(torch.as_tensor(inputs.prompt_table(sensors)))
    return sharp


def test_param_spec_is_the_ports_state_dict():
    from tmdiff_tpu_torch.models.wavbest import WavBEST

    sd = WavBEST(CH, device="cpu").state_dict()
    got = REF.param_spec(CH)
    assert [n for n, *_ in got] == list(sd)
    assert all(tuple(sd[n].shape) == tuple(s) for n, s, *_ in got)
    assert FAMILY.weight_spec(MODEL) == got


def test_layouts_are_inverse():
    w = torch.randn(3, 3, 3, 4, 5)
    assert REF.to_reference_layout("w", w).shape == (5, 4, 3, 3, 3)
    assert torch.equal(REF.to_program_layout("w", REF.to_reference_layout("w", w)), w)
    b = torch.randn(5)
    assert REF.to_program_layout("b", b) is b


@pytest.mark.parametrize("method,steps,kw", [
    ("ddim", 1, {}), ("ddim_cached", 6, {"refresh_every": 2, "cache_level": 3}),
    ("ddim_cached", 4, {"refresh_every": 4, "cache_level": 1})])
def test_served_images_match_the_port(weights, method, steps, kw):
    sharp = port_sharp(weights)
    pool = inputs.scene_pool(4, 8, 3, 8, 16)
    sensors = ["WV3", "WV2", "WV3"]
    got = sharp.sample({"PAN": pool["pan"], "MS": pool["lms"]}, sensor=sensors, method=method,
                       steps=steps, seed=33, **kw)
    x_T = torch.randn((3, 8, 16, 16), generator=torch.Generator().manual_seed(33))
    want = reference.sample(FAMILY.reference(weights, MODEL),
                            reference.sqrt_alpha_bar("cosine", 1000, "cpu"),
                            torch.as_tensor(pool["pan"]), torch.as_tensor(pool["lms"]),
                            torch.as_tensor(inputs.prompt_table(sensors)), x_T, method, steps,
                            kw.get("refresh_every", 2), kw.get("cache_level", 1))
    assert np.abs(got - want.numpy()).max() < 2e-5


def test_schedule_is_the_ports():
    from tmdiff_tpu_torch.diffusion.schedules import NoiseSchedule

    for name in ("cosine", "linear"):
        assert torch.equal(reference.sqrt_alpha_bar(name, 1000, "cpu"),
                           NoiseSchedule.create(name, 1000).sqrt_alphas_cumprod_prev)


def test_three_training_steps_match_the_ports_trainer(weights):
    from tmdiff_tpu_torch.diffusion.schedules import NoiseSchedule
    from tmdiff_tpu_torch.train.trainer import Trainer

    cfg = {"lr": 1e-3, "weight_decay": 1e-4, "warmup_steps": 2, "max_iter": 100,
           "ema_decay": 0.9}
    model = FAMILY.build({**MODEL, "dtype": "float32"}, weights, "cpu")
    trainer = Trainer(model, NoiseSchedule.create("cosine", 1000), lr=cfg["lr"],
                      weight_decay=cfg["weight_decay"], warmup_steps=cfg["warmup_steps"],
                      max_iter=cfg["max_iter"], ema_decay=cfg["ema_decay"], seed=2**31 + 5)
    state = trainer.init_state()
    batches, losses, grads = [], [], []
    params = list(model.parameters())
    moments = [torch.zeros_like(p) for p in params]
    for k, bands in enumerate((4, 8, 8)):
        pool = inputs.scene_pool(k, 1, 2, bands, 16)
        res, pan, ms = (torch.as_tensor(a) for a in (pool["gt"] - pool["lms"], pool["pan"],
                                                      pool["lms"]))
        prompt = torch.as_tensor(inputs.prompt_table(["QB" if bands == 4 else "WV3"]))
        state, m = trainer.train_step(state, {"Res": res, "PAN": pan, "MS": ms}, prompt[0])
        losses.append(float(m["l_pix"]))
        batches.append((res, pan, ms, prompt.expand(2, -1), {}))
        now = train.first_moments(state.optimizer, params)
        grads.append(train.leaf_norms((m - 0.9 * m0) / 0.1 for m, m0 in zip(now, moments)))
        moments = now
    ref = FAMILY.reference_train(weights, MODEL, batches, 2**31 + 5, cfg,
                                 reference.sqrt_alpha_bar("cosine", 1000, "cpu"))
    assert np.allclose(losses, ref["losses"], rtol=1e-5, atol=0)
    ema = train.leaf_norms(state.ema_params)
    for i, (n, p) in enumerate(model.named_parameters()):
        for k in range(3):
            assert grads[k][i] == pytest.approx(ref["grads"][k][n], rel=1e-4, abs=1e-9)
        assert torch.allclose(p.detach(), ref["params"][n], rtol=0, atol=1e-6)
        assert ema[i] == pytest.approx(ref["ema"][n], rel=1e-5)


def test_fp8_rounds_as_stated():
    x = torch.tensor([1.0 + 2**-5, 1.0 + 3 * 2**-5, 500.0, -0.1])
    f8 = reference.round_fp8(x)
    assert f8[0] == 1.0 and f8[1] == 1.0 + 2**-3 and f8[2] == 448.0
    assert float(f8[3]) == pytest.approx(-0.1, rel=0.07)
    # a Linear's gradient passes through its operands' and output's rounding
    w = torch.randn(4, 3, requires_grad=True)
    y = REF.WavBEST({"l.weight": w, "l.bias": torch.zeros(4)}, precision="fp8").lin(
        torch.randn(2, 3), "l")
    y.sum().backward()
    assert w.grad is not None and torch.isfinite(w.grad).all()


def test_fp8_control_reads_far_above_the_bf16_program(weights):
    """At a test size the bf16 program's image gap to the fp32 reference
    is a tenth of the fp8 control's or less (on the card, at the cell's
    size: PERF.md section 4)."""
    from portbench import serve

    pool = inputs.scene_pool(4, 8, 2, 8, 16)
    sensors = ["WV3", "WV2"]
    got = port_sharp(weights, torch.bfloat16).sample(
        {"PAN": pool["pan"], "MS": pool["lms"]}, sensor=sensors, method="ddim_cached", steps=6,
        seed=7, refresh_every=2, cache_level=3)
    x_T = torch.randn((2, 8, 16, 16), generator=torch.Generator().manual_seed(7))
    args = (reference.sqrt_alpha_bar("cosine", 1000, "cpu"), torch.as_tensor(pool["pan"]),
            torch.as_tensor(pool["lms"]), torch.as_tensor(inputs.prompt_table(sensors)), x_T,
            "ddim_cached", 6, 2, 3)
    want = reference.sample(FAMILY.reference(weights, MODEL), *args)
    fp8 = reference.sample(FAMILY.reference(weights, MODEL, "fp8"), *args)
    gap = lambda img: serve.image_gap([
        (float(torch.sqrt(torch.mean((torch.as_tensor(img[i]) - want[i]) ** 2))),
         float(torch.sqrt(torch.mean((want[i] - torch.as_tensor(pool["lms"][i])) ** 2))))
        for i in range(2)])
    assert gap(fp8) > 10 * gap(got) > 0
