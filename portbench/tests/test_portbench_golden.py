"""The WavBEST family's numbers against goldens (wavbest_golden.json) taken
before the model moved out of the drivers into `families/wavbest.py` and
`references/wavbest.py`: the work counted for every bucket of both serve
mixes at 4 and 8 bands and for a training step at 4 and 8 bands (as the
metric readers get it, through `Record`), to the integer; and at a small
size on the CPU the reference's served images (sha256 of their float32
bytes) and its first training loss, bit for bit. A harness change that
moves one of them changes what the cells measure."""
import hashlib
import json
import os

import pytest
import torch

from portbench import inputs, reference, spec
from portbench.record import Record

torch.set_num_threads(2)
GOLDEN = json.load(open(os.path.join(os.path.dirname(__file__), "wavbest_golden.json")))
KEYS = ("model_flops", "k1_flops", "k1_bytes")


@pytest.mark.parametrize("name", ["wavbest-bf16.serve-quality", "wavbest-bf16.serve-lowlatency"])
@pytest.mark.parametrize("bands", [4, 8])
def test_serve_work_is_the_golden(name, bands):
    cell = spec.load(name)
    cell.traffic = {**cell.traffic, "bands": bands}
    record = Record(cell, 0.0)
    want = GOLDEN["serve"][f"{cell.traffic['engine']['method']} {bands} bands"]
    assert [[record.serve_work(b)[k] for k in KEYS] for b in range(1, 9)] == want


@pytest.mark.parametrize("bands", [4, 8])
def test_train_work_is_the_golden(bands):
    record = Record(spec.load("wavbest-fp32.train-joint"), 0.0)
    assert [record.train_work(bands)[k] for k in KEYS] == GOLDEN["train"][f"{bands} bands"]


def test_reference_images_and_first_loss_are_the_golden():
    cell = spec.load("wavbest-fp32.train-joint")
    family = cell.family
    model = {"channel_multiplier": [8, 16, 16, 32], "embed_dim": 128, "inter_dim": 32}
    seed = 2**31 + 77
    weights = inputs.make_weights(family.weight_spec(model), seed, "cpu")
    pool = inputs.scene_pool(seed, 8, 3, 8, 16)
    sab = reference.sqrt_alpha_bar("cosine", 1000, "cpu")
    with reference.products(), torch.no_grad():
        for method, steps, level in (("ddim", 1, 1), ("ddim_cached", 6, 3)):
            x_T = torch.randn((3, 8, 16, 16), generator=torch.Generator().manual_seed(33))
            img = reference.sample(family.reference(weights, model), sab,
                                   torch.as_tensor(pool["pan"]), torch.as_tensor(pool["lms"]),
                                   torch.as_tensor(inputs.prompt_table(["WV3", "WV2", "WV3"])),
                                   x_T, method, steps, 2, level)
            got = hashlib.sha256(img.numpy().tobytes()).hexdigest()
            assert got == GOLDEN["images_sha256"][method], method
    pools = {s: inputs.Pool(inputs.scene_pool(seed, 10 + i, 8, b, 16))
             for i, (s, b) in enumerate((("QB", 4), ("GF2", 4), ("WV3", 8)))}
    (sensor, b), = inputs.train_batches({**cell.traffic, "batch": 2}, pools, seed, 1)
    prompt = inputs.as_tensor(inputs.prompt_table([sensor]), "cpu").expand(2, -1)
    batch = tuple(inputs.as_tensor(b[k], "cpu") for k in ("Res", "PAN", "MS")) + (prompt, {})
    with reference.products():
        out = family.reference_train(weights, model, [batch], seed, cell.config["train"], sab)
    assert out["losses"][0] == GOLDEN["first_loss"]
