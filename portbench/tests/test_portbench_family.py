"""A model family dropped in as files: in a copy of portbench/, a family
`tagged` (WavBEST's family and reference files, each with one more
per-request and per-step field, a tag drawn from the seed, that the
program's call and the reference both receive), a configuration that
names it, a serve cell and a train cell, all added beside the existing
files with none of them edited. Both cells run on the CPU at a tiny width
through the port's InferenceEngine and Trainer.compiled_step, come out
correct, and give the WavBEST family's images and first step bit for bit
on the same seed."""
import json
import os
import shutil
import time

import numpy as np
import torch

from portbench import run, serve, spec, train

torch.set_num_threads(2)
CPU = torch.device("cpu")
SEED = 2**31 + 57

FAMILY_TAIL = '''

import numpy as np

SEEN = []  # the tag of every program call, in call order


def request_extra(traffic, seed, index):
    return {"tag": np.float32(np.random.default_rng([seed, 99, index]).random())}


def submit(engine, pan, ms, sensor, extra):
    SEEN.append(float(extra["tag"]))
    return engine.submit(pan, ms, sensor)


def batch_extra(traffic, seed, step):
    return {"tag": np.float32(np.random.default_rng([seed, 98, step]).random())}


def train_call(step, state, batch, prompt, extra):
    SEEN.append(float(extra["tag"]))
    return step(state, batch, prompt)
'''

REFERENCE_TAIL = '''

import numpy as np

SEEN = []  # every tag the reference's encode received


class WavBEST(WavBEST):
    def encode(self, pan, ms, prompt, rng=None, tag=None):
        SEEN.extend(float(v) for v in np.atleast_1d(tag))
        return super().encode(pan, ms, prompt, rng)
'''


def checkout(tmp_path):
    """A copy of portbench/ with the `tagged` family's files added."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(spec.ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    pb = root / "portbench"
    before = {p: p.read_bytes() for p in pb.rglob("*") if p.is_file()}
    (pb / "families" / "tagged.py").write_text(
        (pb / "families" / "wavbest.py").read_text() + FAMILY_TAIL)
    (pb / "references" / "tagged.py").write_text(
        (pb / "references" / "wavbest.py").read_text() + REFERENCE_TAIL)
    config = json.loads((pb / "configs" / "wavbest-fp32.json").read_text())
    config["name"] = "tagged-fp32"
    config["model"]["family"] = "tagged"
    (pb / "configs" / "tagged-fp32.json").write_text(json.dumps(config))
    bench = json.load(open(os.path.join(spec.ROOT, "BENCHMARK.json")))
    bench["configs"].append({"name": "tagged-fp32", "source": "a test", "reduced": [],
                             "file": "portbench/configs/tagged-fp32.json", "why": "a test"})
    for name, traffic in (("tagged-fp32.serve-lowlatency", "serve-lowlatency"),
                          ("tagged-fp32.train-joint", "train-joint"),
                          ("wavbest-fp32.serve-lowlatency", "serve-lowlatency")):
        bench["workloads"].append({"name": name, "config": name.split(".")[0],
                                   "traffic": traffic, "chips": 1, "why": "a test"})
        check = pb / "checks" / f"wavbest-{'fp32' if 'train' in traffic else 'bf16'}.{traffic}.json"
        (pb / "checks" / f"{name}.json").write_text(check.read_text())
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    assert all(p.read_bytes() == b for p, b in before.items())
    return str(root)


def small(cell, **traffic):
    cell.config["model"]["channel_multiplier"] = [8, 8, 16, 16]
    cell.traffic.update(traffic)
    return cell


def captured(monkeypatch, module) -> list:
    """The arguments of each call of `module.compare`, which still runs."""
    calls, compare = [], module.compare
    monkeypatch.setattr(module, "compare",
                        lambda *a: calls.append(a) or compare(*a))
    return calls


def serve_run(root, name, monkeypatch):
    """(result line, requests, outputs, cell) of a short run; one request a
    batch, so each request's batch seed is its place in the schedule."""
    cell = spec.load(name, root)
    small(cell, size=16, pool=3, rate_per_s=4.0)
    cell.traffic["engine"] = {**cell.traffic["engine"], "max_batch": 1}
    cell.check["sample"] = 3
    calls = captured(monkeypatch, serve)
    record, check, peak = serve.run(cell, SEED, 1.0, False, CPU, time.perf_counter())
    _, _, _, _, reqs, outputs, _ = calls[-1]
    return (run.result_line(cell, record, check, peak, False, 0, len(record.requests), "cpu"),
            reqs, outputs, cell)


def train_run(root, name, monkeypatch):
    """(result line, names, the program's first steps, the reference's, cell)."""
    cell = small(spec.load(name, root), size=16, pool=16, warm_steps=4)
    cell.config["train"]["ema_decay"] = 0.9
    calls = captured(monkeypatch, train)
    record, check, peak = train.run(cell, SEED, 0.5, False, CPU, time.perf_counter())
    _, names, seen, ref = calls[-1]
    return (run.result_line(cell, record, check, peak, False, record.failed,
                            len(record.steps), "cpu"), names, seen, ref, cell)


def test_a_dropped_family_serves_with_no_code_edit(tmp_path, monkeypatch):
    root = checkout(tmp_path)
    base, base_reqs, base_out, _ = serve_run(root, "wavbest-fp32.serve-lowlatency", monkeypatch)
    got, reqs, out, cell = serve_run(root, "tagged-fp32.serve-lowlatency", monkeypatch)
    assert base["correct"] and got["correct"], (base["check"], got["check"])
    assert got["attempted"] == 4 and sorted(out) == sorted(base_out) == [0, 1, 2, 3]
    for i in out:
        assert out[i][1] == base_out[i][1]
        assert np.array_equal(out[i][0], base_out[i][0])
    tags = [float(r["extra"]["tag"]) for r in reqs]
    assert cell.family.SEEN == tags and len(set(tags)) == 4
    assert len(cell.family.REF.SEEN) == 3 and set(cell.family.REF.SEEN) <= set(tags)


def test_a_dropped_family_trains_with_no_code_edit(tmp_path, monkeypatch):
    root = checkout(tmp_path)
    base, base_names, base_seen, base_ref, _ = train_run(root, "wavbest-fp32.train-joint",
                                                         monkeypatch)
    got, names, seen, ref, cell = train_run(root, "tagged-fp32.train-joint", monkeypatch)
    assert base["correct"] and got["correct"], (base["check"], got["check"])
    assert names == base_names
    assert seen["losses"][0] == base_seen["losses"][0]
    assert seen["grads"][0] == base_seen["grads"][0]
    assert ref["losses"][0] == base_ref["losses"][0] and ref["grads"][0] == base_ref["grads"][0]
    program = cell.family.SEEN
    assert len(program) >= 4 + 1 and cell.family.REF.SEEN == program[:3]
