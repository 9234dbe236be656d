"""BENCHMARK.json against the benchmark's contract, the data-driven look-up
of a cell's files and model family, and the check for JAX in the measuring
process."""
import ast
import json
import os
import re
import shutil

import pytest

from portbench import run, spec

BENCH = json.load(open(os.path.join(spec.ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["command"]) <= 32 and all(line(w) for w in BENCH["command"])
    assert all(not w.startswith("/") and ".." not in w for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.endswith("_torch") and os.path.isdir(
            os.path.join(spec.ROOT, p))
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_run_seconds_fits_a_full_check_of_24_cells():
    s = BENCH["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs():
    used = {w["config"] for w in BENCH["workloads"]}
    assert 1 <= len(BENCH["configs"]) <= 24
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert line(c["source"]) and line(c["why"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith("portbench/") and os.path.isfile(
            os.path.join(spec.ROOT, c["file"]))
        assert json.load(open(os.path.join(spec.ROOT, c["file"])))["reduced"] == c["reduced"]
    assert len({c["file"] for c in BENCH["configs"]}) == len(BENCH["configs"])


def test_workloads_and_metrics():
    cells = {w["name"]: w for w in BENCH["workloads"]}
    assert 1 <= len(cells) == len(BENCH["workloads"]) <= 24
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(cells)
    assert sum(w["chips"] == 4 for w in cells.values()) <= max(1, len(cells) // 4)
    for w in cells.values():
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and line(w["why"])
        assert w["chips"] in (1, 4)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16 and 1 <= len(BENCH["per_layer"]) <= 128
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(names)) == len(names)
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert line(m["layer"]) and m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", cells)
        layers.setdefault(m["layer"], []).append(m["name"])
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                    "higher")
        assert all(c in cells for c in m.get("workloads", ()))
    for name in cells:
        cell = spec.load(name)
        got = {k: [m["name"] for m in cell.reported(k)] for k in ("end_to_end", "per_layer")}
        assert "setup_s" in got["end_to_end"] and len(got["end_to_end"]) >= 2
        assert got["per_layer"]


FAMILY_API = ("weight_spec", "build", "request_extra", "submit", "batch_extra", "train_call",
              "reference", "reference_train")


def test_every_name_has_its_file():
    for w in BENCH["workloads"]:
        cell = spec.load(w["name"])
        assert cell.traffic["kind"] in run.DRIVERS
        for m in cell.metrics:
            assert callable(cell.reader(m[1]["name"]).read)
        assert all(callable(getattr(cell.family, f)) for f in FAMILY_API)
        assert cell.family is cell.family


def copy_checkout(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(spec.ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return root


@pytest.mark.parametrize("model,says", [
    ({"channel_multiplier": [32, 64, 128, 256]}, '"family" key'),
    ({"family": "no-such-family"}, "families/no-such-family.py")])
def test_a_configuration_without_its_family_fails_at_load(tmp_path, model, says):
    root = copy_checkout(tmp_path)
    path = root / "portbench" / "configs" / "wavbest-bf16.json"
    config = json.loads(path.read_text())
    config["model"] = model
    path.write_text(json.dumps(config))
    (root / "BENCHMARK.json").write_text(json.dumps(BENCH))
    with pytest.raises(ValueError, match=re.escape(says)):
        spec.load("wavbest-bf16.serve-quality", str(root))
    assert spec.load("wavbest-fp32.train-joint", str(root)).config["model"]["family"] == "wavbest"


def test_a_dropped_cell_is_found_with_no_code_edit(tmp_path):
    root = copy_checkout(tmp_path)
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "wavbest-bf16.serve-bursty", "config": "wavbest-bf16",
                               "traffic": "serve-bursty", "chips": 1, "why": "bursts"})
    bench["per_layer"].append({"name": "engine.queue.serve", "unit": "ms", "better": "lower",
                               "source": "program_span", "layer": "serve engine",
                               "moves": "serve_p90_ms",
                               "workloads": ["wavbest-bf16.serve-bursty"]})
    bench["end_to_end"][0]["workloads"].append("wavbest-bf16.serve-bursty")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    traffic = json.load(open(root / "portbench" / "traffic" / "serve-quality.json"))
    (root / "portbench" / "traffic" / "serve-bursty.json").write_text(
        json.dumps({**traffic, "rate_per_s": 9.0}))
    (root / "portbench" / "checks" / "wavbest-bf16.serve-bursty.json").write_text(
        json.dumps({"sample": 3, "limits": {"image_gap": 0.5}}))
    (root / "portbench" / "metrics" / "engine.queue.serve.py").write_text(
        "def read(record):\n    return 42.0\n")
    cell = spec.load("wavbest-bf16.serve-bursty", str(root))
    assert cell.traffic["rate_per_s"] == 9.0 and cell.check["sample"] == 3
    assert cell.config["model"]["dtype"] == "bfloat16"
    assert [m["name"] for m in cell.reported("end_to_end")] == ["serve_p90_ms", "setup_s"]
    assert cell.reader("engine.queue.serve").read(None) == 42.0
    with pytest.raises(KeyError):
        spec.load("no-such-cell", str(root))


def test_forbidden_modules_compare_whole_top_level_names():
    assert run.forbidden_modules(["tmdiff_tpu_torch", "tmdiff_tpu_torch.ops", "torch",
                                  "jaxtyping", "flaxen"]) == []
    assert run.forbidden_modules(["jax.numpy", "tmdiff_tpu.ops.modconv", "flax",
                                  "jaxlib.xla_client", "numpy"]) == ["flax", "jax", "jaxlib",
                                                                     "tmdiff_tpu"]


def test_the_harness_sources_import_no_jax():
    pat = re.compile(r"^\s*(?:import|from)\s+(jax|jaxlib|flax|tmdiff_tpu)\b(?!_torch)", re.M)
    seen = set()
    for dirpath, _, files in os.walk(os.path.join(spec.ROOT, "portbench")):
        for f in files:
            if f.endswith(".py"):
                assert not pat.search(open(os.path.join(dirpath, f)).read()), f
                seen.add(os.path.basename(dirpath))
    assert {"portbench", "families", "references", "metrics", "tests"} <= seen


def imported(path: str) -> set:
    """The modules a Python file imports, at any depth."""
    names = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module)
    return names


def test_a_plain_reference_imports_torch_numpy_and_the_shared_reference_only():
    allowed = {"__future__", "contextlib", "math", "numpy", "torch", "torch.nn.functional",
               "portbench.reference"}
    refs = os.path.join(spec.ROOT, "portbench", "references")
    paths = [os.path.join(spec.ROOT, "portbench", "reference.py")] + [
        os.path.join(refs, f) for f in sorted(os.listdir(refs)) if f.endswith(".py")]
    assert len(paths) >= 2
    for path in paths:
        assert imported(path) <= allowed, (path, imported(path) - allowed)


def test_no_card_no_result(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        run.main(["--workload", "wavbest-fp32.train-joint", "--seed", "1", "--seconds", "1"])
    assert exc.value.code != 0
    assert capsys.readouterr().out == ""
