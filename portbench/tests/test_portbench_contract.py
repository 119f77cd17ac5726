"""``BENCHMARK.json`` against the benchmark's contract, every file found
by name, and the run's check of loaded modules."""
import importlib.util
import json
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fid:
        return json.load(fid)


def test_keys_names_and_units():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51
    cells = 2 + 14 * 24
    assert cells * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = []
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        names.append(c["name"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and LINE.match(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        names.append(w["name"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and LINE.match(m["layer"])
    assert len(json.dumps(b)) < 64 * 1024


def test_files_found_by_name():
    """Each configuration, traffic mix and per-layer metric has its file,
    and each reader says which end-to-end metric it moves."""
    b = bench()
    for path in b["paths"]:
        assert os.path.isdir(os.path.join(ROOT, path))
    files = [c["file"] for c in b["configs"]]
    assert len(set(files)) == len(files)
    configs = {c["name"] for c in b["configs"]}
    for c in b["configs"]:
        with open(os.path.join(ROOT, c["file"])) as fid:
            assert json.load(fid)["flags"]
    for w in b["workloads"]:
        assert w["config"] in configs
        with open(os.path.join(ROOT, "portbench", "workloads",
                               w["traffic"] + ".json")) as fid:
            traffic = json.load(fid)
        assert traffic["limits"] and traffic["worlds"] >= 1
    used = {w["config"] for w in b["workloads"]}
    assert used == configs
    for m in b["per_layer"]:
        path = os.path.join(ROOT, "portbench", "metrics", m["name"] + ".py")
        spec = importlib.util.spec_from_file_location("m", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        assert mod.MOVES == m["moves"] and callable(mod.read)


def test_module_check_compares_whole_names():
    from portbench.run import forbidden_modules
    assert forbidden_modules(["jax", "numpy"]) == ["jax"]
    assert forbidden_modules(["jax.numpy"]) == ["jax.numpy"]
    assert forbidden_modules(["pano360_tpu.cli"]) == ["pano360_tpu.cli"]
    assert forbidden_modules(["pano360_tpu_torch", "pano360_tpu_torch.cli",
                              "jaxtyping", "flaxen"]) == []
    assert forbidden_modules(["jaxlib", "flax.linen"]) == ["flax.linen",
                                                           "jaxlib"]


def test_harness_loads_no_jax():
    """Importing the harness, the reference and the port's stages loads
    neither JAX nor the JAX package."""
    code = ("import sys; sys.path.insert(0, %r); import portbench.run, "
            "portbench.reference, portbench.control, portbench.world; "
            "import pano360_tpu_torch.cli; "
            "from portbench.run import forbidden_modules; "
            "print(forbidden_modules())" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_run_refuses_without_card_or_port(tmp_path):
    """A run prints no result and exits non-zero without a card, and in a
    directory that holds only BENCHMARK.json and the benchmark."""
    import shutil
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "cmu2_15x1mp",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path, env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.gpu
def test_one_short_run_on_card():
    """On a card: one short run of the first cell prints a correct result
    with the contract's keys."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = bench()["workloads"][0]["name"]
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         "2147483659", "--seconds", "3", "--trace", "0"],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(res)[-1] == "checks"
    assert res["correct"] and res["device"]["platform"] == "gpu"
