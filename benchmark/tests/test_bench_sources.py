"""The benchmark's files: what they import, what BENCHMARK.json names, and
the command's refusals. Run from the repository's root:

    python -m pytest benchmark/tests -q -p no:cacheprovider
"""
import ast
import importlib
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
sys.path.insert(0, ROOT)

from benchmark import gen, harness  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "sonic_tpu"}
# the reference and what it reads import nothing of the port either: the
# circuit families too, but for their uploads (`<name>.upload.py`)
PLAIN = {"reference.py", "g1.py", "gen.py", "yardstick.py"}


def _plain(path) -> bool:
    name = os.path.basename(path)
    in_circuits = os.path.basename(os.path.dirname(path)) == "circuits"
    return name in PLAIN or (in_circuits and not name.endswith(".upload.py"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _sources():
    for d, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _top_imports(path) -> set:
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, BENCH))
def test_no_module_imports_jax_or_the_jax_package(path):
    names = _top_imports(path)
    assert not names & FORBIDDEN, names & FORBIDDEN
    if _plain(path):
        assert "sonic_tpu_torch" not in names and "torch" not in names, names


def test_the_harness_loads_no_jax_at_run_time():
    code = ("import sys; sys.path.insert(0, %r); import benchmark.harness as h; "
            "import sonic_tpu_torch.protocol, sonic_tpu_torch.parallel.distributed; "
            "print(h.forbidden_modules())" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
    # whole top-level names: the port's name begins with the JAX package's
    assert "sonic_tpu_torch" in sys.modules and harness.forbidden_modules() == []
    saved = sys.modules.get("sonic_tpu")
    sys.modules["sonic_tpu"] = sys.modules["json"]
    try:
        assert harness.forbidden_modules() == ["sonic_tpu"]
    finally:
        if saved is None:
            del sys.modules["sonic_tpu"]
        else:
            sys.modules["sonic_tpu"] = saved


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_json_names_files_and_metrics():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"]
    names = [c["name"] for c in b["configs"]] + [w["name"] for w in b["workloads"]]
    names += [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in b["workloads"]]:
        assert NAME.match(n), n
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        with open(os.path.join(ROOT, c["file"])) as f:
            family = gen.circuit_name(json.load(f))
        assert os.path.exists(os.path.join(gen.CIRCUITS, family + ".py")), family
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert os.path.exists(os.path.join(BENCH, "metrics", m["name"] + ".py")), m["name"]
    for m in b["per_layer"]:
        assert m["moves"] in e2e
    for w in b["workloads"]:
        assert os.path.exists(os.path.join(BENCH, "traffic", w["traffic"] + ".json"))
        assert w["chips"] in (1, 4)
        spec = harness.load_spec(w["name"])
        reported = {m["name"] for m in spec.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2 and spec.per_layer
        assert {m["moves"] for m in spec.per_layer} <= reported


def test_every_traced_function_and_counter_exists():
    for name in os.listdir(os.path.join(BENCH, "metrics")):
        mod = harness.load_metric(name[:-3])
        keys = list(getattr(mod, "SPANS", ())) + list(getattr(mod, "COUNTERS", ()))
        keys += list(getattr(mod, "HOOKS", {}))
        for module, attr in keys:
            assert hasattr(importlib.import_module(module), attr), (name, module, attr)


def test_run_refuses_without_a_card_and_prints_no_result(tmp_path):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "prove.n16q64", "--seed",
                          str(2**31 + 7), "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode != 0 and "{" not in out.stdout
    # a checkout that holds only BENCHMARK.json and the benchmark's files
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "prove.n16q64", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True, timeout=300,
                         cwd=tmp_path)
    assert out.returncode != 0 and "{" not in out.stdout
