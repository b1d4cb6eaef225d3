"""What a run loads: no JAX and no JAX package (by top-level module name),
and a reference that imports nothing of the program."""

import ast
import os
import subprocess
import sys

from perfbench.harness import HERE, ROOT

MODULES = ["perfbench.harness", "perfbench.drivers.train",
           "perfbench.drivers.sim", "perfbench.drivers.forecast",
           "perfbench.control", "socialways_torch.engine.trainer",
           "socialways_torch.engine.simulate",
           "socialways_torch.eval.metrics"]


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n" % ROOT
            + "".join(f"import {m}\n" for m in MODULES)
            + "from perfbench.harness import forbidden_modules\n"
            "print(forbidden_modules())\n")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(HERE, "reference")
    for name in os.listdir(ref):
        if name.endswith(".py"):
            tops = {m.split(".")[0] for m in _imports(os.path.join(ref, name))}
            assert tops <= {"__future__", "typing", "numpy", "torch",
                            "perfbench"}, (name, tops)
            assert not any(m.startswith("perfbench.") and not m.startswith(
                "perfbench.reference") for m in _imports(
                    os.path.join(ref, name))), name


def test_no_benchmark_file_imports_jax():
    for dirpath, _, files in os.walk(HERE):
        for name in files:
            if name.endswith(".py"):
                tops = {m.split(".")[0] for m in _imports(
                    os.path.join(dirpath, name))}
                assert not tops & {"jax", "jaxlib", "flax", "socialways_tpu"}


def test_run_refuses_without_a_card_or_the_program(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    cmd = [sys.executable, "perfbench/run.py", "--workload", "crowd-sim",
           "--seed", "1", "--seconds", "1", "--trace", "0"]
    out = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         cwd=ROOT, timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()
    import shutil
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         cwd=tmp_path, timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()
    assert "socialways_torch" in out.stderr
