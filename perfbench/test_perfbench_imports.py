"""Nothing that runs on the card loads JAX or the JAX package, and the
reference loads nothing of the program.  Module names are compared by
their whole top-level name: ``repro_torch`` is not ``repro``."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

PB = Path(__file__).resolve().parent
ROOT = PB.parent

RUN = """
import json, sys, time
sys.path[:0] = [{root!r}, {src!r}]
from perfbench.harness import cli, spec
from perfbench.test_perfbench_faults import tiny_mix, tiny_model, tiny_settings
s = spec.Spec()
res = cli.run_cell(s, "nemotron15b.chat", 3, 0.5, False, "cpu", time.perf_counter(),
                   model=tiny_model("nemotron15b.chat"), settings=tiny_settings(),
                   mix=tiny_mix())
for m in s.bench["per_layer"] + s.bench["end_to_end"]:
    s.reader(m["name"])
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE = """
import json, sys
sys.path[:0] = [{root!r}]
import perfbench.reference, perfbench.kinds.attn, perfbench.kinds.dense_mlp
import perfbench.kinds.embed_head
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def top_level_modules(code: str) -> set:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code.format(root=str(ROOT),
                                                            src=str(ROOT / "src"))],
                         capture_output=True, text=True, env=env, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_and_no_reference_package():
    mods = top_level_modules(RUN)
    assert "repro_torch" in mods and "perfbench" in mods
    assert not mods & {"jax", "jaxlib", "flax", "repro"}


def test_the_reference_loads_nothing_of_the_program():
    mods = top_level_modules(REFERENCE)
    assert not mods & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


@pytest.mark.parametrize("path", sorted(str(p.relative_to(PB)) for p in PB.rglob("*.py")
                                        if not p.name.startswith("test_")))
def test_sources_import_no_jax(path):
    """No module of the benchmark names JAX or the JAX package in an import,
    and only the system-under-test adapter names the program."""
    tree = ast.parse((PB / path).read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    assert not names & {"jax", "jaxlib", "flax", "repro"}
    if path != os.path.join("harness", "port.py"):
        assert "repro_torch" not in names


def test_run_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, str(PB / "run.py"), "--workload", "nemotron15b.chat",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=240, cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == "" and "CUDA device" in out.stderr
