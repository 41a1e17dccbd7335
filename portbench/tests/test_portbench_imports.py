"""No run loads JAX or the JAX package: the check compares each loaded
module's top-level name whole (the port's name begins with the JAX
package's)."""

import ast
import os
import subprocess
import sys
import types

from harness import registry, runner


def test_top_level_names_compare_whole(monkeypatch):
    for name in list(sys.modules):
        if name.split(".")[0] in runner.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "fourdgs_tpu_torch_extra",
                        types.ModuleType("fourdgs_tpu_torch_extra"))
    monkeypatch.setitem(sys.modules, "jaxtyping",
                        types.ModuleType("jaxtyping"))
    assert runner.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "fourdgs_tpu.ops",
                        types.ModuleType("fourdgs_tpu.ops"))
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("jaxlib"))
    assert runner.forbidden_modules() == ["fourdgs_tpu", "jaxlib"]


def test_a_run_loads_neither():
    """Everything a run imports, in a fresh process."""
    code = (
        "import sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]\n"
        "from harness import runner, control, trace\n"
        "import fourdgs_tpu_torch.engine.trainer, fourdgs_tpu_torch.train\n"
        "from harness import registry\n"
        "for m in registry.load_benchmark()['per_layer']:\n"
        "    registry.metric_reader(m['name'])\n"
        "print(runner.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code, registry.BENCH_DIR,
                          registry.REPO], capture_output=True, text=True,
                         timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_sources():
    """No file of the benchmark imports JAX or the JAX package; the
    reference imports nothing of the program either."""
    for root, _, files in os.walk(registry.BENCH_DIR):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(root, f)
            tops = {m.split(".")[0] for m in imports(path)}
            assert not tops & set(runner.FORBIDDEN), path
            if os.path.basename(root) == "reference":
                assert "fourdgs_tpu_torch" not in tops, path
