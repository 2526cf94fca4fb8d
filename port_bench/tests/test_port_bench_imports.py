"""Nothing under port_bench imports JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's), the
reference imports nothing of the port, and a whole run loads neither."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

from port_bench import cell as C

JAX = {"jax", "jaxlib", "flax", "end_to_end_asr_pytorch_tpu"}
PORT = "end_to_end_asr_pytorch_tpu_torch"
FILES = sorted(C.HERE.rglob("*.py"))


def imported(path: Path):
    """(top-level module names, relative imports' levels and modules)."""
    names, rel = set(), []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                rel.append((node.level, node.module))
            else:
                names.add(node.module.split(".")[0])
    return names, rel


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(C.HERE)))
def test_no_jax(path):
    names, _ = imported(path)
    assert not names & JAX


@pytest.mark.parametrize("path", sorted((C.HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    names, rel = imported(path)
    assert PORT not in names and "port_bench" not in names
    assert all(level == 1 for level, _ in rel)


def test_a_run_loads_no_jax():
    code = (
        "import sys, torch\n"
        "sys.path.insert(0, %r)\n"
        "from port_bench.tests.conftest import tiny_configs, TINY_MIX\n"
        "from port_bench import cell as C, run, control\n"
        "c = C.Cell('las_decode', 5, torch.device('cpu'), configs=tiny_configs(),"
        " mix=TINY_MIX['decode'], limits={'score_gap': 1.0})\n"
        "r = run.run_cell(c, 0.5, False)\n"
        "C.remove_tree(c.tmp)\n"
        "assert r is not None and r['correct'], r\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & %r))\n"
    ) % (str(C.ROOT), JAX)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
