"""No module the benchmark runs imports JAX, Flax, Optax or the JAX
package; the reference imports nothing of the program. Names are compared
by their top-level part as a whole: the program's package name begins with
the JAX package's."""

import ast
import os
import subprocess
import sys

import pytest

from h100_bench import harness

BANNED = {"jax", "jaxlib", "flax", "optax", "textflux_tpu"}
SOURCES = sorted(os.path.join(d, f) for d, _, fs in os.walk(harness.BENCH) for f in fs
                 if f.endswith(".py") and "tests" not in d.split(os.sep))


def imported(path):
    tops = set()
    for node in ast.walk(ast.parse(open(path, encoding="utf-8").read())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: os.path.relpath(p, harness.ROOT))
def test_no_jax_import(path):
    assert not imported(path) & BANNED


@pytest.mark.parametrize("path", [p for p in SOURCES if os.sep + "reference" + os.sep in p],
                         ids=os.path.basename)
def test_reference_imports_nothing_of_the_program(path):
    assert "textflux_torch" not in imported(path)


def test_the_top_level_names_are_compared_whole():
    # textflux_torch begins with the letters of textflux_tpu's first part
    assert "textflux_torch".split(".")[0] not in BANNED
    assert harness.banned_modules() == sorted(
        {n.split(".")[0] for n in sys.modules} & BANNED)


def test_a_tiny_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
            "import conftest\n"
            "from h100_bench import harness\n"
            "run = harness.load_module(%r, 'r')\n"
            "line, rc, _ = run.run_cell(conftest.tiny_cell(), conftest.tiny_args(), 'cpu')\n"
            "assert rc == 0 and line\n"
            "print(sorted({n.split('.')[0] for n in sys.modules} & %r))\n"
            % (harness.ROOT, os.path.dirname(__file__), os.path.join(harness.BENCH, "run.py"),
               BANNED))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_without_a_card_no_result(tmp_path):
    out = subprocess.run([sys.executable, os.path.join(harness.BENCH, "run.py"), "--workload",
                          "fill.edit-512", "--seed", str(2 ** 31 + 3), "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=300,
                         cwd=tmp_path, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode == 2 and out.stdout == ""
    assert "needs 1 CUDA device" in out.stderr
