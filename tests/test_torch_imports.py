"""The port stands alone: importing textflux_torch and every submodule pulls
in neither JAX nor the JAX package, nor the safetensors and transformers
packages (the port reads and writes safetensors itself and imports
transformers only inside load_tokenizers), and no port source (nor
chip_smoke.py or the port's tools/) imports JAX or the JAX package."""

import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
import textflux_torch
names = [m.name for m in pkgutil.walk_packages(textflux_torch.__path__, "textflux_torch.")]
for name in names:
    importlib.import_module(name)
for name in ("textflux_torch.io.params", "textflux_torch.io.lora", "textflux_torch.io.export",
             "textflux_torch.io.safetensors", "textflux_torch.pipeline.tokenizers",
             "textflux_torch.cli.run_inference", "textflux_torch.cli.train",
             "textflux_torch.data.native", "textflux_torch.data.anytext",
             "textflux_torch.data.dataset", "textflux_torch.data.loader",
             "textflux_torch.training.checkpoint", "textflux_torch.utils.tracking",
             "textflux_torch.io.quantize", "textflux_torch.training.optim8bit",
             "textflux_torch.cli.run_eval", "textflux_torch.cli.demo",
             "textflux_torch.cli.eval_ocr", "textflux_torch.cli.eval_fid_lpips",
             "textflux_torch.pipeline.t2i", "textflux_torch.evaluation.metrics",
             "textflux_torch.evaluation.crop", "textflux_torch.evaluation.fid",
             "textflux_torch.evaluation.inception", "textflux_torch.evaluation.lpips",
             "textflux_torch.evaluation.ppocr", "textflux_torch.parallel.partitioning"):
    assert name in names, name
bad = sorted(m for m in sys.modules
             if m in ("jax", "safetensors", "transformers")
             or m.startswith(("jax.", "jaxlib", "textflux_tpu", "safetensors.", "transformers.")))
print(len(names), bad)
assert not bad, bad
"""

_IMPORT = re.compile(r"^\s*(?:import|from)\s+(jax|jaxlib|textflux_tpu)\b", re.MULTILINE)


def test_import_pulls_in_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 20, proc.stdout      # every subpackage was walked


def test_no_source_imports_jax():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for top in ("textflux_torch", "tools"):
        for dirpath, _, names in os.walk(os.path.join(ROOT, top)):
            files += [os.path.join(dirpath, f) for f in names if f.endswith(".py")]
    offenders = []
    for path in files:
        with open(path, encoding="utf-8") as f:
            if _IMPORT.search(f.read()):
                offenders.append(os.path.relpath(path, ROOT))
    assert len(files) > 20 and not offenders, offenders
