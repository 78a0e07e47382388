"""Nothing the harness loads is JAX or the JAX package: top-level module
names compared whole (the port's name, fpng_tpu_torch, begins with the JAX
package's, fpng_tpu)."""

import ast
import os
import subprocess
import sys

from pngbench import guard
from pngbench.tests.conftest import ROOT

MODULES = ["pngbench.run", "pngbench.control", "pngbench.activity",
           "pngbench.manifest", "pngbench.pngref", "pngbench.roofline",
           "pngbench.tiles", "pngbench.guard", "fpng_tpu_torch",
           "fpng_tpu_torch.models.decoder", "fpng_tpu_torch.models.encoder"]


def test_guard_compares_whole_top_level_names():
    assert guard.forbidden(["fpng_tpu_torch", "fpng_tpu_torch.models",
                            "numpy", "jaxtyping"]) == []
    assert guard.forbidden(["fpng_tpu.ops.walk8", "jax.numpy", "jaxlib",
                            "flax.linen"]) == ["flax", "fpng_tpu", "jax",
                                               "jaxlib"]


def test_loaded_module_set_holds_no_jax():
    code = ("import os, sys, importlib\n"
            "from pngbench import manifest\n"
            f"for m in {MODULES!r}: importlib.import_module(m)\n"
            "for d in ('content', 'ops', 'metrics'):\n"
            "    for f in os.listdir(os.path.join(manifest.HERE, d)):\n"
            "        if f.endswith('.py'): manifest.plugin(d, f[:-3])\n"
            "print('\\n'.join(sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert guard.forbidden(out.stdout.split()) == []


def test_sources_import_no_jax():
    for dirpath, _, files in os.walk(os.path.join(ROOT, "pngbench")):
        for f in files:
            if not f.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(dirpath, f)).read())
            names = []
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    names += [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module:
                    names.append(node.module)
            assert guard.forbidden(names) == [], (f, names)
