"""The port stands alone: no module of `repro_torch` and nothing in
`chip_smoke.py` imports JAX or the JAX package, and importing them
builds no kernel."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|jaxlib|repro)\b(?!_)|from\s+(jax|jaxlib)\b|"
    r"from\s+repro(\.|\s+import))", re.M)


def port_modules():
    return sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
        .removesuffix(".__init__")
        for p in PORT.rglob("*.py"))


def test_every_port_module_imports_without_jax_or_reference():
    """Kernels first (their import reaches back into core), then every
    module, then chip_smoke; afterwards no jax* or repro.* module may be
    loaded and no kernel may have been launched."""
    mods = port_modules()
    first = "repro_torch.kernels.waterfill.ops"
    code = (
        "import importlib, json, sys\n"
        f"for m in {json.dumps([first] + mods + ['chip_smoke'])}:\n"
        "    importlib.import_module(m)\n"
        "from repro_torch.kernels.waterfill import ops\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(json.dumps({'bad': bad, 'launches': ops.launch_counts, "
        "'built': ops.build_log is not None}))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"bad": [], "launches": {"waterfill": 0}, "built": False}
    assert len(mods) >= 30


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_source_imports_jax_or_reference(path):
    hits = FORBIDDEN.findall(path.read_text())
    assert not hits, f"{path.relative_to(ROOT)} imports {hits}"


def test_forbidden_pattern_catches_what_it_must():
    for line in ("import jax", "import jax.numpy as jnp", "from jax import lax",
                 "from repro.core import Simulation", "import repro",
                 "    from repro.core.worker import kill_worker",
                 "from repro import core"):
        assert FORBIDDEN.search(line), line
    for line in ("import repro_torch", "from repro_torch.core import x",
                 "import numpy", "# see repro.core for the reference"):
        assert not FORBIDDEN.search(line), line
