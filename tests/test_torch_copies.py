"""The port's copies of the JAX package's framework-free modules stay
verbatim: each is the reference's source with ``repro.`` replaced by
``repro_torch.``, so drift on either side fails here.

The files that legitimately differ are listed in `DIFFERING`; every
other file of the port must be either a copy or one of the port's own
modules in `PORT_OWN`, so a new file has to be classified."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
REF = ROOT / "src" / "repro"
PORT = ROOT / "src" / "repro_torch"

COPIES = [
    *(f"core/{m}.py" for m in (
        "classad", "jobqueue", "fairshare", "groups", "cluster",
        "nodescaler", "config", "backend", "events", "metrics",
        "stragglers", "worker", "provisioner", "simulation")),
    "core/matchmaker/numpy_backend.py", "core/matchmaker/scan_backend.py",
    *(f"observability/{m}.py"
      for m in ("__init__", "registry", "spans", "profiler")),
    *(f"workload/{m}.py" for m in ("trace", "generators", "replay",
                                   "compare")),
]
#: copies that differ from the reference, and how
DIFFERING = {
    "core/__init__.py": "exports TorchMatchmaker instead of the JAX "
                        "backends",
    "workload/__init__.py": "docstring: the command-line front end is not "
                            "ported yet",
    "core/matchmaker/base.py": "adds problem_from_reference at the end",
}
#: modules of the port with no reference counterpart to copy
PORT_OWN = {
    "__init__.py", "core/matchmaker/__init__.py",
    "core/matchmaker/torch_backend.py", "kernels/__init__.py",
    "kernels/waterfill/__init__.py", "kernels/waterfill/ops.py",
    "kernels/waterfill/ref.py",
}


def substituted(rel: str) -> str:
    return (REF / rel).read_text().replace("repro.", "repro_torch.")


@pytest.mark.parametrize("rel", COPIES)
def test_copy_is_verbatim(rel):
    assert (PORT / rel).read_text() == substituted(rel), (
        f"src/repro_torch/{rel} drifted from src/repro/{rel}")


def test_base_is_reference_plus_converter():
    port = (PORT / "core/matchmaker/base.py").read_text()
    ref = substituted("core/matchmaker/base.py")
    assert port.startswith(ref)
    added = ast.parse(port[len(ref):])
    names = {n.name for n in added.body
             if isinstance(n, (ast.FunctionDef, ast.ClassDef))}
    assert names == {"_carried", "problem_from_reference"}
    assert all(isinstance(n, (ast.FunctionDef, ast.Expr))
               for n in added.body)


@pytest.mark.parametrize("rel", ["core/__init__.py", "workload/__init__.py"])
def test_reexports_cover_the_reference_names(rel):
    """The port's package exports every name the reference exports,
    with the JAX backends traded for TorchMatchmaker."""
    def exported(path):
        names = set()
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, ast.ImportFrom):
                names |= {a.asname or a.name for a in node.names}
        return names

    ref, port = exported(REF / rel), exported(PORT / rel)
    jax_only = {"HAVE_JAX", "JaxMatchmaker", "PallasMatchmaker",
                "HAVE_PALLAS"}
    assert ref - jax_only <= port
    assert not port & jax_only


def test_every_port_file_is_classified():
    files = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    known = set(COPIES) | set(DIFFERING) | PORT_OWN
    assert files == known, (f"unclassified: {sorted(files - known)}; "
                            f"missing: {sorted(known - files)}")
