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
    *(f"workload/{m}.py" for m in ("__init__", "__main__", "trace",
                                   "generators", "replay", "compare")),
    *(f"service/{m}.py" for m in ("__init__", "__main__", "driver", "http",
                                  "pool")),
    "models/__init__.py", "models/config.py", "parallel/__init__.py",
    "train/__init__.py", "checkpoint/__init__.py",
    "kernels/flash_attention/__init__.py", "kernels/moe_gmm/__init__.py",
    *(f"configs/{m}.py" for m in (
        "shapes", "granite_8b", "jamba_v0_1_52b",
        "llama4_maverick_400b_a17b", "llama4_scout_17b_a16e",
        "llava_next_mistral_7b", "mamba2_1_3b", "qwen2_1_5b", "qwen3_32b",
        "starcoder2_7b", "whisper_medium")),
]
#: copies that differ from the reference, and how
DIFFERING = {
    "core/__init__.py": "exports TorchMatchmaker instead of the JAX "
                        "backends",
    "core/matchmaker/base.py": "adds problem_from_reference at the end",
    "configs/__init__.py": "the input specs are meta tensors, not "
                           "ShapeDtypeStructs (`_spec` makes them)",
    "data/__init__.py": "exports stub_modality_inputs beside "
                        "make_batch_specs",
}
#: modules of the port with no reference counterpart to copy
PORT_OWN = {
    "__init__.py", "core/matchmaker/__init__.py",
    "core/matchmaker/torch_backend.py", "kernels/__init__.py",
    "kernels/waterfill/__init__.py", "kernels/waterfill/ops.py",
    "kernels/waterfill/ref.py", "kernels/waterfill/study.py",
    "kernels/build.py", "kernels/sites.py",
    "kernels/flash_attention/ops.py", "kernels/flash_attention/ref.py",
    "kernels/flash_attention/study.py",
    "kernels/ssd/__init__.py", "kernels/ssd/ops.py", "kernels/ssd/ref.py",
    "kernels/ssd/study.py", "kernels/ssd/bwd_study.py",
    "kernels/moe_gmm/ops.py", "kernels/moe_gmm/ref.py",
    "kernels/moe_gmm/bwd_study.py",
    "models/param.py", "models/layers.py", "models/attention.py",
    "models/transformer.py", "models/model.py", "models/ssm.py",
    "models/moe.py",
    "serve/__init__.py", "serve/engine.py",
    "launch/__init__.py", "launch/serve.py", "launch/train.py",
    "launch/mesh.py", "launch/dryrun.py", "launch/roofline_adjust.py",
    "parallel/sharding.py", "parallel/collectives.py",
    "train/optimizer.py", "train/schedule.py", "train/train_step.py",
    "data/pipeline.py", "checkpoint/manager.py",
    "observability/steps.py",
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


def test_config_registry_is_the_reference_without_input_specs():
    """configs/__init__.py holds every function of the reference's
    registry, the registry, reduced_config and the input specs' text
    length verbatim; the input specs keep their names and make meta
    tensors (`_spec`) where the reference makes ShapeDtypeStructs."""
    def functions(text):
        return {n.name: ast.get_source_segment(text, n)
                for n in ast.parse(text).body
                if isinstance(n, ast.FunctionDef)}

    ref = functions(substituted("configs/__init__.py"))
    port = functions((PORT / "configs/__init__.py").read_text())
    specs = {"train_input_specs", "prefill_input_specs",
             "decode_input_specs"}
    assert set(port) == set(ref) | {"_spec"}
    for name in set(ref) - specs:
        assert port[name] == ref[name], name
    for name in specs:
        assert "ShapeDtypeStruct" not in port[name], name


def test_pipeline_draws_are_the_references_letter_for_letter():
    """data/pipeline.py imports torch, so it is the port's own module,
    but the code that draws the batches is the reference's verbatim: the
    dataclass's fields, __post_init__, batch_at, and
    stub_modality_inputs."""
    def pieces(text):
        tree = ast.parse(text)
        out = {n.name: ast.get_source_segment(text, n)
               for n in tree.body if isinstance(n, ast.FunctionDef)}
        cls = next(n for n in tree.body if isinstance(n, ast.ClassDef)
                   and n.name == "SyntheticTokenPipeline")
        out["fields"] = [ast.get_source_segment(text, n) for n in cls.body
                         if isinstance(n, ast.AnnAssign)]
        out["decorators"] = [ast.get_source_segment(text, d)
                             for d in cls.decorator_list]
        for n in cls.body:
            if isinstance(n, ast.FunctionDef):
                out[f"SyntheticTokenPipeline.{n.name}"] = \
                    ast.get_source_segment(text, n)
        return out

    ref = pieces(substituted("data/pipeline.py"))
    port = pieces((PORT / "data/pipeline.py").read_text())
    for name in ("fields", "decorators", "SyntheticTokenPipeline.__post_init__",
                 "SyntheticTokenPipeline.batch_at", "stub_modality_inputs"):
        assert port[name] == ref[name], name
