"""Elastic training and serving under a mesh on gloo worlds on the CPU,
held against the JAX package: reshard-on-restore (the twin of
tests/test_multidevice.py::test_elastic_restore_across_meshes, and the
two packages' managers reading each other's checkpoints across meshes),
`run_elastic` against the reference's `run_elastic` with carried weights
and against the port's one-device `run_fixed`, the twin of
examples/elastic_train.py, ``--elastic`` through `main`, `run_fixed`
resumed onto a mesh, and `ServeEngine` under the ``decode``,
``decode_sp`` and ``ep`` presets against the JAX package's one-device
engine.

One world of 8 ranks (tests/torch_world.py) runs every case.  The
reference's `run_elastic` runs meanwhile in a subprocess with 8 host
devices (as tests/test_multidevice.py runs its bodies), and the
reference's engines in this process; weights and batches cross over as
numpy."""
import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_world
from repro.checkpoint.manager import CheckpointManager as RefCheckpointManager
from repro.configs import reduced_config as ref_reduced_config
from repro.models import model as ref_model
from repro.models.param import materialize
from repro.serve.engine import Request as RefRequest
from repro.serve.engine import ServeEngine as RefServeEngine
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import reduced_config
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import spawn_world
from test_torch_matchmaker import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD_TIMEOUT_S = 300.0
#: `run_elastic` against the reference's: each logged loss, relative
ELASTIC_LOSS_TOL = 1e-4
#: against the port's one-device `run_fixed`, and the resumed run against
#: the uninterrupted one: each logged loss (tests/test_torch_multidevice.py)
RUN_LOSS_TOL = 1e-4
#: a meshed engine's first tick's logits against the JAX engine's, and the
#: merge of a cache cut in 4 against the whole attention (float32)
LOGITS_TOL = 1e-4
MERGE_TOL = 1e-6

CARRIED = dict(arch="qwen2-1.5b", steps=8, batch=8, seq=32)
EXAMPLE = dict(arch="qwen2-1.5b", steps=40, batch=8, seq=64, log_every=5)
MAMBA_ARGV = ["--arch", "mamba2-1.3b", "--reduced", "--device", "cpu",
              "--elastic", "--steps", "4", "--batch", "8", "--seq", "16"]
RESUME = dict(arch="qwen2-1.5b", steps=4, batch=8, seq=16, resume_from=2)
SERVE = [
    dict(arch="qwen2-1.5b", rules=("decode", "decode_sp")),
    # capacity that drops nothing on either side, as
    # tests/test_multidevice.py::test_moe_ep_matches_dense holds EP
    dict(arch="llama4-scout-17b-a16e", rules=("ep",), capacity_factor=8.0),
]
SERVE_SHAPE = dict(mesh={"data": 4}, slots=4, max_seq=64, new=6)

#: the reference's run_elastic on 8 host devices, printing its losses
REF_ELASTIC = """
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
from repro.configs import reduced_config
from repro.launch.train import run_elastic
run = json.loads(sys.argv[1])
losses = run_elastic(reduced_config(run["arch"]), steps=run["steps"],
                     batch=run["batch"], seq=run["seq"],
                     ckpt_dir=run["ckpt_dir"], log_every=1)
print("LOSSES " + json.dumps(losses))
"""


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def schedule(printed: str) -> list[str]:
    """The rescale lines and each step's worker count, in order (the
    losses left out)."""
    out = []
    for line in printed.splitlines():
        if line.startswith("[elastic]"):
            out.append(line)
        m = re.match(r"step +(\d+) .*workers=(\d+)", line)
        if m:
            out.append(f"step {m[1]} workers={m[2]}")
    return out


def serve_config(case):
    cfg = ref_reduced_config(case["arch"])
    if case.get("capacity_factor"):
        cfg = torch_world.with_moe(cfg, cfg.moe.n_experts,
                                   case["capacity_factor"])
    return cfg


def ref_serve(case, params, prompts):
    """The JAX package's one-device engine: tokens, the first tick's
    logits and the ticks."""
    cfg = serve_config(case)
    engine = RefServeEngine(cfg, params, batch_slots=SERVE_SHAPE["slots"],
                            max_seq=SERVE_SHAPE["max_seq"])
    first = []
    decode = engine._decode

    def recorded(*args):
        out = decode(*args)
        if not first:
            first.append(np.asarray(out[0]))
        return out

    engine._decode = recorded
    for i, p in enumerate(prompts):
        engine.submit(RefRequest(rid=i, prompt=p,
                                 max_new_tokens=SERVE_SHAPE["new"]))
    ticks = engine.run_until_drained()
    return {"tokens": {i: r.output for i, r in engine.done.items()},
            "logits": first[0], "ticks": ticks}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("elastic")
    rng = np.random.default_rng(5)
    tree = {"w": rng.standard_normal((16, 8)).astype(np.float32),
            "b": np.asarray(jnp.asarray(rng.standard_normal((4, 16)),
                                        jnp.bfloat16).astype(jnp.float32)),
            "n": np.asarray(7, np.int32)}
    ref_tree = {"w": jnp.asarray(tree["w"]),
                "b": jnp.asarray(tree["b"], jnp.bfloat16),
                "n": jnp.asarray(tree["n"])}
    RefCheckpointManager(str(tmp / "jax"), async_mode=False).save(1, ref_tree)
    cfg = ref_reduced_config(CARRIED["arch"])
    carried = materialize(ref_model.init_model(cfg), jax.random.PRNGKey(0))
    # the one-device checkpoint the world resumes from, and the run it
    # must equal
    one = launch_train.run_fixed(
        reduced_config(RESUME["arch"]), steps=RESUME["steps"],
        batch=RESUME["batch"], seq=RESUME["seq"],
        ckpt_dir=str(tmp / "one"), device="cpu", log_every=1,
        ckpt_every=RESUME["resume_from"])
    prompts = [rng.integers(0, 512, size=n).astype(np.int32)
               for n in (5, 11, 3, 17, 8, 2)]
    serve_params = [materialize(ref_model.init_model(serve_config(c)),
                                jax.random.PRNGKey(3)) for c in SERVE]
    cases = {
        "restore": dict(tree=tree, port_dir=str(tmp / "port"),
                        jax_dir=str(tmp / "jax")),
        "merge": merge_case(),
        "resume": dict(RESUME, ckpt_dir=str(tmp / "one")),
        "serve": [dict(c, **SERVE_SHAPE, params=numpy_tree(p),
                       prompts=prompts)
                  for c, p in zip(SERVE, serve_params)],
        "elastic": dict(
            params=numpy_tree(carried),
            carried=dict(CARRIED, ckpt_dir=str(tmp / "carried")),
            example=dict(EXAMPLE, ckpt_dir=str(tmp / "example")),
            main_argv=MAMBA_ARGV + ["--ckpt-dir", str(tmp / "mamba")]),
    }
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    ref_run = subprocess.Popen(
        [sys.executable, "-c", REF_ELASTIC,
         json.dumps(dict(CARRIED, ckpt_dir=str(tmp / "ref_elastic")))],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        # the world, the reference's engines and the one-device run side
        # by side
        with ThreadPoolExecutor(2 + len(SERVE)) as pool:
            running = pool.submit(
                spawn_world, torch_world.elastic_world, 8, backend="gloo",
                init_file=tmp / "store", timeout_s=WORLD_TIMEOUT_S,
                args=(cases,))
            ex = EXAMPLE
            fixed = pool.submit(
                launch_train.run_fixed, reduced_config(ex["arch"]),
                steps=ex["steps"], batch=ex["batch"], seq=ex["seq"],
                ckpt_dir=None, device="cpu", log_every=ex["log_every"])
            serving = [pool.submit(ref_serve, c, p, prompts)
                       for c, p in zip(SERVE, serve_params)]
            out = running.result()
            one_example = fixed.result()
            serve_ref = [f.result() for f in serving]
        stdout, stderr = ref_run.communicate(timeout=WORLD_TIMEOUT_S)
    finally:
        if ref_run.poll() is None:
            ref_run.kill()
    assert ref_run.returncode == 0, stderr
    ref = {"elastic": (json.loads(stdout.split("LOSSES ")[-1]), stdout),
           "serve": serve_ref, "one_resume": one,
           "one_example": one_example}
    return out, ref, tmp


def merge_case():
    """One decode query row per batch row against a 32-slot cache cut in
    4 parts of 8: rows 0 and 1 hold 20 and 13 positions, so the third
    and fourth parts hold no key of row 1 and the fourth none of row 0;
    the query at the next position."""
    rng = np.random.default_rng(11)
    B, C, H, Hkv, Dh = 2, 32, 4, 2, 16
    pos = np.full((B, C), -1, np.int32)
    for b, n in enumerate((20, 13)):
        pos[b, :n] = np.arange(n)
    return {"q": rng.standard_normal((B, 1, H, Dh)).astype(np.float32),
            "k": rng.standard_normal((B, C, Hkv, Dh)).astype(np.float32),
            "v": rng.standard_normal((B, C, Hkv, Dh)).astype(np.float32),
            "pos": pos,
            "q_pos": np.array([[20], [13]], np.int32)}


def test_restore_across_meshes(world):
    """A tree saved from a mesh of ranks 0-3 restores onto a mesh of 8:
    each rank holds `shard_of` the whole, in the target's dtypes, and
    the shards make the whole again; the JAX package's checkpoint
    restores onto 8 the same way (by placements)."""
    out, _, _ = world
    tree = {"w": np.random.default_rng(5).standard_normal(
        (16, 8)).astype(np.float32)}
    assert [r["restore"]["index"] for r in out] == list(range(8))
    for r in out:
        assert r["restore"]["dtypes"] == {"w": "torch.float32",
                                          "b": "torch.bfloat16",
                                          "n": "torch.int32"}
    for key in ("restored", "from_jax"):
        w = np.concatenate([r["restore"][key]["w"] for r in out])
        np.testing.assert_array_equal(w, tree["w"])
        b = np.concatenate([r["restore"][key]["b"] for r in out], axis=1)
        assert b.shape == (4, 16)
        assert {float(r["restore"][key]["n"]) for r in out} == {7.0}
    for r in out:
        np.testing.assert_array_equal(r["restore"]["restored"]["b"],
                                      r["restore"]["from_jax"]["b"])


def test_checkpoint_from_a_mesh_restores_on_one_device_and_in_jax(world):
    """The checkpoint rank 0 wrote from the mesh of 4 is the one-device
    format: the port's manager restores it onto one device, and the JAX
    package's manager restores it, both equal to the tree."""
    out, _, tmp = world
    tree = {"w": np.random.default_rng(5).standard_normal(
        (16, 8)).astype(np.float32)}
    b = np.concatenate([r["restore"]["restored"]["b"] for r in out], axis=1)
    import torch
    target = {"w": torch.zeros((16, 8)), "b": torch.zeros(
        (4, 16), dtype=torch.bfloat16), "n": torch.zeros((), dtype=torch.int32)}
    one = CheckpointManager(str(tmp / "port")).restore(1, target)
    np.testing.assert_array_equal(one["w"].numpy(), tree["w"])
    np.testing.assert_array_equal(one["b"].float().numpy(), b)
    assert int(one["n"]) == 7
    ref = RefCheckpointManager(str(tmp / "port")).restore(1, {
        "w": jax.ShapeDtypeStruct((16, 8), jnp.float32),
        "b": jax.ShapeDtypeStruct((4, 16), jnp.bfloat16),
        "n": jax.ShapeDtypeStruct((), jnp.int32)})
    np.testing.assert_array_equal(np.asarray(ref["w"]), tree["w"])
    np.testing.assert_array_equal(np.asarray(ref["b"], np.float32), b)
    assert int(ref["n"]) == 7


def test_run_elastic_matches_the_reference(world):
    """run_elastic in the world of 8 with the reference's initial weights
    carried in, against the JAX package's run_elastic on 8 host devices:
    the same rescale lines step for step (0 -> 4 at step 0, 4 -> 8 at
    step 4), and every logged loss within 1e-4, relative, on every
    rank."""
    out, ref, _ = world
    ref_losses, ref_printed = ref["elastic"]
    assert len(ref_losses) == CARRIED["steps"]
    losses, printed = out[0]["elastic"]["carried"]
    assert schedule(printed) == schedule(ref_printed)
    assert "[elastic] rescale: 4 -> 8 workers (claimed=8)" in printed
    for r in out:
        got = r["elastic"]["carried"][0]
        assert len(got) == len(ref_losses)
        for a, b in zip(got, ref_losses):
            assert abs(a - b) <= ELASTIC_LOSS_TOL * abs(b), (got, ref_losses)


def test_run_elastic_matches_one_device_run_fixed(world):
    """The example's twin (40 steps, batch 8, seq 64, from the port's own
    seed) logs the losses of the port's one-device run_fixed of the same
    steps within RUN_LOSS_TOL: the rescale resumes the run exactly."""
    out, ref, _ = world
    one = ref["one_example"]
    for r in out:
        got = r["elastic"]["example"][0]
        assert len(got) == len(one)
        assert all(abs(a - b) < RUN_LOSS_TOL for a, b in zip(got, one)), \
            (got, one)


def test_elastic_example_twin(world):
    """examples/elastic_train.py on the port: rescales 0 -> 4 at step 0
    and 4 -> 8 at step 20, and the loss decreases across them."""
    out, _, _ = world
    losses, printed = out[0]["elastic"]["example"]
    sched = schedule(printed)
    assert sched[0] == "[elastic] rescale: 0 -> 4 workers (claimed=4)"
    assert sched[1] == "step 0 workers=4"
    at = sched.index("[elastic] rescale: 4 -> 8 workers (claimed=8)")
    assert sched[at - 1] == "step 15 workers=4"
    assert sched[at + 1] == "step 20 workers=8"
    assert len([s for s in sched if s.startswith("[elastic]")]) == 2
    assert losses[-1] < losses[0]


def test_elastic_mamba2_through_main_in_the_world(world):
    """mamba2 (reduced) under ``--elastic`` through `main` in the world,
    as the reference's usage runs it: both rescales, finite losses."""
    out, _, _ = world
    losses, printed = out[0]["elastic"]["main"]
    assert [s for s in schedule(printed) if s.startswith("[elastic]")] == [
        "[elastic] rescale: 0 -> 4 workers (claimed=4)",
        "[elastic] rescale: 4 -> 8 workers (claimed=8)"]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert {tuple(r["elastic"]["main"][0]) for r in out} == {tuple(losses)}


def test_elastic_on_one_process(tmp_path):
    """Outside a world run_elastic trains on the one device (n_dev = 1, as
    the reference with one device): one rescale, 0 -> 1 at step 0."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        losses = launch_train.main(MAMBA_ARGV + ["--ckpt-dir",
                                                 str(tmp_path)])
    assert schedule(buf.getvalue())[0] == \
        "[elastic] rescale: 0 -> 1 workers (claimed=1)"
    assert len(losses) == 2 and all(np.isfinite(losses))


def test_run_fixed_resumes_onto_a_mesh(world):
    """run_fixed in the world of 8 resumed from a one-device checkpoint
    (each rank restoring its shards) logs the uninterrupted one-device
    run's losses within RUN_LOSS_TOL."""
    out, ref, _ = world
    one = ref["one_resume"][RESUME["resume_from"]:]
    for r in out:
        got = r["resume"]["losses"]
        assert len(got) == len(one)
        assert all(abs(a - b) < RUN_LOSS_TOL for a, b in zip(got, one))


@pytest.mark.parametrize("i, rules", [
    (i, rules) for i, c in enumerate(SERVE) for rules in c["rules"]],
    ids=[f"{c['arch']}-{r}" for c in SERVE for r in c["rules"]])
def test_meshed_engine_matches_the_jax_engine(world, i, rules):
    """ServeEngine on {"data": 4} (the world's ranks 0-3; 4-7 outside)
    under ``decode`` (a row a rank), ``decode_sp`` (every row, 16 cache
    slots a rank) and, for the 4-expert llama4-scout, ``ep`` (a row a
    rank, the experts over "data"), against the JAX package's
    one-device engine with the same weights: the same greedy tokens on
    every rank, the same ticks, the first tick's logits within 1e-4."""
    out, ref, _ = world
    want = ref["serve"][i]
    layouts = {"decode": ((("data",), ())), "decode_sp": ((), ("data",)),
               "ep": (("data",), ())}
    for rank, r in enumerate(out):
        got = r["serve"][i][rules]
        if rank >= 4:
            assert got is None
            continue
        assert tuple(map(tuple, got["layout"])) == layouts[rules]
        assert got["tokens"] == want["tokens"]
        assert got["ticks"] == want["ticks"]
        assert np.abs(got["logits"] - want["logits"]).max() < LOGITS_TOL


def test_split_cache_merge_equals_whole_attention(world):
    """A decode step's attention over a cache cut in 4 (one part holds
    no key of either row, another none of one row): the ranks' flash
    outputs merged by their lse equal the whole attention within 1e-6."""
    out, _, _ = world
    for r in out[:4]:
        assert r["merge"]["err"] < MERGE_TOL
    assert out[3]["merge"]["empty_part"]


def test_serving_with_a_model_axis_raises(world):
    """A serving mesh with a "model" axis of 2 no longer raises: the
    engine serves with activation tensor parallelism (tests/
    test_torch_tp.py holds its tokens against the JAX package's meshed
    engine), each rank holding its half of the query heads' columns
    (4 heads of 16 -> 32 of 64) and its kv head of the cache, its row of
    the 4 over "data"."""
    out, _, _ = world
    cfg = reduced_config("qwen2-1.5b")
    for r in out:
        assert r["merge"]["model_axis"] is None
        assert r["merge"]["held"]["wq"] == (
            cfg.n_layers, cfg.d_model, cfg.n_heads * cfg.d_head // 2)
        assert r["merge"]["held"]["k"] == (
            cfg.n_layers, 1, 256, cfg.n_kv_heads // 2, cfg.d_head)
