"""The port's MoE layer and the MoE and hybrid models against the JAX
package's, on the CPU.

Weights are the reference's own (``materialize`` with a JAX key),
carried across by `params_from_reference`; inputs are made with numpy.
Both sides run the reduced configs in float32 (jamba: 8 layers, 7 Mamba
and 1 attention, MoE on every other layer, 4 experts top-2; scout: MoE
on every layer, top-1 with a shared expert; maverick: MoE on every other
layer), so they differ only in the order of float32 sums and route the
same tokens to the same experts: the layer is held to 1e-5, whole-model
logits to 1e-4 of their largest magnitude, and prefill-then-decode
against the forward to the reference's own model tolerance (ATOL = 2e-2,
tests/test_models.py).  The expert products run through the port's
`gmm` (its plain version, on CPU tensors); the reference's through its
capacity einsums.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as ref_reduced_config
from repro.models import model as ref_model
from repro.models import moe as ref_moe
from repro.models.param import materialize
from repro.serve.engine import Request as RefRequest
from repro.serve.engine import ServeEngine as RefServeEngine
from repro_torch.configs import get_config, reduced_config
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import model as model_lib
from repro_torch.models import moe
from repro_torch.models import transformer as tfm
from repro_torch.serve.engine import Request, ServeEngine
from test_torch_matchmaker import one_torch_thread  # noqa: F401
from test_torch_models import carried, close, ref_params, t, tokens

JAMBA, SCOUT, MAVERICK = ("jamba-v0.1-52b", "llama4-scout-17b-a16e",
                          "llama4-maverick-400b-a17b")
MOE_ARCHS = [JAMBA, SCOUT, MAVERICK]
LAYER_TOL = 1e-5
MODEL_TOL = 1e-4    # of max |logits|
ATOL = 2e-2         # the reference's prefill/decode tolerance


def close_logits(port, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(port.numpy(), ref, rtol=0,
                               atol=MODEL_TOL * np.abs(ref).max())


def with_capacity(cfg, cf):
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


def moe_layer(cfg, seed=0):
    return materialize(ref_moe.init_moe(cfg), jax.random.PRNGKey(seed))


def kept_assignments(cfg, x):
    """Assignments the capacity keeps, from the reference's own router."""
    m = cfg.moe
    T = x.shape[0] * x.shape[1]
    p = moe_layer(cfg)
    logits = jnp.asarray(x).reshape(T, -1) @ p["router"]
    _, _, idx = ref_moe._router_topk(logits, m.top_k)
    counts = np.bincount(np.asarray(idx).reshape(-1), minlength=m.n_experts)
    return int(np.minimum(counts, moe.capacity(cfg, T)).sum()), T * m.top_k


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_layer_matches_reference(rng, arch):
    cfg = ref_reduced_config(arch)
    p = moe_layer(cfg)
    x = rng.standard_normal((2, 13, cfg.d_model)).astype(np.float32)
    ref_y, ref_aux = ref_moe.moe_forward_dense(p, cfg, jnp.asarray(x))
    y, aux = moe.moe_forward_dense(carried(p), reduced_config(arch), t(x))
    assert y.dtype == torch.float32 and aux.dtype == torch.float32
    close(y, ref_y, LAYER_TOL)
    close(aux, ref_aux, LAYER_TOL)
    assert p["router"].dtype == jnp.float32
    assert carried(p)["router"].dtype == torch.float32


@pytest.mark.parametrize("arch", [JAMBA, SCOUT])
def test_moe_layer_drops_the_reference_tokens(rng, arch):
    """A capacity factor of 0.5 overflows the experts' queues: the same
    (token, slot) assignments are dropped on both sides."""
    cfg = with_capacity(ref_reduced_config(arch), 0.5)
    x = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    kept, total = kept_assignments(cfg, x)
    assert kept < total
    ref_y, ref_aux = ref_moe.moe_forward_dense(moe_layer(cfg), cfg,
                                               jnp.asarray(x))
    y, aux = moe.moe_forward_dense(carried(moe_layer(cfg)),
                                   with_capacity(reduced_config(arch), 0.5),
                                   t(x))
    close(y, ref_y, LAYER_TOL)
    close(aux, ref_aux, LAYER_TOL)


def test_capacity_is_the_references():
    cfg = get_config(JAMBA)
    assert [moe.capacity(cfg, T) for T in (1, 8, 512, 1024)] == [
        1, 2, 80, 160]


def test_moe_refuses_a_mesh(rng, tmp_path):
    """A mesh is no longer refused (expert parallelism on several ranks is
    in tests/test_torch_parallel.py): on a one-rank world's (1, 1) mesh
    the layer is the dense dispatch, bit for bit, and its aux is the
    dense one's."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import WorkerMesh

    cfg = reduced_config(JAMBA)
    p = carried(moe_layer(ref_reduced_config(JAMBA)))
    x = torch.from_numpy(rng.standard_normal((2, 8, cfg.d_model)).astype(
        np.float32))
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = WorkerMesh({"data": 1, "model": 1}, "cpu")
        assert not moe.use_ep(cfg, mesh, 2)
        y, aux = moe.moe_forward(p, cfg, x, mesh=mesh)
    finally:
        dist.destroy_process_group()
    y_d, aux_d = moe.moe_forward_dense(p, cfg, x)
    assert torch.equal(y, y_d) and torch.equal(aux, aux_d)


@pytest.mark.parametrize("arch", [JAMBA, SCOUT])
def test_init_model_has_the_reference_tree(arch):
    """Same paths, shapes and dtypes as the reference's parameter tree
    (the router float32, the experts (n_scan, E, d, f))."""
    cfg = reduced_config(arch)
    ref = jax.tree_util.tree_map(
        lambda a: (tuple(a.shape), str(a.dtype)),
        ref_params(ref_reduced_config(arch)))
    port = jax.tree_util.tree_map(
        lambda a: (tuple(a.shape), str(a.dtype).split(".")[1]),
        model_lib.init_model(cfg, device="cpu"))
    assert port == ref


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_forward_matches_reference(rng, arch):
    """Logits, and the MoE layers' summed auxiliary loss that the stack
    returns for ``loss_fn``."""
    cfg, pcfg = ref_reduced_config(arch), reduced_config(arch)
    params = ref_params(cfg)
    port = carried(params)
    toks = tokens(rng, cfg, 2, 24)
    ref_logits, ref_aux = ref_model.forward(params, cfg,
                                            {"tokens": jnp.asarray(toks)},
                                            remat="none")
    logits = model_lib.forward(port, pcfg, {"tokens": t(toks)})
    close_logits(logits, ref_logits)
    x, positions = model_lib._input_embeds(port, pcfg, {"tokens": t(toks)})
    _, aux = tfm.stack_forward(port["stack"], pcfg, x, positions=positions)
    assert float(ref_aux) > 0
    close(aux, ref_aux, LAYER_TOL)


@pytest.mark.parametrize("arch", [JAMBA, SCOUT])
def test_prefill_and_decode_match_reference(rng, arch):
    """The port's prefill and decode steps against the reference's own,
    step by step, with the same weights and caches of the same size; for
    jamba the Mamba and attention caches sit side by side."""
    cfg, pcfg = ref_reduced_config(arch), reduced_config(arch)
    params = ref_params(cfg, seed=1)
    port = carried(params)
    toks = tokens(rng, cfg, 2, 16)
    ref_cache = ref_model.init_cache(cfg, 2, 40)
    cache = model_lib.init_cache(pcfg, 2, 40, device="cpu")
    ref_logits, ref_cache, ref_len = ref_model.prefill(
        params, cfg, {"tokens": jnp.asarray(toks[:, :10])}, ref_cache)
    logits, cache, lengths = model_lib.prefill(
        port, pcfg, {"tokens": t(toks[:, :10])}, cache)
    close_logits(logits, ref_logits)
    for s in range(10, 16):
        ref_logits, ref_cache, ref_len = ref_model.decode_step(
            params, cfg, jnp.asarray(toks[:, s:s + 1]), ref_cache, ref_len)
        logits, cache, lengths = model_lib.decode_step(
            port, pcfg, t(toks[:, s:s + 1]), cache, lengths)
        close_logits(logits, ref_logits)
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(ref_len))
    assert jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda a: 0, cache)) == \
        jax.tree_util.tree_structure(
            jax.tree_util.tree_map(lambda a: 0, ref_cache))
    for key, kind, leaf in (("slot0", "ssm", "ssm"), ("slot7", "self", "k"),
                            ("slot3", "self", "v")):
        if kind in ref_cache.get(key, {}):
            close(cache[key][kind][leaf], ref_cache[key][kind][leaf],
                  LAYER_TOL)


@pytest.mark.parametrize("arch", [JAMBA, SCOUT])
def test_prefill_decode_matches_forward(arch):
    """Twin of tests/test_models.py::test_prefill_decode_matches_forward
    on the port, with its weights and tokens: prefill of a prefix, then
    token-by-token decode of the rest with the ground-truth tokens,
    against the teacher-forced forward."""
    cfg = reduced_config(arch)
    params = carried(ref_params(ref_reduced_config(arch)))
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 25))
    toks = t(toks[:, :-1].astype(np.int32))
    S = toks.shape[1]
    n_pre = S // 2
    full = model_lib.forward(params, cfg, {"tokens": toks})
    cache = model_lib.init_cache(cfg, 1, S + 64, device="cpu")
    logits, cache, lengths = model_lib.prefill(
        params, cfg, {"tokens": toks[:, :n_pre]}, cache)
    close(logits, full[:, n_pre - 1], ATOL)
    for s in range(n_pre, S):
        logits, cache, lengths = model_lib.decode_step(
            params, cfg, toks[:, s:s + 1], cache, lengths)
        close(logits, full[:, s], ATOL)


def test_greedy_tokens_equal_the_jax_engine(rng):
    """Same weights (carried across), same prompts (at least d_conv - 1
    = 3 tokens: the reference's prefill keeps a short conv window for
    shorter ones), the idle rows decoded as the JAX engine decodes them:
    the port's jamba engine emits the JAX engine's greedy tokens, request
    by request.  The rows of a tick share each expert's capacity, so
    this is held against the JAX engine and not against solo runs."""
    cfg = ref_reduced_config(JAMBA)
    params = materialize(ref_model.init_model(cfg), jax.random.PRNGKey(2))
    port_params = carried(params)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (3, 9, 5, 12, 7)]
    ref = RefServeEngine(cfg, params, batch_slots=2, max_seq=48)
    port = ServeEngine(reduced_config(JAMBA), port_params, batch_slots=2,
                       max_seq=48)
    for i, p in enumerate(prompts):
        ref.submit(RefRequest(rid=i, prompt=p, max_new_tokens=6))
        port.submit(Request(rid=i, prompt=p, max_new_tokens=6))
    assert port.run_until_drained() == ref.run_until_drained()
    assert {i: r.output for i, r in port.done.items()} == {
        i: r.output for i, r in ref.done.items()}


def test_launcher_serves_jamba_on_the_cpu(capsys):
    serve_main(["--arch", JAMBA, "--reduced", "--device", "cpu",
                "--requests", "3", "--max-new", "3"])
    out = capsys.readouterr().out
    assert "[serve] 3/3 requests, 9 tokens" in out and "on cpu" in out


def test_full_width_jamba_shapes():
    """The served config is the published one at full width: d_model
    4096, 32 query heads over 8 KV heads of 128, d_ff 14336, 16 experts
    top-2 every other layer, one attention layer per period of 8."""
    cfg = get_config(JAMBA)
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.d_ff,
            cfg.vocab_size, cfg.period) == (4096, 32, 8, 128, 14_336,
                                            65_536, 8)
    m = cfg.moe
    assert (m.n_experts, m.top_k, m.d_ff_expert, m.every) == (16, 2, 14_336,
                                                              2)
    assert [cfg.mixer_kind(s) for s in range(8)] == ["ssm"] * 7 + ["attn"]
    assert [cfg.ffn_kind(s) for s in range(8)] == ["dense", "moe"] * 4
