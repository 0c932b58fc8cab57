"""The port's continuous-batching engine on the CPU: the reference's
serving tests (tests/test_serve.py) on the port, the port's greedy
tokens against the JAX engine's with the same weights, the spot-reclaim
recovery of examples/spot_serving.py, and the cuda default."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as ref_reduced_config
from repro.models import model as ref_model
from repro.models.param import materialize
from repro.serve.engine import Request as RefRequest
from repro.serve.engine import ServeEngine as RefServeEngine
from repro_torch.configs import reduced_config
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import model as model_lib
from repro_torch.models.param import params_from_reference
from repro_torch.serve.engine import Request, ServeEngine
from test_torch_matchmaker import one_torch_thread  # noqa: F401


def _engine(arch="qwen2-1.5b", slots=3, max_seq=96, seed=0):
    cfg = reduced_config(arch)
    params = model_lib.init_model(cfg, seed=seed, device="cpu")
    return cfg, params, ServeEngine(cfg, params, batch_slots=slots,
                                    max_seq=max_seq)


def test_engine_drains_all_requests(rng):
    cfg, params, eng = _engine()
    for i in range(7):  # more requests than slots -> queueing
        prompt = rng.integers(0, cfg.vocab_size, size=5).astype(np.int32)
        eng.submit(Request(rid=i, prompt=prompt, max_new_tokens=4))
    assert eng.queue_depth() == 7
    ticks = eng.run_until_drained(max_ticks=500)
    assert ticks < 500
    assert len(eng.done) == 7
    for r in eng.done.values():
        assert len(r.output) == 4
    assert eng.prefill_calls == 7 and 0 < eng.decode_ticks <= ticks


def test_batched_output_matches_solo_output(rng):
    """A request decoded alongside others gives the same greedy tokens as
    the same request decoded alone (no state leaks across slots)."""
    prompts = [rng.integers(0, 100, size=6).astype(np.int32)
               for _ in range(3)]
    cfg, params, eng_multi = _engine(slots=3, seed=1)
    for i, p in enumerate(prompts):
        eng_multi.submit(Request(rid=i, prompt=p, max_new_tokens=5))
    eng_multi.run_until_drained()
    for i, p in enumerate(prompts):
        eng_solo = ServeEngine(cfg, params, batch_slots=1, max_seq=96)
        eng_solo.submit(Request(rid=0, prompt=p, max_new_tokens=5))
        eng_solo.run_until_drained()
        assert eng_multi.done[i].output == eng_solo.done[0].output, i


def test_queue_depth_is_demand_signal(rng):
    cfg, params, eng = _engine(slots=1)
    for i in range(4):
        eng.submit(Request(rid=i,
                           prompt=rng.integers(0, 50, 4).astype(np.int32),
                           max_new_tokens=2))
    d0 = eng.queue_depth()
    eng.step()
    assert eng.queue_depth() < d0  # admission consumed from the queue


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "starcoder2-7b",
                                  "mamba2-1.3b"])
def test_greedy_tokens_equal_the_jax_engine(rng, arch):
    """Same weights (carried across), same prompts: the port's engine
    emits the JAX engine's greedy tokens, request by request."""
    cfg = ref_reduced_config(arch)
    params = materialize(ref_model.init_model(cfg), jax.random.PRNGKey(2))
    port_params = params_from_reference(
        jax.tree_util.tree_map(np.asarray, params), device="cpu")
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (3, 9, 5, 12, 7)]
    ref = RefServeEngine(cfg, params, batch_slots=2, max_seq=48)
    port = ServeEngine(reduced_config(arch), port_params, batch_slots=2,
                       max_seq=48)
    for i, p in enumerate(prompts):
        ref.submit(RefRequest(rid=i, prompt=p, max_new_tokens=6))
        port.submit(Request(rid=i, prompt=p, max_new_tokens=6))
    assert port.run_until_drained() == ref.run_until_drained()
    assert {i: r.output for i, r in port.done.items()} == {
        i: r.output for i, r in ref.done.items()}


def test_spot_reclaim_recovers_every_request(rng):
    """examples/spot_serving.py on the port: the engine is lost after a
    few ticks, its unfinished requests go to a fresh engine, all are
    served, and each request's tokens are those of an undisturbed run."""
    cfg = reduced_config("granite-8b")
    params = model_lib.init_model(cfg, device="cpu")
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, 6).astype(
        np.int32), max_new_tokens=4) for i in range(10)]
    engine = ServeEngine(cfg, params, batch_slots=2, max_seq=64)
    for r in reqs[:6]:
        engine.submit(r)
    for _ in range(6):
        engine.step()
    assert 0 < len(engine.done) < 6
    unfinished = [r for r in reqs[:6] if r.rid not in engine.done]
    for r in unfinished:
        r.output = None
    engine2 = ServeEngine(cfg, params, batch_slots=2, max_seq=64)
    for r in unfinished + reqs[6:]:
        engine2.submit(r)
    engine2.run_until_drained()
    served = {**engine.done, **engine2.done}
    assert sorted(served) == list(range(10))
    calm = ServeEngine(cfg, params, batch_slots=2, max_seq=64)
    for r in reqs:
        calm.submit(Request(rid=r.rid, prompt=r.prompt, max_new_tokens=4))
    calm.run_until_drained()
    assert {i: r.output for i, r in served.items()} == {
        i: r.output for i, r in calm.done.items()}


def test_model_defaults_to_cuda(monkeypatch):
    """Without a GPU the model's entry points raise unless the caller
    asks for the CPU; nothing falls back silently."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced_config("qwen2-1.5b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model_lib.init_model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model_lib.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_main(["--arch", "qwen2-1.5b", "--reduced"])


def test_launcher_serves_on_the_cpu(capsys):
    serve_main(["--arch", "qwen2-1.5b", "--reduced", "--device", "cpu",
                "--requests", "3", "--max-new", "3"])
    out = capsys.readouterr().out
    assert "[serve] 3/3 requests, 9 tokens" in out and "on cpu" in out


def test_launcher_serves_mamba2_on_the_cpu(capsys):
    serve_main(["--arch", "mamba2-1.3b", "--reduced", "--device", "cpu",
                "--requests", "3", "--max-new", "3"])
    out = capsys.readouterr().out
    assert "[serve] 3/3 requests, 9 tokens" in out and "on cpu" in out
