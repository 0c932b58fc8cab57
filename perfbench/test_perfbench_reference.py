"""The plain reference against the port's model run with device="cpu",
at a tiny size, in float32 (where both compute the same arithmetic and
agree to rounding)."""
import pytest
import torch

from perfbench import harness, rehearsal, weights
from perfbench.reference import mamba2_lm as lm


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("workload", ["mamba2-train"])
def test_reference_forward_equals_the_ports(workload):
    from repro_torch.models import model as model_lib
    config, _ = rehearsal.tiny(workload, dtype="float32")
    cfg = harness.program_config(config)
    seed = 2 ** 33 + 1
    params = weights.program_tree(model_lib.leaf_tree(cfg), seed, "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 24),
                           generator=torch.Generator().manual_seed(0))
    got = model_lib.forward(params, cfg, {"tokens": tokens})
    z = lm.Sizes(config["sizes"])
    lw = [lm.layer_weights(z, seed, i, s, torch.float32, "cpu")
          for i, s in z.layers()]
    top = lm.top_weights(z, seed, torch.float32, "cpu")
    with lm.exact_matmuls():
        want = lm.forward(lw, top, z, tokens)
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


def test_ssd_scan_equals_the_recurrence():
    g = torch.Generator().manual_seed(1)
    b, S, H, P, N = 2, 13, 4, 3, 5
    x = torch.randn(b, S, H, P, generator=g)
    dt = torch.rand(b, S, H, generator=g) * 0.5
    A = -torch.rand(H, generator=g) * 2
    B = torch.randn(b, S, 1, N, generator=g)
    C = torch.randn(b, S, 1, N, generator=g)
    D = torch.randn(H, generator=g)
    y = lm.ssd_scan(x, dt, A, B, C, D, chunk=4)
    state = torch.zeros(b, H, P, N)
    for t in range(S):
        state = (torch.exp(dt[:, t] * A)[..., None, None] * state
                 + (dt[:, t, :, None] * x[:, t])[..., None]
                 * B[:, t, 0, None, None, :])
        want = torch.einsum("bhpn,bn->bhp", state, C[:, t, 0]) \
            + D[:, None] * x[:, t]
        assert torch.allclose(y[:, t], want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("workload", ["mamba2-train"])
def test_a_float32_rehearsal_agrees_with_the_reference(workload):
    """The whole check at float32: the reference's three steps agree
    with the program's to rounding."""
    record, line = rehearsal.rehearse(workload, dtype="float32")
    assert line["correct"]
    assert record["gaps"]["grad_gap"] < 1e-3
    assert record["gaps"]["change_gap"] < 1e-2
