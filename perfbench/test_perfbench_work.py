"""The frozen work counts against counts worked by hand."""
import pytest

from perfbench.work import costs, model_flops, peaks


def test_ssd_bwd_cost_by_hand():
    assert costs.ssd_bwd_flops(2, 4, 1, 1, 1) == 6 + 6 * 2 * 2 + 8 * 2
    nbytes, _ = costs.ssd_bwd_cost(1, 2, 1, 1, 1, 1, 2, 2, False, False)
    assert nbytes == 3 * 2 * 2 + 4 * 2 * 2 + 2 * 2 * 4 + 16 + 0


def test_bound_takes_the_larger_term():
    assert peaks.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert peaks.bound_s(0, 989e12) == pytest.approx(1.0)


def test_token_flops_by_hand():
    s = {"family": "ssm", "n_layers": 2, "d_model": 4, "vocab_size": 10,
         "ssm": {"d_state": 2, "d_conv": 4, "expand": 2, "head_dim": 4,
                 "ngroups": 1}}
    # a layer: di 8, H 2, gn 2; in_proj 4 -> 22, out_proj 8 -> 4, the
    # conv over 12 channels, the recurrence 4 P N a head
    layer = 2 * 4 * 22 + 2 * 8 * 4 + 2 * 4 * 12 + 4 * 2 * 4 * 2
    assert model_flops.token_flops(s) == 2 * layer + 2 * 4 * 10


def test_token_flops_refuses_another_family():
    with pytest.raises(ValueError):
        model_flops.token_flops({"family": "hybrid"})
