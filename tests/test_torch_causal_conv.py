"""The Mamba mixer's causal conv and its SiLU (`kernels.causal_conv`).

On the CPU: the wrapper is the plain version (`ref.causal_conv_silu`,
the model's code before the kernel) bit for bit, forward and gradients;
the dry-run records a site each way and launches nothing; the dry-run's
prices and the config's sites; the entry points refuse what the kernels
do not take.  Marked
``cuda`` (skip without a card): chip_smoke's `CONV_CASES` in both dtypes
-- the forward bit for bit the plain version's, dx, dw and db within
`CONV_TOL` of autograd's through it, two backward calls bitwise equal, one
launch each way a call -- and autograd through the wrapper.  Imports
nothing of JAX.
"""
import dataclasses

import pytest
import torch

import chip_smoke
from repro_torch.configs import get_config
from repro_torch.configs.shapes import ShapeCell
from repro_torch.kernels.build import launch_counts
from repro_torch.kernels.causal_conv import ops as cc
from repro_torch.kernels.causal_conv import ref
from repro_torch.launch import dryrun
from repro_torch.launch import roofline_adjust as ra

DTYPES = (torch.float32, torch.bfloat16)
CPU = torch.device("cpu")
#: CPU cases (B, S, C, K, layout), chip_smoke's layouts at small sizes
CPU_CASES = [(2, 13, 24, 4, "proj"), (1, 1, 10, 4, "odd"),
             (2, 9, 16, 3, "dense"), (3, 5, 8, 1, "proj")]


def conv_leaves(case, dtype, seed=0):
    """chip_smoke's inputs on the CPU: x's base (x itself where it is
    contiguous), x as a view of it, w and b, each of the three leaves
    requiring grad, and dy."""
    x, w, b, dy = chip_smoke.conv_inputs(case, dtype, CPU, seed)
    base = (x if x._base is None else x._base).detach().requires_grad_()
    view = base.as_strided(x.shape, x.stride(), x.storage_offset())
    return base, view, w.detach().requires_grad_(), \
        b.detach().requires_grad_(), dy


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", CPU_CASES, ids=str)
def test_cpu_calls_are_the_plain_version_bit_for_bit(case, dtype):
    """On CPU tensors the wrapper runs the model's code before the kernel:
    the same output and, through autograd, the same gradients, bit for
    bit, and no launch."""
    before = dict(launch_counts)
    got_leaves = conv_leaves(case, dtype)
    want_leaves = conv_leaves(case, dtype)
    y = cc.causal_conv_silu(*got_leaves[1:4])
    want = ref.causal_conv_silu(*want_leaves[1:4])
    assert y.dtype == dtype and torch.equal(y, want)
    dy = got_leaves[4]
    got = torch.autograd.grad(y, (got_leaves[0], *got_leaves[2:4]), dy)
    exp = torch.autograd.grad(want, (want_leaves[0], *want_leaves[2:4]), dy)
    for g, e in zip(got, exp):
        assert g.dtype == e.dtype and torch.equal(g, e)
    assert launch_counts == before


def test_plain_version_is_the_shifted_sum():
    """The plain version (float32 sums) against the definition in float64:
    y_t = silu(sum_k x_{t-K+1+k} w_k + b), rows before the sequence 0."""
    g = torch.Generator().manual_seed(3)
    B, S, C, K = 2, 7, 5, 4
    x = torch.randn(B, S, C, generator=g, dtype=torch.float64)
    w = torch.randn(K, C, generator=g, dtype=torch.float64)
    b = torch.randn(C, generator=g, dtype=torch.float64)
    got = ref.causal_conv_silu(x.float(), w.float(), b.float())
    want = torch.empty_like(x)
    for t in range(S):
        acc = b.clone()
        for k in range(K):
            s = t - (K - 1) + k
            if s >= 0:
                acc = acc + x[:, s] * w[k]
        want[:, t] = acc / (1 + torch.exp(-acc))
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-6)


def test_dry_run_records_a_site_each_way_and_launches_nothing():
    """Under the dry-run's recorder the wrapper hands its call over before
    it looks at the device: outputs of the right shapes and dtypes, a
    "causal_conv" site and, through autograd, a "causal_conv_bwd" one,
    and nothing launched or run."""
    before = dict(launch_counts)
    base, x, w, b, dy = conv_leaves((2, 6, 16, 4, "proj"), torch.bfloat16)
    with dryrun.recording(dryrun.OpCounter()) as counter:
        y = cc.causal_conv_silu(x, w, b)
        grads = torch.autograd.grad(y, (base, w, b), dy)
        with torch.no_grad():
            cc.causal_conv_silu(x, w, b)
    assert y.shape == x.shape and y.dtype == x.dtype
    assert [g.shape for g in grads] == [base.shape, w.shape, b.shape]
    assert [g.dtype for g in grads] == [torch.bfloat16] * 3
    site = ra.Site("causal_conv", (2, 6, 16, 4), "bfloat16")
    assert counter.sites == [site, dataclasses.replace(
        site, kernel="causal_conv_bwd"), site]
    assert launch_counts == before


def test_conv_prices_by_hand():
    """The dry-run's kernel model of a call (`conv_cost`, `conv_bwd_cost`)
    and the plain version's calibrated cost, which moves more bytes."""
    B, S, C, K = 8, 512, 4352, 4
    site = ra.Site("causal_conv", (B, S, C, K), "bfloat16")
    bwd = dataclasses.replace(site, kernel="causal_conv_bwd")
    assert ra.kernel_cost(site) == ((2 * B * S * C + K * C + C) * 2,
                                    2 * K * B * S * C)
    assert ra.kernel_cost(bwd) == ((3 * B * S * C + 2 * K * C + 2 * C) * 2,
                                   4 * K * B * S * C)
    # the cell's bound for 48 layers a step, forward and backward: 2.55 ms
    per_step = 48 * sum(ra.bound_ms(*ra.kernel_cost(s), torch.bfloat16)[0]
                        for s in (site, bwd))
    assert per_step == pytest.approx(2.556, abs=1e-3)
    for s in (site, bwd):
        assert ra.plain_cost(s)[0] > 2 * ra.kernel_cost(s)[0]


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_config_sites_hold_a_conv_each_mamba_layer(kind):
    """`config_sites` prices each Mamba layer's conv at its channels
    (d_inner + 2 G N), forward and, training, backward (and the
    recomputed forward under remat "full"); decode runs none."""
    cfg = get_config("mamba2-1.3b")
    cell = ShapeCell("c", kind, 512, 8)
    s = cfg.ssm
    C = s.d_inner(cfg.d_model) + 2 * s.ngroups * s.d_state
    assert C == 4352
    sites = [x for x in ra.config_sites(cfg, cell) if
             x.kernel.startswith("causal_conv")]
    want = {"train": {"causal_conv": 96, "causal_conv_bwd": 48},
            "prefill": {"causal_conv": 48}, "decode": {}}[kind]
    assert {k: sum(x.kernel == k for x in sites) for k in want} == want
    assert len(sites) == sum(want.values())
    assert all(x.shape == (8, 512, C, 4) and x.dtype == "bfloat16"
               for x in sites)


def _refused(name):
    """Inputs the entry points refuse: float16; 5 taps; taps of another
    width; x strided in its channels; and, valid otherwise, CPU tensors."""
    x, w, b, dy = chip_smoke.conv_inputs((1, 6, 8, 4, "dense"),
                                         torch.float32, CPU)
    return {"float16": (x.half(), w, b, dy),
            "five_taps": (x, torch.zeros(5, 8), b, dy),
            "taps_width": (x, w[:, :4], b, dy),
            "strided": (x.transpose(1, 2).contiguous().transpose(1, 2), w, b,
                        dy),
            "cpu": (x, w, b, dy)}[name]


@pytest.mark.parametrize("name,error,match", [
    ("float16", TypeError, "float32 or bfloat16"),
    ("five_taps", ValueError, "1 to 4 taps"),
    ("taps_width", ValueError, "do not match"),
    ("strided", ValueError, "contiguous in its last axis"),
    ("cpu", ValueError, "no kernel"),
])
def test_the_entry_points_refuse_what_the_kernels_do_not_take(name, error,
                                                               match):
    """The CUDA entry points raise, and never fall back, on what the
    kernels do not take (checked before anything is built)."""
    x, w, b, dy = _refused(name)
    with pytest.raises(error, match=match):
        cc.causal_conv_forward(x, w, b)
    with pytest.raises(error, match=match):
        cc.causal_conv_backward(x, w, b, dy)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", chip_smoke.CONV_CASES, ids=str)
def test_kernels_against_the_plain_version_on_the_card(cuda, case, dtype):
    row = chip_smoke.check_conv(cc, case, dtype, cuda)
    assert max(row[n] for n in ("dx", "dw", "db")) <= chip_smoke.CONV_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_autograd_through_the_wrapper_on_the_card(cuda, dtype):
    """A call autograd records goes through `CausalConvFn`: one forward
    and one backward launch, the forward's output and the gradients of
    the view's base, w and b those of the entry points called directly."""
    case = (2, 64, 4352, 4, "proj")
    x, w, b, dy = chip_smoke.conv_inputs(case, dtype, cuda, seed=9)
    base = x._base.detach().requires_grad_()
    view = base[..., 4352:2 * 4352]
    leaves = (base, w.detach().requires_grad_(), b.detach().requires_grad_())
    before = dict(launch_counts)
    y = cc.causal_conv_silu(view, *leaves[1:])
    grads = torch.autograd.grad(y, leaves, dy)
    assert {k: launch_counts[k] - before[k] for k in (
        "causal_conv", "causal_conv_bwd")} == {"causal_conv": 1,
                                               "causal_conv_bwd": 1}
    assert torch.equal(y, cc.causal_conv_forward(x, w, b))
    dx, dw, db = cc.causal_conv_backward(x, w, b, dy)
    assert torch.equal(grads[0][..., 4352:2 * 4352], dx)
    assert not grads[0][..., :4352].any() and not grads[0][..., 8704:].any()
    assert torch.equal(grads[1], dw) and torch.equal(grads[2], db)
