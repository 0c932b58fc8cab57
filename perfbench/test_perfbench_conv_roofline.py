"""`conv_roofline.train` on synthetic profile records: the share worked by
hand at the cell's shape, and nothing where no causal conv kernel ran."""
import pytest

from perfbench import harness

READER = harness.load_module("metrics", "conv_roofline.train")
CONFIG = harness.load_json("configs", "mamba2-1.3b")
TRAFFIC = harness.load_json("traffic", "train-8x512")


def record(by_kernel: dict, steps: int = 3) -> dict:
    return {"profile": {"by_kernel": by_kernel}, "profile_steps": steps,
            "config": CONFIG, "traffic": TRAFFIC}


def test_share_at_the_cells_shape_by_hand():
    # 8 x 512 rows of C = 4096 + 2 x 128 bf16 channels, 4 taps: a layer's
    # forward and backward move 5 B S C + 3 K C + 2 C elements of 2 bytes
    B, S, C, K = 8, 512, 4352, 4
    nbytes = (5 * B * S * C + 3 * K * C + 2 * C) * 2
    assert nbytes == 178_379_776
    per_step = 48 * nbytes / 3.35e12       # bytes bound: FLOPs take 0.4 us
    assert per_step == pytest.approx(2.556e-3, rel=1e-3)
    fwd, bwd = 3 * 1.8e-3, 3 * 3.3e-3      # seconds over 3 profiled steps
    got = READER.read(record({
        "void (anonymous namespace)::causal_conv_fwd_kernel<b, 8, 4>": fwd,
        "void (anonymous namespace)::causal_conv_bwd_kernel<b, 4, 4>": bwd,
        "elementwise_kernel": 1.0}))
    assert got == pytest.approx(100 * 3 * per_step / (fwd + bwd))
    assert 49 < got < 51


@pytest.mark.parametrize("rec", [
    {"profile": None},
    record({"vectorized_elementwise_kernel<4>": 0.5,
            "ssd_bwd_keys_wgmma": 0.02}),
])
def test_reads_nothing_where_no_conv_kernel_ran(rec):
    assert READER.read(rec) is None
