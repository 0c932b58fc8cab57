"""The device: three times the forward model FLOPs of the window's
tokens (`perfbench.work.model_flops`, every position's logits) over the
window and the card's bfloat16 peak."""
from perfbench.work.model_flops import token_flops
from perfbench.work.peaks import BF16_FLOPS_PER_S

LAYER = "device"
UNIT = "%"
SOURCE = "host_clock"
MOVES = "train_tokens_per_s"
WORKLOADS = ["mamba2-train"]


def read(record):
    tokens = record["steps"] * record["tokens_per_step"]
    total = 3 * token_flops(record["config"]["sizes"]) * tokens
    return 100.0 * total / (record["window_s"] * BF16_FLOPS_PER_S)
