"""The causal conv kernels (kernels/causal_conv/causal_conv.cu): the least
time of a step's conv calls, forward and backward (`perfbench.work.
conv_cost.conv_cost`, one pair a Mamba layer at the batch's shape), over
the profiler's device time of every kernel whose name holds
``causal_conv``, over the profiled steps.  A program without those
kernels reads nothing."""
from perfbench.harness import kernel_seconds
from perfbench.work.conv_cost import conv_cost
from perfbench.work.peaks import bound_s

LAYER = "causal conv (kernels/causal_conv/causal_conv.cu)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_tokens_per_s"
WORKLOADS = ["mamba2-train"]
KERNELS = ("causal_conv",)


def read(record):
    prof = record.get("profile")
    if not prof:
        return None
    device = kernel_seconds(prof, *KERNELS)
    if device <= 0:
        return None
    s, job = record["config"]["sizes"], record["traffic"]
    c = s["ssm"]
    C = c["expand"] * s["d_model"] + 2 * c["ngroups"] * c["d_state"]
    least = s["n_layers"] * record["profile_steps"] * bound_s(*conv_cost(
        job["batch"], job["seq"], C, c["d_conv"], 2))
    return 100.0 * least / device
