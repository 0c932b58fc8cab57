"""The SSD backward kernel (kernels/ssd/ssd_bwd.cu): the least time of a
step's SSD backward calls (`perfbench.work.costs.ssd_bwd_cost`, one a
layer at the batch's shape) over the profiler's device time of the
backward kernels, over the profiled steps."""
from perfbench.harness import kernel_seconds
from perfbench.work.costs import ssd_bwd_cost
from perfbench.work.peaks import bound_s

LAYER = "SSD backward kernel (kernels/ssd/ssd_bwd.cu)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_tokens_per_s"
WORKLOADS = ["mamba2-train"]
KERNELS = ("ssd_bwd",)


def read(record):
    prof = record.get("profile")
    if not prof:
        return None
    device = kernel_seconds(prof, *KERNELS)
    if device <= 0:
        return None
    s, job = record["config"]["sizes"], record["traffic"]
    c = s["ssm"]
    H = c["expand"] * s["d_model"] // c["head_dim"]
    least = s["n_layers"] * record["profile_steps"] * bound_s(*ssd_bwd_cost(
        job["batch"], job["seq"], H, c["head_dim"], c["ngroups"],
        c["d_state"], c["chunk"], 2, False, False))
    return 100.0 * least / device
