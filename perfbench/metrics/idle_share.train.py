"""The device: the share of a step that no kernel covers, without the
profiler's cost.  The profiled steps give the device's busy time a step
(the union of their kernels' intervals); the window's untraced steps,
each ending in a synchronise, give a step's time on the host's clock.
The profiler's own host cost stretches the profiled steps themselves,
so their length is not the divisor."""

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_tokens_per_s"
WORKLOADS = ["mamba2-train"]


def read(record):
    prof = record.get("profile")
    if not prof or not prof["kernels"]:
        return None
    busy = prof["busy_s"] / record["profile_steps"]
    step = record["window_s"] / record["steps"]
    return 100.0 * (1.0 - busy / step)
