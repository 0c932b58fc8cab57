"""The optimizer (train/optimizer.py adamw_update): the device time a
step of the kernels launched under the program's "optimizer" profiler
label."""

LAYER = "optimizer (train/optimizer.py adamw_update)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "train_tokens_per_s"
WORKLOADS = ["mamba2-train"]


def read(record):
    prof = record.get("profile")
    if not prof or "optimizer" not in prof["by_label"]:
        return None
    return 1e3 * prof["by_label"]["optimizer"] / record["profile_steps"]
