"""The cells at a tiny size on the CPU: the same drivers, reference and
result line, with the configuration's widths cut and the program's
kernels' plain versions.  For the tests; never a measurement."""
from __future__ import annotations

import argparse
import copy
import time

from perfbench import harness

#: per configuration: the overrides and the sizes that go with them
TINY = {
    "mamba2-1.3b": {
        "n_layers": 3, "d_model": 64, "vocab_size": 256,
        "ssm": {"d_state": 16, "head_dim": 16, "chunk": 8}},
}
#: per configuration: the limits for ``correct`` at the tiny size, set
#: between the bfloat16 program's readings there (grad_gap 0.0028-0.0131
#: over six seeds) and the float8 control's (0.0318-0.0951)
LIMITS = {
    "mamba2-1.3b": {"train": {"grad_gap": 0.025, "change_gap": 0.25}},
}
TRAFFIC = {
    "train": {"batch": 2, "seq": 32, "pool": 4},
}


def tiny(workload: str, *, dtype: str = "bfloat16"):
    """(config, traffic) of ``workload`` cut to the tiny size, its
    parameters and activations in ``dtype``."""
    cell = harness.cell(harness.benchmark(), workload)
    config = copy.deepcopy(harness.load_json("configs", cell["config"]))
    traffic = harness.load_json("traffic", cell["traffic"])
    over = TINY[cell["config"]]
    sizes = config["sizes"]
    for k, v in over.items():
        if isinstance(v, dict):
            sizes[k].update(v)
        else:
            sizes[k] = v
    sizes.update(param_dtype=dtype, activation_dtype=dtype)
    config["overrides"] = {**over, "param_dtype": dtype,
                           "activation_dtype": dtype}
    config["limits"] = LIMITS[cell["config"]]
    traffic = {**traffic, **TRAFFIC[traffic["driver"]]}
    return config, traffic


def rehearse(workload: str, *, seed: int = 2 ** 31 + 5, seconds: float = 0.6,
             trace: int = 0, dtype: str = "bfloat16", **extra) -> dict:
    """One run of ``workload`` at the tiny size on the CPU: (its record,
    its result line)."""
    import torch
    t0 = time.perf_counter()
    config, traffic = tiny(workload, dtype=dtype)
    driver = harness.load_module("drivers", traffic["driver"])
    args = argparse.Namespace(seed=seed, seconds=seconds, trace=trace,
                              **extra)
    torch.manual_seed(0)
    record = driver.run(args=args, config=config, traffic=traffic,
                        t_process=t0, device="cpu")
    from perfbench.run import result_line
    return record, result_line(harness.benchmark(), workload, trace, record)

