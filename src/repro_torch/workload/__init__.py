"""Workload subsystem: trace schema, synthetic generators, streaming
replay, and the policy-comparison harness.

This package is the single source of DEMAND for simulations, benchmarks,
and examples — the control plane under test lives in `repro_torch.core`; what
flows through it is defined here.  CLI: ``python -m repro_torch.workload
generate|replay|compare`` (see __main__.py).
"""
from repro_torch.workload.trace import (
    FIELDS, Trace, TraceError, TraceRecord, iter_jsonl, open_trace_stream,
    split_records, split_trace,
)
from repro_torch.workload.generators import (
    DAY_S, JobKind, OSG_KINDS, PRESETS, arrival_times, diurnal_day,
    diurnal_profile, generate_preset, lognormal_runtimes, pareto_runtimes,
    poisson_arrivals, synthesize, uniform_burst, zipf_users,
)
from repro_torch.workload.replay import (
    ReplayStats, TraceReplayer, replay_flock, replay_trace,
    submit_trace_upfront,
)
from repro_torch.workload.compare import (
    FEDERATION_INI, PolicySpec, compare, comparison_table, run_policy,
    standard_policies, standard_policy,
)

__all__ = [
    "FIELDS", "Trace", "TraceError", "TraceRecord", "iter_jsonl",
    "open_trace_stream", "split_records", "split_trace", "replay_flock",
    "DAY_S", "JobKind", "OSG_KINDS", "PRESETS", "arrival_times",
    "diurnal_day", "diurnal_profile", "generate_preset",
    "lognormal_runtimes", "pareto_runtimes", "poisson_arrivals",
    "synthesize", "uniform_burst", "zipf_users",
    "ReplayStats", "TraceReplayer", "replay_trace",
    "submit_trace_upfront",
    "FEDERATION_INI", "PolicySpec", "compare", "comparison_table",
    "run_policy", "standard_policies", "standard_policy",
]
