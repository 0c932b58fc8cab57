"""What every cell's run shares: finding its files by name, the program's
configuration, the profiler's reduction, and the result line."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BENCH = Path(__file__).resolve().parent
#: top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(kind: str, name: str) -> dict:
    return json.loads((BENCH / kind / f"{name}.json").read_text())


def load_module(kind: str, name: str):
    """``perfbench/<kind>/<name>.py`` (a name may hold dots)."""
    path = BENCH / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def metrics_for(bench: dict, workload: str, kind: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics that ``workload``
    reports."""
    return [m for m in bench[kind]
            if "workloads" not in m or workload in m["workloads"]]


def forbidden_modules(names=None) -> list[str]:
    """The forbidden whole top-level names among ``names`` (by default
    the loaded modules')."""
    names = list(sys.modules) if names is None else names
    return sorted({n.split(".", 1)[0] for n in names
                   if n.split(".", 1)[0] in FORBIDDEN})


# ---------------------------------------------------------------------------
# the program's configuration
# ---------------------------------------------------------------------------

def program_config(config: dict):
    """The program's `ModelConfig` for a configuration file: its named
    configuration with the file's ``overrides``, held to every size the
    file states."""
    from repro_torch.configs import get_config

    cfg = get_config(config["model"])
    over = {k: (dataclasses.replace(getattr(cfg, k), **v)
                if isinstance(v, dict) else v)
            for k, v in config.get("overrides", {}).items()}
    cfg = dataclasses.replace(cfg, **over)
    have = dataclasses.asdict(cfg)

    def held(want: dict, got: dict, where: str):
        for k, v in want.items():
            if isinstance(v, dict):
                held(v, got[k] or {}, f"{where}{k}.")
            elif got.get(k) != v:
                raise ValueError(f"the program's {where}{k} is {got.get(k)!r}"
                                 f", the configuration states {v!r}")
    held(config["sizes"], have, "")
    return cfg


# ---------------------------------------------------------------------------
# the profiler's trace
# ---------------------------------------------------------------------------

def activities(cuda: bool) -> list:
    from torch.profiler import ProfilerActivity
    return [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                     else [])


def _annotation(e) -> bool:
    """A user annotation's mirror on the device's timeline."""
    for attr in ("activity_type", "is_user_annotation"):
        if hasattr(e, attr):
            v = getattr(e, attr)()
            return "annotation" in v if isinstance(v, str) else bool(v)
    return False


def _start_end(e) -> tuple[float, float]:
    """(start, end) of a kineto event in seconds."""
    try:
        start = e.start_ns() * 1e-9
        return start, start + e.duration_ns() * 1e-9
    except AttributeError:
        start = e.start_us() * 1e-6
        return start, start + e.duration_us() * 1e-6


def trace_summary(prof, labels: tuple[str, ...], window_s: float) -> dict:
    """Device kernels of a profiled window: their busy time (the union of
    their intervals), time by kernel name, time by the innermost of the
    harness's ``labels`` spans that launched them, and the idle gaps
    between them, each charged to the innermost span that the host was
    in at the gap's middle."""
    from torch.autograd import DeviceType

    kernels, spans, launches = [], [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            # kernels, copies and fills; not the labels' mirrors on the
            # device's timeline
            if e.name() not in labels and not _annotation(e):
                kernels.append((*_start_end(e), e.name(),
                                e.correlation_id()))
        elif e.name() in labels:
            spans.append((*_start_end(e), e.name()))
        elif e.name().startswith("cu"):          # the runtime's calls
            launches[e.correlation_id()] = _start_end(e)[0]
    kernels.sort()
    spans.sort(key=lambda x: x[1] - x[0])

    def label_at(t):
        return next((n for s, u, n in spans if s <= t <= u), "other")

    by_name: dict[str, float] = {}
    by_label: dict[str, float] = {}
    busy, gaps, reach = 0.0, [], None
    for s, t, name, corr in kernels:
        by_name[name] = by_name.get(name, 0.0) + (t - s)
        at = launches.get(corr)
        lab = label_at(at) if at is not None else "other"
        by_label[lab] = by_label.get(lab, 0.0) + (t - s)
        if reach is None or s > reach:
            if reach is not None:
                gaps.append((reach, s))
            busy += t - s
            reach = t
        elif t > reach:
            busy += t - reach
            reach = t
    idle: dict[str, float] = {}
    for a, b in gaps:
        lab = label_at(0.5 * (a + b))
        idle[lab] = idle.get(lab, 0.0) + (b - a)
    if kernels:
        first, last = kernels[0][0], max(k[1] for k in kernels)
        edge = max(window_s - (last - first), 0.0)
        if edge:
            idle["before the first or after the last kernel"] = edge
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {"busy_s": busy, "window_s": window_s, "by_kernel": by_name,
            "by_label": by_label,
            "device_ops": [[n[:120], s] for n, s in top[:10]],
            "idle_gaps": sorted(([k, v] for k, v in idle.items()),
                                key=lambda kv: -kv[1])[:10],
            "kernels": len(kernels)}


def kernel_seconds(summary: dict, *parts: str) -> float:
    """Device seconds of the kernels whose name holds one of ``parts``."""
    return sum(s for n, s in summary["by_kernel"].items()
               if any(p in n for p in parts))


# ---------------------------------------------------------------------------
# the result
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Check:
    """A number compared for ``correct``: correct while it is at most
    its limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit
