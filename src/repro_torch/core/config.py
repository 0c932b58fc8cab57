"""Provisioner configuration: the paper's INI file format (§3, Fig 1).

Example (verbatim structure from the paper)::

    [DEFAULT]
    k8s_domain=nrp-nautilus.io

    [k8s]
    tolerations_list=nautilus.io/noceph, nautilus.io/suncave
    node_affinity_dict=^nautilus.io/low-power:true,gpu-type:A100|A40|V100
    priority_class=opportunistic
    envs_dict=USE_SINGULARITY:no,GLIDEIN_Site:SDSC-PRP

Conventions reproduced from the paper's configurator:
  *_list   — comma-separated values
  *_dict   — comma-separated key:value pairs; values may be |-alternatives
             (sets); a leading ^ on a key negates the match (anti-affinity)

The [provision] section adds the scaling knobs (filter, limits, timing) and
[condor] the pool endpoint — in the real deployment the HTCondor secret and
central-manager address arrive via k8s secret/env (§3); here they are just
fields.

Federation extension (backend API): any number of `[backend:<name>]`
sections declare resource providers — each with its own node template,
limits, priority class, and cost — consumed by
`repro_torch.core.backend.build_backends`.  The paper's Fig-1 single-section
format stays valid: no `[backend:*]` section means one default backend
wrapping whatever cluster the caller supplies.  `[provision]` gains
`routing_policy` (fill-first | cheapest-first | weighted-spread |
spot-with-fallback) to pick how deficits split across backends.
"""
from __future__ import annotations

import configparser
import dataclasses
from typing import Any

from repro_torch.core.classad import ClassAdExpr


def _parse_list(s: str) -> tuple[str, ...]:
    return tuple(x.strip() for x in s.split(",") if x.strip())


def _parse_dict(s: str) -> dict[str, Any]:
    out: dict[str, Any] = {}
    for item in s.split(","):
        item = item.strip()
        if not item:
            continue
        key, _, val = item.partition(":")
        key = key.strip()
        alts = tuple(v.strip() for v in val.split("|"))
        out[key] = alts[0] if len(alts) == 1 else alts
    return out


def _parse_num_dict(s: str) -> dict[str, float]:
    return {k: float(v) for k, v in _parse_dict(s).items()}


def _fmt_dict(d: dict) -> str:
    parts = []
    for k, v in d.items():
        if isinstance(v, (list, tuple, set)):
            v = "|".join(str(x) for x in v)
        elif isinstance(v, float) and v == int(v):
            v = int(v)
        parts.append(f"{k}:{v}")
    return ",".join(parts)


@dataclasses.dataclass
class BackendConfig:
    """One `[backend:<name>]` INI section: a resource provider's node
    template, limits, placement policy, and cost model."""
    name: str = "default"
    kind: str = "static"                     # static | autoscale
    nodes: int = 0                           # static: pool size at t=0
    capacity: dict[str, float] = dataclasses.field(
        default_factory=lambda: {"cpu": 64.0, "gpu": 8.0,
                                 "memory": 512.0, "disk": 1024.0})
    node_labels: dict[str, str] = dataclasses.field(default_factory=dict)
    taints: tuple[str, ...] = ()
    max_nodes: int = 64                      # autoscale: node cap
    max_pods: int = 1_000_000                # provider-level pod cap
    provision_delay_s: float = 90.0
    scale_down_delay_s: float = 600.0
    node_hourly_cost: float = 0.0            # 0 ⇒ sunk / donated (on-prem)
    pod_hourly_cost: float = 0.0             # per-pod surcharge (spot bids)
    priority_class: str = ""                 # "" ⇒ inherit [k8s]
    tolerations: tuple[str, ...] = ()
    node_affinity: dict[str, Any] = dataclasses.field(default_factory=dict)
    spot: bool = False                       # reclaimable capacity
    weight: float = 1.0                      # weighted-spread share


@dataclasses.dataclass
class ProvisionerConfig:
    # [condor]
    central_manager: str = "cm.local"
    token_secret: str = "condor-token"           # k8s secret name (§3)

    # [provision]
    job_filter: str = ""                          # ClassAd expr (C3)
    max_pods_per_group: int = 64
    max_total_pods: int = 256
    submit_interval_s: float = 60.0               # reconciliation period
    idle_timeout_s: float = 300.0                 # worker self-term (C2)
    startup_delay_s: float = 30.0
    group_extra_keys: tuple[str, ...] = ("arch",)
    routing_policy: str = "fill-first"            # backend deficit split
    matchmaker: str = "numpy"                     # negotiation backend
    #   ("numpy" reference | "jax" jitted | "pallas" fused kernel |
    #    "scan" per-job oracle; see core/matchmaker)
    negotiation_batch: int = 1                    # staged cycles per fused
    #   flush (1 = negotiate every cycle immediately; >1 batches K
    #   consecutive cycles through the backend's fused multi-cycle jit)

    # [backend:<name>] sections (empty ⇒ single default backend)
    backends: tuple[BackendConfig, ...] = ()

    # [k8s] (Fig 1)
    k8s_domain: str = "nrp-nautilus.io"
    namespace: str = "osg-pool"
    image: str = "centos:htcondor-execute-gpu"    # default execute image
    priority_class: str = "opportunistic"
    tolerations: tuple[str, ...] = ()
    node_affinity: dict[str, Any] = dataclasses.field(default_factory=dict)
    envs: dict[str, str] = dataclasses.field(default_factory=dict)
    storage: dict[str, str] = dataclasses.field(default_factory=dict)

    def filter_expr(self) -> ClassAdExpr:
        return ClassAdExpr(self.job_filter)

    def start_expr(self) -> ClassAdExpr:
        """The pushed-down execute-side START policy (C3): same filter the
        provisioner counts with, evaluated worker-side against the job ad
        (worker ad is MY, job ad is TARGET)."""
        return ClassAdExpr(self.job_filter)


def load_ini(text: str) -> ProvisionerConfig:
    cp = configparser.ConfigParser()
    cp.read_string(text)
    cfg = ProvisionerConfig()

    if cp.has_section("condor") or "condor" in cp:
        sec = cp["condor"]
        cfg.central_manager = sec.get("central_manager", cfg.central_manager)
        cfg.token_secret = sec.get("token_secret", cfg.token_secret)

    if "provision" in cp:
        sec = cp["provision"]
        cfg.job_filter = sec.get("job_filter", cfg.job_filter)
        cfg.max_pods_per_group = sec.getint(
            "max_pods_per_group", cfg.max_pods_per_group)
        cfg.max_total_pods = sec.getint("max_total_pods", cfg.max_total_pods)
        cfg.submit_interval_s = sec.getfloat(
            "submit_interval_s", cfg.submit_interval_s)
        cfg.idle_timeout_s = sec.getfloat("idle_timeout_s", cfg.idle_timeout_s)
        cfg.startup_delay_s = sec.getfloat(
            "startup_delay_s", cfg.startup_delay_s)
        if sec.get("group_extra_keys_list"):
            cfg.group_extra_keys = _parse_list(sec["group_extra_keys_list"])
        cfg.routing_policy = sec.get("routing_policy", cfg.routing_policy)
        cfg.matchmaker = sec.get("matchmaker", cfg.matchmaker)
        cfg.negotiation_batch = sec.getint(
            "negotiation_batch", cfg.negotiation_batch)

    if "k8s" in cp:
        sec = cp["k8s"]
        cfg.k8s_domain = sec.get("k8s_domain", cfg.k8s_domain)
        cfg.namespace = sec.get("namespace", cfg.namespace)
        cfg.image = sec.get("image", cfg.image)
        cfg.priority_class = sec.get("priority_class", cfg.priority_class)
        if sec.get("tolerations_list"):
            cfg.tolerations = _parse_list(sec["tolerations_list"])
        if sec.get("node_affinity_dict"):
            cfg.node_affinity = _parse_dict(sec["node_affinity_dict"])
        if sec.get("envs_dict"):
            cfg.envs = {k: str(v) for k, v in
                        _parse_dict(sec["envs_dict"]).items()}
        if sec.get("storage_dict"):
            cfg.storage = {k: str(v) for k, v in
                           _parse_dict(sec["storage_dict"]).items()}

    backends = []
    for section in cp.sections():
        if not section.startswith("backend:"):
            continue
        backends.append(_load_backend_section(
            section.split(":", 1)[1], cp[section]))
    cfg.backends = tuple(backends)
    return cfg


def _load_backend_section(name: str, sec) -> BackendConfig:
    bc = BackendConfig(name=name)
    bc.kind = sec.get("kind", bc.kind)
    bc.nodes = sec.getint("nodes", bc.nodes)
    if sec.get("capacity_dict"):
        bc.capacity = _parse_num_dict(sec["capacity_dict"])
    if sec.get("node_labels_dict"):
        bc.node_labels = {k: str(v) for k, v in
                          _parse_dict(sec["node_labels_dict"]).items()}
    if sec.get("taints_list"):
        bc.taints = _parse_list(sec["taints_list"])
    bc.max_nodes = sec.getint("max_nodes", bc.max_nodes)
    bc.max_pods = sec.getint("max_pods", bc.max_pods)
    bc.provision_delay_s = sec.getfloat(
        "provision_delay_s", bc.provision_delay_s)
    bc.scale_down_delay_s = sec.getfloat(
        "scale_down_delay_s", bc.scale_down_delay_s)
    bc.node_hourly_cost = sec.getfloat(
        "node_hourly_cost", bc.node_hourly_cost)
    bc.pod_hourly_cost = sec.getfloat(
        "pod_hourly_cost", bc.pod_hourly_cost)
    bc.priority_class = sec.get("priority_class", bc.priority_class)
    if sec.get("tolerations_list"):
        bc.tolerations = _parse_list(sec["tolerations_list"])
    if sec.get("node_affinity_dict"):
        bc.node_affinity = _parse_dict(sec["node_affinity_dict"])
    bc.spot = sec.getboolean("spot", bc.spot)
    bc.weight = sec.getfloat("weight", bc.weight)
    return bc


def dump_ini(cfg: ProvisionerConfig) -> str:
    """Inverse of `load_ini` — lets a multi-backend deployment be
    captured back to the paper's INI format for audit/diffing.

    Round-trip safe within the paper's configurator conventions: dict
    values must not contain the ``,``/``:`` separators (the format has
    no escaping — same restriction as the paper's own Fig-1 files), and
    an explicitly-empty ``group_extra_keys`` reloads as the default."""
    lines = [
        "[condor]",
        f"central_manager={cfg.central_manager}",
        f"token_secret={cfg.token_secret}",
        "",
        "[provision]",
        f"job_filter={cfg.job_filter}",
        f"max_pods_per_group={cfg.max_pods_per_group}",
        f"max_total_pods={cfg.max_total_pods}",
        f"submit_interval_s={cfg.submit_interval_s}",
        f"idle_timeout_s={cfg.idle_timeout_s}",
        f"startup_delay_s={cfg.startup_delay_s}",
        f"group_extra_keys_list={','.join(cfg.group_extra_keys)}",
        f"routing_policy={cfg.routing_policy}",
        f"matchmaker={cfg.matchmaker}",
        f"negotiation_batch={cfg.negotiation_batch}",
        "",
        "[k8s]",
        f"k8s_domain={cfg.k8s_domain}",
        f"namespace={cfg.namespace}",
        f"image={cfg.image}",
        f"priority_class={cfg.priority_class}",
    ]
    if cfg.tolerations:
        lines.append(f"tolerations_list={','.join(cfg.tolerations)}")
    if cfg.node_affinity:
        lines.append(f"node_affinity_dict={_fmt_dict(cfg.node_affinity)}")
    if cfg.envs:
        lines.append(f"envs_dict={_fmt_dict(cfg.envs)}")
    if cfg.storage:
        lines.append(f"storage_dict={_fmt_dict(cfg.storage)}")
    for bc in cfg.backends:
        lines += [
            "",
            f"[backend:{bc.name}]",
            f"kind={bc.kind}",
            f"nodes={bc.nodes}",
            f"capacity_dict={_fmt_dict(bc.capacity)}",
            f"max_nodes={bc.max_nodes}",
            f"max_pods={bc.max_pods}",
            f"provision_delay_s={bc.provision_delay_s}",
            f"scale_down_delay_s={bc.scale_down_delay_s}",
            f"node_hourly_cost={bc.node_hourly_cost}",
            f"pod_hourly_cost={bc.pod_hourly_cost}",
            f"spot={'true' if bc.spot else 'false'}",
            f"weight={bc.weight}",
        ]
        if bc.node_labels:
            lines.append(f"node_labels_dict={_fmt_dict(bc.node_labels)}")
        if bc.taints:
            lines.append(f"taints_list={','.join(bc.taints)}")
        if bc.priority_class:
            lines.append(f"priority_class={bc.priority_class}")
        if bc.tolerations:
            lines.append(f"tolerations_list={','.join(bc.tolerations)}")
        if bc.node_affinity:
            lines.append(
                f"node_affinity_dict={_fmt_dict(bc.node_affinity)}")
    return "\n".join(lines) + "\n"


PAPER_EXAMPLE_INI = """\
[DEFAULT]
k8s_domain=nrp-nautilus.io

[k8s]
tolerations_list=nautilus.io/noceph, nautilus.io/suncave
node_affinity_dict=^nautilus.io/low-power:true,gpu-type:A100|A40|V100
priority_class=opportunistic
envs_dict=USE_SINGULARITY:no,GLIDEIN_Site:SDSC-PRP
"""
