"""Simulated Kubernetes cluster: nodes, pods, priority scheduling, preemption.

This is the environment the paper's provisioner drives.  Faithful to the
mechanisms the paper relies on:

  * pods request {cpu, gpu, memory, disk}; the scheduler bin-packs them
    onto nodes (best-fit by leftover gpu, then cpu)
  * priorityClass (Fig 1: `priority_class=opportunistic`): higher-priority
    pending pods may PREEMPT lower-priority running pods (§5 — batch pods
    run low-priority so service workloads evict them, not vice versa)
  * tolerations / node selectors (Fig 1): a pod only lands on nodes whose
    taints are all tolerated and whose labels satisfy the node affinity
  * node-level failures / spot reclaims (§5): all pods on the node die
  * TPU extension (hardware adaptation): a node models a pod-slice host
    group with `chips`; worker pods request whole sub-slices

The cluster is deliberately control-plane-only: pod "work" happens in
worker.py (HTCondor startd side).  Everything advances via tick(now).

Scale: pods are indexed by phase (PENDING/RUNNING dicts) and running pods
additionally by node, so `pending_pods()`, `running_pods()`, and node
drain are O(result) instead of O(all pods ever).  The scheduler is
event-driven via a dirty flag: a pass only runs when something that could
change placement happened (pod created/stopped, node added/removed) — a
pool with only unplaceable pending pods costs nothing per tick.  Node
busy-resource-seconds integrate lazily at every usage change, so a pod
reclaimed mid-tick is accounted to its exact stop time.
"""
from __future__ import annotations

import dataclasses
import enum
import itertools
from typing import Any, Callable

PRIORITY = {"system": 1000, "production": 100, "default": 50,
            "opportunistic": 10}


class PodPhase(enum.Enum):
    PENDING = "pending"
    RUNNING = "running"
    SUCCEEDED = "succeeded"
    FAILED = "failed"      # includes preempted / node-lost


@dataclasses.dataclass
class Node:
    name: str
    capacity: dict[str, float]          # cpu, gpu, memory, disk, chips
    labels: dict[str, str] = dataclasses.field(default_factory=dict)
    taints: tuple[str, ...] = ()
    created_at: float = 0.0
    # accounting
    busy_integral: dict[str, float] = dataclasses.field(
        default_factory=dict)   # resource-seconds in use
    alive_s: float = 0.0

    def allocatable(self, pods: list["Pod"], *,
                    used: dict[str, float] | None = None
                    ) -> dict[str, float]:
        if used is None:
            used = {}
            for p in pods:
                if p.node == self.name and p.phase == PodPhase.RUNNING:
                    for k, v in p.request.items():
                        used[k] = used.get(k, 0) + v
        return {k: self.capacity.get(k, 0) - used.get(k, 0)
                for k in set(self.capacity) | set(used)}


@dataclasses.dataclass
class Pod:
    name: str
    request: dict[str, float]
    priority_class: str = "default"
    tolerations: tuple[str, ...] = ()
    node_selector: dict[str, Any] = dataclasses.field(default_factory=dict)
    labels: dict[str, str] = dataclasses.field(default_factory=dict)
    on_start: Callable[["Pod", float], None] | None = None
    on_stop: Callable[["Pod", float, str], None] | None = None

    phase: PodPhase = PodPhase.PENDING
    node: str | None = None
    created_at: float = 0.0
    started_at: float = -1.0
    stopped_at: float = -1.0
    stop_reason: str = ""

    @property
    def priority(self) -> int:
        return PRIORITY.get(self.priority_class, 50)


# -- node / pod (de)serialization --------------------------------------------
def node_state(n: Node) -> dict:
    return {
        "name": n.name,
        "capacity": dict(n.capacity),
        "labels": dict(n.labels),
        "taints": list(n.taints),
        "created_at": n.created_at,
        "busy_integral": dict(n.busy_integral),
        "alive_s": n.alive_s,
    }


def node_from_state(s: dict) -> Node:
    return Node(
        name=s["name"],
        capacity=dict(s["capacity"]),
        labels=dict(s.get("labels", {})),
        taints=tuple(s.get("taints", ())),
        created_at=float(s.get("created_at", 0.0)),
        busy_integral=dict(s.get("busy_integral", {})),
        alive_s=float(s.get("alive_s", 0.0)),
    )


def pod_state(p: Pod) -> dict:
    """JSON-safe snapshot.  `on_start`/`on_stop` closures are NOT
    serialized — the provisioner re-wires its own pods on restore
    (`Provisioner.rewire_pods`); foreign pods come back callback-less."""
    return {
        "name": p.name,
        "request": dict(p.request),
        "priority_class": p.priority_class,
        "tolerations": list(p.tolerations),
        "node_selector": {k: (list(v) if isinstance(v, (list, tuple, set))
                              else v)
                          for k, v in p.node_selector.items()},
        "labels": dict(p.labels),
        "phase": p.phase.value,
        "node": p.node,
        "created_at": p.created_at,
        "started_at": p.started_at,
        "stopped_at": p.stopped_at,
        "stop_reason": p.stop_reason,
    }


def pod_from_state(s: dict) -> Pod:
    return Pod(
        name=s["name"],
        request=dict(s["request"]),
        priority_class=s.get("priority_class", "default"),
        tolerations=tuple(s.get("tolerations", ())),
        node_selector={k: (tuple(v) if isinstance(v, list) else v)
                       for k, v in s.get("node_selector", {}).items()},
        labels=dict(s.get("labels", {})),
        phase=PodPhase(s["phase"]),
        node=s.get("node"),
        created_at=float(s.get("created_at", 0.0)),
        started_at=float(s.get("started_at", -1.0)),
        stopped_at=float(s.get("stopped_at", -1.0)),
        stop_reason=s.get("stop_reason", ""),
    )


class KubeCluster:
    def __init__(self, nodes: list[Node] | None = None, *,
                 enable_preemption: bool = True, name: str = "default"):
        self.name = name                    # owning backend (federation)
        self.nodes: dict[str, Node] = {n.name: n for n in (nodes or [])}
        self.pods: dict[str, Pod] = {}
        self.enable_preemption = enable_preemption
        self._ids = itertools.count()
        self.now = 0.0
        self.events: list[tuple[float, str, str]] = []  # (t, kind, detail)
        # incremental per-node usage cache (O(1) allocatable checks)
        self._used: dict[str, dict[str, float]] = {}
        # phase/node indexes (O(result) listings at 100k-pod scale)
        self._pending: dict[str, Pod] = {}
        self._running: dict[str, Pod] = {}
        self._node_pods: dict[str, dict[str, Pod]] = {}
        # lazy busy-integral accounting: last time each node was integrated
        self._acct_t: dict[str, float] = {n: 0.0 for n in self.nodes}
        # scheduler dirty flag: pass runs only when placement could change
        self._dirty = True

    def _account_node(self, name: str, t: float):
        """Integrate a node's alive time AND busy resource-seconds up to
        `t` with the CURRENT usage — called before any usage change, so a
        mid-tick pod stop is accounted at its exact timestamp and
        utilization (busy/alive) can never exceed 1."""
        node = self.nodes.get(name)
        if node is None:
            return
        t0 = self._acct_t.get(name, node.created_at)
        if t > t0:
            node.alive_s += t - t0
            for k, v in self._used.get(name, {}).items():
                if v:
                    node.busy_integral[k] = (
                        node.busy_integral.get(k, 0) + v * (t - t0))
        self._acct_t[name] = max(t0, t)

    def _use(self, node: str, request: dict, sign: float, now: float):
        self._account_node(node, now)
        u = self._used.setdefault(node, {})
        for k, v in request.items():
            u[k] = u.get(k, 0) + sign * v

    def node_used(self, node: str) -> dict[str, float]:
        return dict(self._used.get(node, {}))

    # -- API used by the provisioner (namespaced service account) ----------
    def create_pod(self, pod: Pod, now: float) -> str:
        pod.name = pod.name or f"pod-{next(self._ids)}"
        pod.created_at = now
        self.pods[pod.name] = pod
        if pod.phase == PodPhase.PENDING:
            self._pending[pod.name] = pod
            self._dirty = True
        return pod.name

    def delete_pod(self, name: str, now: float, reason: str = "deleted"):
        pod = self.pods.get(name)
        if pod is None:
            return
        self._stop_pod(pod, now, reason)
        self.pods.pop(name, None)

    def pending_pods(self, selector: Callable[[Pod], bool] | None = None
                     ) -> list[Pod]:
        out = list(self._pending.values())
        return [p for p in out if selector(p)] if selector else out

    def running_pods(self, selector: Callable[[Pod], bool] | None = None
                     ) -> list[Pod]:
        out = list(self._running.values())
        return [p for p in out if selector(p)] if selector else out

    def pods_on_node(self, name: str) -> list[Pod]:
        """RUNNING pods on one node (O(result); node drain, autoscaler)."""
        return list(self._node_pods.get(name, {}).values())

    # -- node lifecycle (autoscaler / failures) ------------------------------
    def add_node(self, node: Node, now: float):
        node.created_at = now
        self.nodes[node.name] = node
        self._acct_t[node.name] = now
        self._dirty = True
        self.events.append((now, "node_add", node.name))

    def remove_node(self, name: str, now: float, reason: str = "scale_down"):
        for pod in self.pods_on_node(name):
            self._stop_pod(pod, now, f"node_{reason}")
        self._account_node(name, now)
        self.nodes.pop(name, None)
        self._used.pop(name, None)
        self._node_pods.pop(name, None)
        self._acct_t.pop(name, None)
        self._dirty = True
        self.events.append((now, "node_remove", f"{name}:{reason}"))

    def fail_node(self, name: str, now: float):
        """Spot reclaim / hardware failure (§5): pods die with the node."""
        self.remove_node(name, now, reason="failure")

    # -- scheduling ----------------------------------------------------------
    def _fits(self, pod: Pod, node: Node, free: dict[str, float]) -> bool:
        for taint in node.taints:
            if taint not in pod.tolerations:
                return False
        for k, want in pod.node_selector.items():
            have = node.labels.get(k)
            if isinstance(want, (list, tuple, set)):
                if have not in want:
                    return False
            elif have != want:
                return False
        return all(free.get(k, 0) >= v for k, v in pod.request.items())

    def _stop_pod(self, pod: Pod, now: float, reason: str):
        if pod.phase == PodPhase.RUNNING:
            if pod.node is not None:
                self._use(pod.node, pod.request, -1.0, now)
                node_idx = self._node_pods.get(pod.node)
                if node_idx is not None:
                    node_idx.pop(pod.name, None)
            if pod.on_stop is not None:
                pod.on_stop(pod, now, reason)
        if pod.phase in (PodPhase.RUNNING, PodPhase.PENDING):
            self._pending.pop(pod.name, None)
            self._running.pop(pod.name, None)
            pod.phase = (PodPhase.FAILED if reason != "completed"
                         else PodPhase.SUCCEEDED)
            pod.stopped_at = now
            pod.stop_reason = reason
            self._dirty = True

    def succeed_pod(self, name: str, now: float):
        """Worker self-termination (C2) reports success."""
        pod = self.pods.get(name)
        if pod is not None:
            self._stop_pod(pod, now, "completed")
            self.pods.pop(name, None)

    @staticmethod
    def _placement_shape(pod: Pod) -> tuple:
        """Everything placement depends on besides free capacity.  Within
        one pass, capacity only shrinks between preemption events, so once
        a shape fails, identical later pods fail too."""
        return (
            pod.priority,
            tuple(sorted(pod.request.items())),
            pod.tolerations,
            tuple(sorted((k, str(v)) for k, v in
                         pod.node_selector.items())),
        )

    def schedule(self, now: float):
        """One scheduling pass: place pending pods (highest priority first,
        FIFO within class); preempt lower-priority pods when allowed.
        Skipped entirely when nothing changed since the last pass.

        A backlog of identical pending pods (the provisioner's common
        case: one group, hundreds queued) costs ONE failed
        place+preempt attempt per pass, not one per pod: shapes that
        failed are skipped for the rest of the pass.  A preemption that
        frees more than its beneficiary consumes re-dirties the cluster,
        so skipped pods get their chance next pass."""
        if not self._pending or not self._dirty:
            return
        self._dirty = False
        pending = sorted(
            self.pending_pods(), key=lambda p: (-p.priority, p.created_at)
        )
        failed: set[tuple] = set()
        for pod in pending:
            shape = self._placement_shape(pod)
            if shape in failed:
                continue
            placed = self._try_place(pod, now)
            if not placed and self.enable_preemption:
                placed = self._try_preempt(pod, now)
            if not placed:
                failed.add(shape)

    def _try_place(self, pod: Pod, now: float) -> bool:
        best: tuple[float, float, Node] | None = None
        for node in self.nodes.values():
            free = node.allocatable((), used=self.node_used(node.name))
            if self._fits(pod, node, free):
                # best-fit: least leftover gpu (then cpu) after placement
                left_gpu = free.get("gpu", 0) - pod.request.get("gpu", 0)
                left_cpu = free.get("cpu", 0) - pod.request.get("cpu", 0)
                key = (left_gpu, left_cpu)
                if best is None or key < (best[0], best[1]):
                    best = (*key, node)
        if best is None:
            return False
        node = best[2]
        pod.phase = PodPhase.RUNNING
        pod.node = node.name
        self._pending.pop(pod.name, None)
        self._running[pod.name] = pod
        self._node_pods.setdefault(node.name, {})[pod.name] = pod
        self._use(node.name, pod.request, +1.0, now)
        pod.started_at = now
        if pod.on_start is not None:
            pod.on_start(pod, now)
        return True

    def _try_preempt(self, pod: Pod, now: float) -> bool:
        """Evict the cheapest set of strictly-lower-priority pods on some
        node that would make room (k8s preemption, simplified)."""
        for node in self.nodes.values():
            victims = [
                p for p in self.pods_on_node(node.name)
                if p.priority < pod.priority
            ]
            if not victims:
                continue
            free = node.allocatable((), used=self.node_used(node.name))
            if any(t not in pod.tolerations for t in node.taints):
                continue
            sel_ok = all(
                (node.labels.get(k) in v if isinstance(v, (list, tuple, set))
                 else node.labels.get(k) == v)
                for k, v in pod.node_selector.items()
            )
            if not sel_ok:
                continue
            victims.sort(key=lambda p: (p.priority, -p.started_at))
            chosen = []
            for v in victims:
                if all(free.get(k, 0) >= r
                       for k, r in pod.request.items()):
                    break
                chosen.append(v)
                for k, r in v.request.items():
                    free[k] = free.get(k, 0) + r
            if all(free.get(k, 0) >= r for k, r in pod.request.items()):
                for v in chosen:
                    self._stop_pod(v, now, "preempted")
                    self.events.append((now, "preempt", v.name))
                return self._try_place(pod, now)
        return False

    # -- persistence ----------------------------------------------------------
    def state_dict(self) -> dict:
        """JSON-safe snapshot.  Index ORDERS are serialized explicitly:
        best-fit placement iterates `nodes` in insertion order, the
        pending sort breaks (priority, created_at) ties on `_pending`
        insertion order, and preemption victim ties follow `_node_pods`
        order — recomputing any of them could diverge a restored run.
        The `events` debug log is NOT serialized (unbounded, and nothing
        in the control flow reads it)."""
        nid = next(self._ids)
        self._ids = itertools.count(nid)   # non-destructive peek
        return {
            "name": self.name,
            "now": self.now,
            "dirty": self._dirty,
            "next_id": nid,
            "nodes": [node_state(n) for n in self.nodes.values()],
            "acct_t": dict(self._acct_t),
            "used": {k: dict(v) for k, v in self._used.items()},
            "pods": [pod_state(p) for p in self.pods.values()],
            "pending": list(self._pending.keys()),
            "running": list(self._running.keys()),
            "node_pods": {n: list(d.keys())
                          for n, d in self._node_pods.items()},
        }

    def load_state(self, state: dict) -> None:
        self.now = float(state.get("now", 0.0))
        self._dirty = bool(state.get("dirty", True))
        self._ids = itertools.count(int(state.get("next_id", 0)))
        self.nodes = {}
        for ns in state.get("nodes", []):
            n = node_from_state(ns)
            self.nodes[n.name] = n
        self._acct_t = {k: float(v)
                        for k, v in state.get("acct_t", {}).items()}
        self._used = {k: dict(v) for k, v in state.get("used", {}).items()}
        self.pods = {}
        for ps in state.get("pods", []):
            p = pod_from_state(ps)
            self.pods[p.name] = p
        self._pending = {n: self.pods[n] for n in state.get("pending", [])}
        self._running = {n: self.pods[n] for n in state.get("running", [])}
        self._node_pods = {
            node: {n: self.pods[n] for n in names}
            for node, names in state.get("node_pods", {}).items()
        }

    # -- accounting -----------------------------------------------------------
    def tick_accounting(self, dt: float, now: float | None = None):
        """Bring every node's lazy alive/busy integrals up to `now`
        (defaults to self.now + dt for tick-loop callers).  Idempotent at
        a fixed `now`, so priming passes and repeated ticks are safe."""
        if now is None:
            now = self.now + dt
        self.now = max(self.now, now)
        for name in self.nodes:
            self._account_node(name, now)

    def utilization(self, resource: str = "gpu") -> float:
        """Fraction of provisioned resource-seconds actually used."""
        cap = sum(
            n.capacity.get(resource, 0) * n.alive_s
            for n in self.nodes.values()
        )
        busy = sum(
            n.busy_integral.get(resource, 0) for n in self.nodes.values()
        )
        return busy / cap if cap > 0 else 0.0

    def resource_seconds(self, resource: str = "gpu") -> tuple[float, float]:
        """(provisioned, busy) resource-seconds — the per-backend harvested
        compute split (Fig 2 analogue per provider)."""
        cap = sum(n.capacity.get(resource, 0) * n.alive_s
                  for n in self.nodes.values())
        busy = sum(n.busy_integral.get(resource, 0)
                   for n in self.nodes.values())
        return cap, busy

    def count_pods(self, **labels: str) -> int:
        """Live pods matching every given label (backend attribution)."""
        n = 0
        for p in itertools.chain(self._pending.values(),
                                 self._running.values()):
            if all(p.labels.get(k) == v for k, v in labels.items()):
                n += 1
        return n
