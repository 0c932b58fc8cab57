"""Cloud node auto-scaling (paper §6): the GKE NAP dynamic, simulated.

The pod-level provisioner and the node autoscaler compose in layers: the
provisioner converts HTCondor demand into pending pods; pending pods drive
node provisioning; empty nodes are deprovisioned after a delay.  The paper
observed (Fig 3) prompt node provisioning and "close to the minimum
achievable" deprovisioning waste — unavoidable because several pods share
a node and rarely terminate together.  `waste_fraction()` measures exactly
that: node-resource-seconds carrying zero pods while the node waits out
the scale-down delay (plus bin-packing leftovers).

Node template mirrors the paper's GKE test: 7-GPU nodes, 1-GPU pods.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any

from repro_torch.core.cluster import KubeCluster, Node


@dataclasses.dataclass
class NodeTemplate:
    capacity: dict[str, float]
    labels: dict[str, str] = dataclasses.field(default_factory=dict)
    taints: tuple[str, ...] = ()
    provision_delay_s: float = 90.0      # instance boot + kubelet join
    scale_down_delay_s: float = 600.0    # empty-node grace (GKE default ~10m)
    hourly_cost: float = 1.0


class NodeAutoscaler:
    def __init__(self, cluster: KubeCluster, template: NodeTemplate, *,
                 max_nodes: int = 64, prefix: str = "np"):
        self.cluster = cluster
        self.template = template
        self.max_nodes = max_nodes
        self.prefix = prefix
        self._ids = itertools.count()
        self._booting: list[tuple[float, Node]] = []   # (ready_at, node)
        self._empty_since: dict[str, float] = {}
        # accounting for the Fig-3 analogue
        self.node_seconds: float = 0.0
        self.empty_node_seconds: float = 0.0
        self.provisioned_total: int = 0
        self.deprovisioned_total: int = 0

    # -- sizing logic ----------------------------------------------------------
    def _pods_fit_per_node(self, request: dict[str, float]) -> int:
        cap = self.template.capacity
        n = float("inf")
        for k, v in request.items():
            if v > 0:
                n = min(n, cap.get(k, 0) // v)
        return int(n) if n != float("inf") else 0

    @staticmethod
    def _placeable(pod, node: Node) -> bool:
        """Could the scheduler ever put this pod on this node (taints +
        selector, capacity aside)?"""
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
        return True

    def _nodes_needed(self) -> int:
        """Bin-pack pending pods into node templates (first-fit by count).

        Free capacity on already-live nodes is seeded as pre-existing bins
        so a tick where the scheduler hasn't yet placed freshly-submitted
        pods does NOT boot spurious nodes — only pods that overflow the
        pool's current allocatable headroom count toward new nodes.  A
        seeded bin only absorbs pods the scheduler could actually place
        there (taints/selector respected), so a pod blocked from live
        nodes by affinity still drives a scale-up."""
        pending = self.cluster.pending_pods(
            lambda p: all(
                self.template.capacity.get(k, 0) >= v
                for k, v in p.request.items()
            )
        )
        if not pending:
            return 0
        # pre-existing bins: current allocatable headroom of live nodes
        seeded: list[tuple[dict[str, float], Node]] = []
        for name, node in self.cluster.nodes.items():
            seeded.append((dict(node.allocatable(
                (), used=self.cluster.node_used(name))), node))
        new_bins: list[dict[str, float]] = []
        # greedy first-fit-decreasing over the dominant resource
        for pod in sorted(
            pending,
            key=lambda p: -max(p.request.values() or [0]),
        ):
            placed = False
            for b, node in seeded:
                if (self._placeable(pod, node)
                        and all(b.get(k, 0) >= v
                                for k, v in pod.request.items())):
                    for k, v in pod.request.items():
                        b[k] = b.get(k, 0) - v
                    placed = True
                    break
            if not placed:
                for b in new_bins:
                    if all(b.get(k, 0) >= v
                           for k, v in pod.request.items()):
                        for k, v in pod.request.items():
                            b[k] = b.get(k, 0) - v
                        placed = True
                        break
            if not placed:
                b = dict(self.template.capacity)
                for k, v in pod.request.items():
                    b[k] = b.get(k, 0) - v
                new_bins.append(b)
        return len(new_bins)

    # -- tick --------------------------------------------------------------------
    def tick(self, now: float, dt: float):
        # 1. finish booting nodes
        ready = [x for x in self._booting if x[0] <= now]
        self._booting = [x for x in self._booting if x[0] > now]
        for _, node in ready:
            self.cluster.add_node(node, now)

        # 2. scale up for pending pods (beyond what's already booting)
        need = self._nodes_needed() - len(self._booting)
        live = len([n for n in self.cluster.nodes
                    if n.startswith(self.prefix)]) + len(self._booting)
        for _ in range(max(0, min(need, self.max_nodes - live))):
            node = Node(
                name=f"{self.prefix}-{next(self._ids)}",
                capacity=dict(self.template.capacity),
                labels=dict(self.template.labels),
                taints=self.template.taints,
            )
            self._booting.append((now + self.template.provision_delay_s, node))
            self.provisioned_total += 1

        # 3. scale down empty nodes after the grace period
        for name in list(self.cluster.nodes):
            if not name.startswith(self.prefix):
                continue
            running = self.cluster.pods_on_node(name)
            if running:
                self._empty_since.pop(name, None)
                continue
            since = self._empty_since.setdefault(name, now)
            self.empty_node_seconds += dt
            if now - since >= self.template.scale_down_delay_s:
                self.cluster.remove_node(name, now)
                self._empty_since.pop(name, None)
                self.deprovisioned_total += 1

        # 4. accounting
        n_live = len([n for n in self.cluster.nodes
                      if n.startswith(self.prefix)])
        self.node_seconds += n_live * dt

    # -- persistence ----------------------------------------------------------
    def state_dict(self) -> dict:
        """JSON-safe snapshot.  `node_seconds`/`empty_node_seconds`
        integrate at tick granularity and are NOT flushed between ticks,
        so carrying the counters as of the last tick matches an
        uninterrupted run exactly."""
        from repro_torch.core.cluster import node_state
        nid = next(self._ids)
        self._ids = itertools.count(nid)   # non-destructive peek
        return {
            "next_id": nid,
            "booting": [[t, node_state(n)] for t, n in self._booting],
            "empty_since": dict(self._empty_since),
            "node_seconds": self.node_seconds,
            "empty_node_seconds": self.empty_node_seconds,
            "provisioned_total": self.provisioned_total,
            "deprovisioned_total": self.deprovisioned_total,
        }

    def load_state(self, state: dict) -> None:
        from repro_torch.core.cluster import node_from_state
        self._ids = itertools.count(int(state.get("next_id", 0)))
        self._booting = [(float(t), node_from_state(ns))
                         for t, ns in state.get("booting", [])]
        self._empty_since = {k: float(v)
                             for k, v in state.get("empty_since", {}).items()}
        self.node_seconds = float(state.get("node_seconds", 0.0))
        self.empty_node_seconds = float(state.get("empty_node_seconds", 0.0))
        self.provisioned_total = int(state.get("provisioned_total", 0))
        self.deprovisioned_total = int(state.get("deprovisioned_total", 0))

    # -- metrics (Fig 3 analogue) -------------------------------------------------
    def waste_fraction(self) -> float:
        """Empty-node-seconds / total node-seconds."""
        return (self.empty_node_seconds / self.node_seconds
                if self.node_seconds > 0 else 0.0)

    def live_nodes(self) -> int:
        return len([n for n in self.cluster.nodes
                    if n.startswith(self.prefix)])
