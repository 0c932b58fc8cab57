"""The paper's contribution: demand-driven auto-scaling provisioning of
Kubernetes-managed resources into HTCondor pools (Sfiligoi et al., PEARC22),
with negotiation on PyTorch: `TorchMatchmaker` (matchmaker="torch") runs
the water-fill on a hand-written CUDA kernel.
"""
from repro_torch.core.classad import ClassAdExpr, symmetric_match, UNDEFINED
from repro_torch.core.events import EventHandle, EventLoop, PeriodicHandle
from repro_torch.core.fairshare import (
    Accountant, ScheddSpec, UsageLedger, job_cores, make_schedd_specs,
)
from repro_torch.core.jobqueue import (
    FlockedQueues, Job, JobQueue, JobState, cohort_key_of, user_of,
)
from repro_torch.core.cluster import KubeCluster, Node, Pod, PodPhase
from repro_torch.core.matchmaker import (
    MatchPlan, MatchProblem, Matchmaker, NumpyMatchmaker, RESOURCE_KEYS,
    ScanMatchmaker, TorchMatchmaker, make_matchmaker, matchmaker_names,
    problem_from_reference, register_matchmaker,
)
from repro_torch.core.worker import (
    Collector, LRUCache, Worker, advance_workers, kill_worker,
)
from repro_torch.core.groups import GroupSignature, group_jobs, signature_of
from repro_torch.core.config import (
    BackendConfig, ProvisionerConfig, dump_ini, load_ini, PAPER_EXAMPLE_INI,
)
from repro_torch.core.backend import (
    FederatedClusterView, KubeBackend, PodSpec, ROUTING_POLICIES,
    RoutingPolicy, ScalingBackend, adapt_single_cluster, backend_from_config,
    build_backends, make_routing_policy,
)
from repro_torch.core.provisioner import Provisioner
from repro_torch.core.nodescaler import NodeAutoscaler, NodeTemplate
from repro_torch.core.simulation import Simulation, gpu_job, onprem_nodes
from repro_torch.core.metrics import (
    CompletedStats, Recorder, percentile, summarize_backends, timeline,
)
from repro_torch.core.stragglers import StragglerPolicy
