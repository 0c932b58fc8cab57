"""Swappable matchmaking backends behind one protocol (see base.py).

    from repro_torch.core.matchmaker import make_matchmaker
    mm = make_matchmaker("torch")        # or "numpy", "scan"
    plan = mm.match(problem)

Selection flows from `Simulation(matchmaker=...)` / the `[provision]
matchmaker=` INI key through `Collector(matchmaker=...)`; every backend
is claim-for-claim identical on quantity-blind policies.  "torch" runs
the water-fill kernel on a CUDA device and raises when there is none;
``TorchMatchmaker(device="cpu")`` runs its plain PyTorch version.
"""
from repro_torch.core.matchmaker.base import (
    EXHAUSTIBLE_IDX, FIT_EPS, RESOURCE_KEYS, MatchPlan, MatchProblem,
    Matchmaker, cohort_fits, make_matchmaker, matchmaker_names,
    problem_from_reference, register_matchmaker,
)
from repro_torch.core.matchmaker.numpy_backend import NumpyMatchmaker
from repro_torch.core.matchmaker.scan_backend import ScanMatchmaker
from repro_torch.core.matchmaker.torch_backend import TorchMatchmaker

register_matchmaker("numpy", NumpyMatchmaker)
register_matchmaker("scan", ScanMatchmaker)
register_matchmaker("torch", TorchMatchmaker)

__all__ = [
    "EXHAUSTIBLE_IDX", "FIT_EPS", "RESOURCE_KEYS", "MatchPlan",
    "MatchProblem", "Matchmaker", "NumpyMatchmaker", "ScanMatchmaker",
    "TorchMatchmaker", "cohort_fits", "make_matchmaker",
    "matchmaker_names", "problem_from_reference", "register_matchmaker",
]
