"""Requirement grouping (paper §2 C4): the key delta vs. Kubernetes HPA.

Heterogeneous idle jobs are quantized into signatures; each signature is an
independent provisioning stream whose pods request exactly the signature's
resources.  The paper groups on (CPU, GPU, memory, disk) "but could be
extended" — our TPU adaptation extends it with (chips, hbm_gb, arch) so a
mamba2 decode job and a llama4 train job never share a pod shape.

Quantization: memory/disk are bucketed to the next power-of-two GB so
near-identical requests share a group (avoids one group per byte count);
cpu/gpu/chips are exact (small integers).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Iterable

from repro_torch.core.jobqueue import Job

GroupKey = tuple


@dataclasses.dataclass(frozen=True)
class GroupSignature:
    cpus: int = 1
    gpus: int = 0
    memory_gb: int = 4          # pow2-bucketed
    disk_gb: int = 8            # pow2-bucketed
    chips: int = 0              # TPU extension
    hbm_gb: int = 0
    arch: str | None = None     # job class label (extension attr)

    def as_pod_request(self) -> dict[str, float]:
        req = {
            "cpu": float(self.cpus),
            "memory": float(self.memory_gb),
            "disk": float(self.disk_gb),
        }
        if self.gpus:
            req["gpu"] = float(self.gpus)
        if self.chips:
            req["chips"] = float(self.chips)
        return req

    def as_worker_ad(self) -> dict[str, Any]:
        ad: dict[str, Any] = {
            "cpus": self.cpus,
            "gpus": self.gpus,
            "memory": self.memory_gb,
            "disk": self.disk_gb,
        }
        if self.chips:
            ad["chips"] = self.chips
            ad["hbm_gb"] = self.hbm_gb
        if self.arch:
            ad["arch"] = self.arch
        return ad


def _pow2_bucket(x: float, lo: int = 1) -> int:
    if x <= lo:
        return lo
    return 1 << math.ceil(math.log2(x))


def signature_of(job: Job, *, extra_keys: tuple[str, ...] = ("arch",)
                 ) -> GroupSignature:
    ad = job.ad
    return GroupSignature(
        cpus=int(ad.get("request_cpus", 1) or 1),
        gpus=int(ad.get("request_gpus", 0) or 0),
        memory_gb=_pow2_bucket(float(ad.get("request_memory", 4) or 4)),
        disk_gb=_pow2_bucket(float(ad.get("request_disk", 8) or 8)),
        chips=int(ad.get("request_chips", 0) or 0),
        hbm_gb=int(ad.get("request_hbm_gb", 0) or 0),
        arch=ad.get("arch") if "arch" in extra_keys else None,
    )


def group_jobs(jobs: Iterable[Job]) -> dict[GroupSignature, list[Job]]:
    groups: dict[GroupSignature, list[Job]] = {}
    for job in jobs:
        groups.setdefault(signature_of(job), []).append(job)
    return groups


def matches_signature(ad: dict, sig: GroupSignature) -> bool:
    """Does a worker ad belong to this provisioning group? (used when
    counting unclaimed workers against the group's deficit)."""
    w = sig.as_worker_ad()
    for k, v in w.items():
        if ad.get(k) != v:
            return False
    return True
