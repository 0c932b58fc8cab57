"""Straggler mitigation (beyond-paper, required at 1000+-node scale).

HTCondor's own answer to stragglers is job-level: if a job runs far past
its expected runtime on some node, kick it back to IDLE and let
matchmaking place it elsewhere (the slow node's worker is retired so it
stops attracting work).  This is the control-plane analogue of
speculative re-execution; combined with self-checkpointing jobs the lost
work is bounded by one checkpoint interval.

Detection: a running job whose wall-clock age exceeds
``factor × runtime_s`` is a straggler (progress-rate proxy; the real
deployment reads HTCondor's job heartbeat attribute the same way).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.jobqueue import JobQueue, JobState
from repro_torch.core.worker import Collector, kill_worker


@dataclasses.dataclass
class StragglerPolicy:
    factor: float = 2.0            # age > factor × expected runtime
    retire_worker: bool = True     # stop the slow worker claiming more
    min_runtime_s: float = 60.0    # ignore very short jobs

    rescheduled: int = 0
    retired_workers: int = 0

    def tick(self, queue: JobQueue, collector: Collector, cluster,
             now: float) -> int:
        n = 0
        for job in queue.jobs(JobState.RUNNING):
            if job.runtime_s < self.min_runtime_s:
                continue
            age = now - job.attempt_started_at
            if age <= self.factor * job.runtime_s:
                continue
            worker_name = job.claimed_by
            queue.release(job.jid, now, preempted=True)
            n += 1
            self.rescheduled += 1
            if self.retire_worker and worker_name:
                w = collector.workers.get(worker_name)
                if w is not None:
                    kill_worker(collector, queue, worker_name, now)
                    if w.pod_name and cluster is not None:
                        cluster.delete_pod(w.pod_name, now, "straggler")
                    self.retired_workers += 1
        return n
