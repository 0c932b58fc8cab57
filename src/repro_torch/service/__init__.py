"""Long-running pool service over the discrete-event simulator.

The paper's provisioner is a daemon: it watches live schedds and grows/
shrinks a Kubernetes pool while users keep submitting.  This package
turns the repo's `Simulation` into exactly that — a process that accepts
streaming submissions, paces the event loop against wall-clock time,
exposes pool state over HTTP, survives kill/restart via full-state
snapshots, and reconfigures (add/drain backends and schedds) without a
restart.

  driver.py    WallClockDriver: paces the event loop at `speed`× real
               time (or as fast as possible) and injects concurrent
               operations only at quiescent instants
  pool.py      PoolService (the daemon brain) + PoolClient (in-process)
               + RemoteClient (urllib, for the CLI)
  http.py      stdlib-only JSON HTTP surface (submit/status/rm/metrics/
               snapshot/reconfigure)
  __main__.py  `python -m repro_torch.service` CLI

Nothing here touches the decision logic: the provisioner, negotiator,
and backends run unmodified — the service only replaces the clock and
the submission surface, the same separation the wall-clock launch path
relies on.
"""
from repro_torch.service.driver import WallClockDriver
from repro_torch.service.pool import PoolClient, PoolService, RemoteClient

__all__ = [
    "PoolClient",
    "PoolService",
    "RemoteClient",
    "WallClockDriver",
]
