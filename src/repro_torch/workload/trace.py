"""Workload trace schema: the single source of demand for the simulator.

The paper evaluates demand-driven provisioning against real Open Science
Grid demand (Fig. 2/3); its follow-up (arXiv:2308.11733) characterizes
that demand as bursty, heterogeneous, and heavy-tailed.  A `Trace` is the
repo's portable representation of such demand: an arrival-ordered list of
`TraceRecord`s — arrival time, runtime, resource request, a ClassAd
Requirements expression, and group/user labels — with JSONL and CSV
round-trip, validation, and a lossless mapping onto `core.jobqueue.Job`.

Determinism contract: serialization uses a fixed field order and Python's
shortest-round-trip float repr, so the same `Trace` always produces
byte-identical JSONL/CSV, and parse → re-serialize is the identity.  The
synthetic generators (generators.py) rely on this for their
same-seed-same-bytes guarantee.

Cohort formation: two records with the same request, labels, and
Requirements string map to jobs in the same idle COHORT of the indexed
JobQueue — the negotiator and provisioner evaluate matchmaking once per
cohort, so a trace's requirement MIX (not its length) sets the
control-plane cost.  `Trace.cohort_mix()` previews that structure without
building any `Job`.
"""
from __future__ import annotations

import csv
import dataclasses
import io
import json
import os
from typing import Any, Iterable, Iterator

from repro_torch.core.classad import ClassAdExpr
from repro_torch.core.jobqueue import Job, canonical_ad


class TraceError(ValueError):
    """A record or file violates the trace schema."""


# serialization order is part of the byte-identity contract
FIELDS = ("arrival_s", "runtime_s", "cpus", "gpus", "memory_gb", "disk_gb",
          "requirements", "group", "user", "attrs")

_META_KEY = "__trace_meta__"

# Requirements strings compile to ClassAdExpr once per distinct source —
# traces have few distinct expressions, never one per record
_REQ_CACHE_MAX = 4096
_req_cache: dict[str, ClassAdExpr | None] = {}


def _compiled_requirements(src: str) -> ClassAdExpr | None:
    src = (src or "").strip()
    if not src:
        return None
    expr = _req_cache.get(src)
    if expr is None:
        if len(_req_cache) >= _REQ_CACHE_MAX:
            _req_cache.clear()
        expr = _req_cache[src] = ClassAdExpr(src)
    return expr


@dataclasses.dataclass
class TraceRecord:
    """One job arrival.  `attrs` carries extra advertised attributes
    (e.g. ``arch``) that ride into the job ad verbatim."""

    arrival_s: float
    runtime_s: float
    cpus: int = 1
    gpus: int = 0
    memory_gb: float = 4.0
    disk_gb: float = 8.0
    requirements: str = ""
    group: str = "default"
    user: str = "user00"
    attrs: dict[str, Any] = dataclasses.field(default_factory=dict)

    def validate(self):
        if not (self.arrival_s >= 0.0 and self.arrival_s == self.arrival_s):
            raise TraceError(f"arrival_s must be finite >= 0, "
                             f"got {self.arrival_s!r}")
        if not self.runtime_s > 0.0:
            raise TraceError(f"runtime_s must be > 0, got {self.runtime_s!r}")
        if self.cpus < 1:
            raise TraceError(f"cpus must be >= 1, got {self.cpus!r}")
        if self.gpus < 0 or self.memory_gb <= 0 or self.disk_gb < 0:
            raise TraceError(
                f"bad resource request (gpus={self.gpus!r}, "
                f"memory_gb={self.memory_gb!r}, disk_gb={self.disk_gb!r})")
        try:
            _compiled_requirements(self.requirements)
        except ValueError as e:
            raise TraceError(f"bad Requirements {self.requirements!r}: {e}")

    # -- job mapping ---------------------------------------------------------
    def job_ad(self) -> dict[str, Any]:
        ad: dict[str, Any] = {
            "request_cpus": self.cpus,
            "request_gpus": self.gpus,
            "request_memory": self.memory_gb,
            "request_disk": self.disk_gb,
            "accounting_group": self.group,
            "user": self.user,
        }
        ad.update(self.attrs)
        return ad

    def to_job(self) -> Job:
        return Job(ad=self.job_ad(), runtime_s=self.runtime_s,
                   requirements=_compiled_requirements(self.requirements))

    def cohort_key(self) -> tuple:
        """The idle-cohort key `to_job()` lands in, without building the
        Job or compiling the expression (mirrors cohort_key_of)."""
        return ((self.requirements or "").strip(),
                canonical_ad(self.job_ad()))

    # -- serialization -------------------------------------------------------
    def to_obj(self) -> dict[str, Any]:
        return {
            "arrival_s": float(self.arrival_s),
            "runtime_s": float(self.runtime_s),
            "cpus": int(self.cpus),
            "gpus": int(self.gpus),
            "memory_gb": float(self.memory_gb),
            "disk_gb": float(self.disk_gb),
            "requirements": self.requirements,
            "group": self.group,
            "user": self.user,
            "attrs": dict(sorted(self.attrs.items())),
        }

    @classmethod
    def from_obj(cls, obj: dict[str, Any]) -> "TraceRecord":
        try:
            return cls(
                arrival_s=float(obj["arrival_s"]),
                runtime_s=float(obj["runtime_s"]),
                cpus=int(obj.get("cpus", 1)),
                gpus=int(obj.get("gpus", 0)),
                memory_gb=float(obj.get("memory_gb", 4.0)),
                disk_gb=float(obj.get("disk_gb", 8.0)),
                requirements=str(obj.get("requirements", "")),
                group=str(obj.get("group", "default")),
                user=str(obj.get("user", "user00")),
                attrs=dict(obj.get("attrs", {}) or {}),
            )
        except (KeyError, TypeError, ValueError) as e:
            raise TraceError(f"bad trace record {obj!r}: {e}") from None


@dataclasses.dataclass
class Trace:
    """An arrival-ordered workload trace plus generator metadata."""

    records: list[TraceRecord] = dataclasses.field(default_factory=list)
    meta: dict[str, Any] = dataclasses.field(default_factory=dict)

    def __len__(self) -> int:
        return len(self.records)

    def __iter__(self) -> Iterator[TraceRecord]:
        return iter(self.records)

    def validate(self) -> "Trace":
        prev = -1.0
        for i, rec in enumerate(self.records):
            rec.validate()
            if rec.arrival_s < prev:
                raise TraceError(
                    f"record {i} arrives at {rec.arrival_s} after "
                    f"{prev} — traces must be arrival-ordered")
            prev = rec.arrival_s
        return self

    # -- demand totals (conservation checks) ---------------------------------
    def duration_s(self) -> float:
        return self.records[-1].arrival_s if self.records else 0.0

    def total_core_seconds(self) -> float:
        return sum(r.cpus * r.runtime_s for r in self.records)

    def total_gpu_seconds(self) -> float:
        return sum(r.gpus * r.runtime_s for r in self.records)

    def cohort_mix(self) -> dict[tuple, int]:
        """{idle-cohort key: arrivals} — the matchmaking-equivalence
        structure this trace will impose on the JobQueue."""
        mix: dict[tuple, int] = {}
        for r in self.records:
            key = r.cohort_key()
            mix[key] = mix.get(key, 0) + 1
        return mix

    def stats(self) -> dict[str, Any]:
        # "last_arrival_s", not "duration_s": the latter is the
        # generator's CONFIGURED window and lives in meta — the two must
        # not collide when summaries merge meta with stats
        return {
            "n": len(self.records),
            "last_arrival_s": self.duration_s(),
            "core_seconds": self.total_core_seconds(),
            "gpu_seconds": self.total_gpu_seconds(),
            "cohorts": len(self.cohort_mix()),
            "users": len({r.user for r in self.records}),
            "groups": len({r.group for r in self.records}),
        }

    # -- JSONL ---------------------------------------------------------------
    def to_jsonl(self) -> str:
        lines = []
        if self.meta:
            lines.append(json.dumps({_META_KEY: self.meta},
                                    sort_keys=True))
        for rec in self.records:
            lines.append(json.dumps(rec.to_obj()))
        return "\n".join(lines) + "\n"

    @classmethod
    def from_jsonl(cls, text: str) -> "Trace":
        # iter_jsonl validates each record and the ordering as it goes,
        # so skip the redundant whole-trace re-validation pass
        return cls(records=list(iter_jsonl(io.StringIO(text))),
                   meta=_peek_meta(text))

    # -- CSV (meta is not carried — JSONL is the canonical format) -----------
    def to_csv(self) -> str:
        buf = io.StringIO()
        w = csv.writer(buf, lineterminator="\n")
        w.writerow(FIELDS)
        for rec in self.records:
            obj = rec.to_obj()
            w.writerow([
                repr(obj["arrival_s"]), repr(obj["runtime_s"]),
                obj["cpus"], obj["gpus"],
                repr(obj["memory_gb"]), repr(obj["disk_gb"]),
                obj["requirements"], obj["group"], obj["user"],
                json.dumps(obj["attrs"], sort_keys=True),
            ])
        return buf.getvalue()

    @classmethod
    def from_csv(cls, text: str) -> "Trace":
        rd = csv.reader(io.StringIO(text))
        header = next(rd, None)
        if header is None or tuple(header) != FIELDS:
            raise TraceError(f"bad CSV header {header!r}; expected {FIELDS}")
        records = []
        for row in rd:
            if not row:
                continue
            if len(row) != len(FIELDS):
                raise TraceError(f"bad CSV row {row!r}")
            obj = dict(zip(FIELDS, row))
            try:
                obj["attrs"] = json.loads(obj["attrs"] or "{}")
            except json.JSONDecodeError as e:
                raise TraceError(f"bad attrs column {row!r}: {e}") from None
            records.append(TraceRecord.from_obj(obj))
        return cls(records=records).validate()

    # -- files ---------------------------------------------------------------
    @classmethod
    def from_records(cls, records: Iterable[TraceRecord],
                     meta: dict[str, Any] | None = None) -> "Trace":
        return cls(records=list(records), meta=dict(meta or {})).validate()

    def save(self, path: str) -> str:
        """Write JSONL (default) or CSV, chosen by extension."""
        text = self.to_csv() if path.endswith(".csv") else self.to_jsonl()
        with open(path, "w") as f:
            f.write(text)
        return path

    @classmethod
    def load(cls, path: str) -> "Trace":
        if not os.path.exists(path):
            raise TraceError(f"no such trace file: {path}")
        with open(path) as f:
            text = f.read()
        if path.endswith(".csv"):
            return cls.from_csv(text)
        return cls.from_jsonl(text)


def split_records(records: Iterable[TraceRecord], by: str = "group"
                  ) -> dict[str, list[TraceRecord]]:
    """Partition records by their `group` or `user` label, preserving
    arrival order inside each partition."""
    if by not in ("group", "user"):
        raise TraceError(f"split key must be 'group' or 'user', got {by!r}")
    out: dict[str, list[TraceRecord]] = {}
    for rec in records:
        out.setdefault(getattr(rec, by), []).append(rec)
    return out


def split_trace(trace: Trace, *, by: str = "group",
                n_schedds: int | None = None) -> dict[str, Trace]:
    """Split one trace into per-schedd traces — the multi-schedd
    flocking scenario's demand: each community (group label, or user
    with ``by="user"``) submits through its own schedd into the shared
    pool.

    With ``n_schedds=None`` every label becomes its own schedd (named
    after the label).  With ``n_schedds=N`` labels are packed onto N
    schedds named ``schedd00..`` by deterministic greedy balancing:
    labels in descending record count onto the least-loaded schedd, so
    the same trace always splits the same way and no schedd is left
    empty while labels remain.  Arrival order is preserved per schedd
    (a subsequence of an ordered trace is ordered), and the partition
    is exact — cross-schedd totals equal the parent trace's, which the
    compare harness' conservation checks verify."""
    parts = split_records(trace.records, by=by)
    if not parts:
        raise TraceError("cannot split an empty trace")

    def sub(name: str, recs: list[TraceRecord]) -> Trace:
        meta = {**trace.meta, "schedd": name, "split_by": by}
        return Trace(records=recs, meta=meta)

    if n_schedds is None:
        return {label: sub(label, recs)
                for label, recs in sorted(parts.items())}
    if n_schedds < 1:
        raise TraceError(f"n_schedds must be >= 1, got {n_schedds}")
    names = [f"schedd{i:02d}" for i in range(n_schedds)]
    schedd_of: dict[str, str] = {}
    load = {n: 0 for n in names}
    for label, recs in sorted(parts.items(),
                              key=lambda kv: (-len(kv[1]), kv[0])):
        tgt = min(names, key=lambda n: (load[n], n))
        schedd_of[label] = tgt
        load[tgt] += len(recs)
    merged: dict[str, list[TraceRecord]] = {n: [] for n in names}
    for rec in trace.records:       # one pass keeps arrival order
        merged[schedd_of[getattr(rec, by)]].append(rec)
    return {name: sub(name, merged[name]) for name in names}


def _peek_meta(text: str) -> dict[str, Any]:
    for line in io.StringIO(text):
        line = line.strip()
        if not line:
            continue
        obj = json.loads(line)
        return dict(obj.get(_META_KEY, {})) if _META_KEY in obj else {}
    return {}


def iter_jsonl(lines: Iterable[str]) -> Iterator[TraceRecord]:
    """Stream records from JSONL lines without materializing a Trace —
    the replayer's input for file-backed campaigns (constant memory).
    Validates each record and the arrival ordering as it goes."""
    prev = -1.0
    for i, line in enumerate(lines):
        line = line.strip()
        if not line:
            continue
        try:
            obj = json.loads(line)
        except json.JSONDecodeError as e:
            raise TraceError(f"line {i + 1}: invalid JSON: {e}") from None
        if _META_KEY in obj:
            continue
        rec = TraceRecord.from_obj(obj)
        rec.validate()
        if rec.arrival_s < prev:
            raise TraceError(
                f"line {i + 1}: arrival {rec.arrival_s} < previous {prev} "
                f"— traces must be arrival-ordered")
        prev = rec.arrival_s
        yield rec


def open_trace_stream(path: str) -> Iterator[TraceRecord]:
    """Lazily stream a JSONL trace file (CSV loads eagerly — it has a
    header to check and no meta line to skip)."""
    if path.endswith(".csv"):
        with open(path) as f:
            return iter(Trace.from_csv(f.read()).records)

    def gen() -> Iterator[TraceRecord]:
        with open(path) as f:
            yield from iter_jsonl(f)

    return gen()
