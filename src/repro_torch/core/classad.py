"""ClassAd-style matchmaking expressions (paper §2 C3, HTCondor semantics).

HTCondor matches a job to a machine by evaluating the job's Requirements
against the machine ad and the machine's START policy against the job ad.
We reproduce the essentials with Python expression syntax, safely evaluated
over an AST whitelist (no builtins, no calls except whitelisted helpers):

    expr   := python expression
    names  := resolve in MY ad first, then TARGET ad (HTCondor scoping);
              explicit MY.x / TARGET.x / my.x / target.x also work
    absent := attributes missing from both ads evaluate to UNDEFINED, which
              is falsy and propagates through comparisons (HTCondor 3-value
              logic approximated: UNDEFINED comparisons are False)

The provisioner evaluates the SAME filter expression on the job side (which
jobs to count, §2) and pushes it into the worker START policy (which jobs a
provisioned pod may claim) — the paper's symmetric-filter design, so a
worker never claims a job that wasn't counted toward its provisioning.
"""
from __future__ import annotations

import ast
from typing import Any, Mapping


class Undefined:
    """HTCondor UNDEFINED: falsy; all rich comparisons return False."""

    _inst = None

    def __new__(cls):
        if cls._inst is None:
            cls._inst = super().__new__(cls)
        return cls._inst

    def __bool__(self):
        return False

    def __repr__(self):
        return "UNDEFINED"

    # comparisons never match
    def _cmp(self, other):
        return False

    __eq__ = __ne__ = __lt__ = __le__ = __gt__ = __ge__ = _cmp
    __contains__ = _cmp

    def __hash__(self):
        return 0


UNDEFINED = Undefined()

_ALLOWED_NODES = (
    ast.Expression, ast.BoolOp, ast.And, ast.Or, ast.UnaryOp, ast.Not,
    ast.USub, ast.UAdd, ast.BinOp, ast.Add, ast.Sub, ast.Mult, ast.Div,
    ast.FloorDiv, ast.Mod, ast.Compare, ast.Eq, ast.NotEq, ast.Lt, ast.LtE,
    ast.Gt, ast.GtE, ast.In, ast.NotIn, ast.Name, ast.Load, ast.Constant,
    ast.Tuple, ast.List, ast.Attribute, ast.IfExp, ast.Call,
)

_ALLOWED_FUNCS = {
    "min": min, "max": max, "abs": abs, "int": int, "float": float,
    "len": len, "str": str, "bool": bool,
    "regexp": lambda pat, s: __import__("re").search(str(pat), str(s))
    is not None,
}


class ClassAdExpr:
    """Compiled, reusable matchmaking expression."""

    def __init__(self, src: str | None):
        self.src = (src or "").strip()
        self.refs: frozenset[str] = frozenset()  # ad attrs the expr reads
        if not self.src or self.src.lower() == "true":
            self._tree = None  # vacuously true
            return
        tree = ast.parse(self.src, mode="eval")
        for node in ast.walk(tree):
            if not isinstance(node, _ALLOWED_NODES):
                raise ValueError(
                    f"disallowed syntax {type(node).__name__!r} in "
                    f"ClassAd expression: {self.src!r}"
                )
            if isinstance(node, ast.Call):
                if (not isinstance(node.func, ast.Name)
                        or node.func.id not in _ALLOWED_FUNCS):
                    raise ValueError(
                        f"disallowed call in ClassAd expression: {self.src!r}"
                    )
            if isinstance(node, ast.Attribute):
                # attribute access is ONLY the MY.x / TARGET.x scoping —
                # anything else (e.g. ().__class__) is an escape hatch
                if (not isinstance(node.value, ast.Name)
                        or node.value.id.lower() not in ("my", "target")
                        or node.attr.startswith("__")):
                    raise ValueError(
                        f"disallowed attribute access in ClassAd "
                        f"expression: {self.src!r}"
                    )
        refs = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Name):
                n = node.id.lower()
                if n not in ("my", "target", "true", "false",
                             "undefined") and n not in _ALLOWED_FUNCS:
                    refs.add(n)
            elif isinstance(node, ast.Attribute):
                refs.add(node.attr.lower())
        self.refs = frozenset(refs)
        self._tree = compile(tree, "<classad>", "eval")

    def evaluate(self, my: Mapping[str, Any],
                 target: Mapping[str, Any] | None = None) -> bool:
        if self._tree is None:
            return True
        target = target or {}
        my_l = _lower(my)
        tg_l = _lower(target)

        class _Scope(dict):
            def __missing__(self, key):
                kl = key.lower()
                if kl == "my":
                    return _AdProxy(my_l)
                if kl == "target":
                    return _AdProxy(tg_l)
                if kl in _ALLOWED_FUNCS:
                    return _ALLOWED_FUNCS[kl]
                if kl in ("true", "false"):
                    return kl == "true"
                if kl == "undefined":
                    return UNDEFINED
                if kl in my_l:
                    return my_l[kl]
                if kl in tg_l:
                    return tg_l[kl]
                return UNDEFINED

        try:
            out = eval(self._tree, {"__builtins__": {}}, _Scope())
        except (TypeError, ZeroDivisionError, AttributeError):
            return False
        if out is UNDEFINED:
            return False
        return bool(out)

    def __repr__(self):
        return f"ClassAdExpr({self.src!r})"


class _AdProxy:
    def __init__(self, ad_lower: Mapping[str, Any]):
        self._ad = ad_lower

    def __getattr__(self, name: str):
        return self._ad.get(name.lower(), UNDEFINED)


def _lower(ad: Mapping[str, Any]) -> dict[str, Any]:
    return {str(k).lower(): v for k, v in ad.items()}


def symmetric_match(job_ad: Mapping[str, Any], offer_ad: Mapping[str, Any],
                    job_requirements: ClassAdExpr | None = None,
                    start_expr: ClassAdExpr | None = None) -> bool:
    """HTCondor negotiation: job.Requirements(machine) AND machine.START(job).

    Also honours resource-quantity sanity (request_* <= offered *) so a job
    can never be matched onto a smaller worker even if expressions pass."""
    for res in ("cpus", "gpus", "memory", "disk", "chips", "hbm_gb"):
        want = job_ad.get(f"request_{res}", 0) or 0
        have = offer_ad.get(res, 0) or 0
        if want > have:
            return False
    if job_requirements is not None and not job_requirements.evaluate(
            job_ad, offer_ad):
        return False
    if start_expr is not None and not start_expr.evaluate(offer_ad, job_ad):
        return False
    return True
