"""CommContract: declarative expectations over a CommPlan
(``paddle_tpu/analysis/comm/contract.py``, the same class).

A contract turns a placement invariant into data that ships next to the
code establishing it::

    from paddle_tpu_torch.analysis.comm import CommContract

    c = CommContract("zero-boundary-reduce")
    c.forbid(kind="reduce", in_loop=True)          # never per-iteration
    c.expect(kind="reduce", axis="dp", min_count=1,
             in_loop=False)                        # one per step
    c.forbid_reshard(r"^h_")                       # activations stay put
    violations = c.check(exe.last_comm_plan)

The port's plan is one rank's collective log of one step
(``plan.py``); ``attach_comm_contract`` keeps contracts on a program for
a caller to evaluate against ``Executor.last_comm_plan``.  Canned
contracts for the training invariants live in
``paddle_tpu_torch/parallel/contracts.py``.
"""

import re

from .plan import KIND_CLASSES

__all__ = ["CommContract", "attach_comm_contract", "comm_contracts"]

_CONTRACT_ATTR = "_comm_contracts"


class CommContract:
    """A named set of expectations over one executable's CommPlan.

    * ``expect(...)`` — collectives matching the selector must appear
      with the given multiplicity (``count`` exact, or
      ``min_count`` / ``max_count`` bounds; default ``min_count=1``).
      Matched ops are *covered* — ``hlo.accidental-reshard`` treats
      covered gathers as intentional;
    * ``forbid(...)`` — any matching collective is a violation;
    * ``forbid_reshard(var_pattern)`` — any collective whose
      sharding-annotation provenance (``pt_shard[var]`` /
      ``pt_pin[site]`` named scopes) matches the regex is a violation:
      the annotated variable must never cost communication.
    """

    def __init__(self, name):
        self.name = name
        self.rules = []

    # -- declaration ---------------------------------------------------
    def expect(self, kind, axis=None, count=None, min_count=None,
               max_count=None, in_loop=None, phase=None):
        """Expect collectives of ``kind`` (an HLO kind, or a class alias
        'reduce' / 'gather' / 'any') over mesh ``axis`` with the given
        multiplicity.  ``in_loop`` / ``phase`` narrow the selector;
        ``count`` pins an exact count, else ``min_count`` (default 1)
        and ``max_count`` bound it."""
        self._validate_kind(kind)
        if count is not None:
            min_count = max_count = int(count)
        elif min_count is None and max_count is None:
            min_count = 1
        self.rules.append({
            "rule": "expect", "kind": kind, "axis": axis,
            "min_count": min_count, "max_count": max_count,
            "in_loop": in_loop, "phase": phase,
        })
        return self

    def forbid(self, kind="any", axis=None, in_loop=None, phase=None):
        """Any collective matching the selector is a violation."""
        self._validate_kind(kind)
        self.rules.append({
            "rule": "forbid", "kind": kind, "axis": axis,
            "in_loop": in_loop, "phase": phase,
        })
        return self

    def forbid_reshard(self, var_pattern):
        """Any collective attributed (via ``pt_shard[var]`` /
        ``pt_pin[site]`` provenance) to a variable matching
        ``var_pattern`` is a violation — the annotated activation must
        never be reshuffled across chips."""
        re.compile(var_pattern)  # fail fast on a bad regex
        self.rules.append({
            "rule": "forbid_reshard", "pattern": var_pattern,
        })
        return self

    @staticmethod
    def _validate_kind(kind):
        from .plan import ALL_COLLECTIVES

        if kind is not None and kind not in KIND_CLASSES \
                and kind not in ALL_COLLECTIVES:
            raise ValueError(
                f"unknown collective kind {kind!r} (valid: "
                f"{sorted(KIND_CLASSES)} or one of "
                f"{list(ALL_COLLECTIVES)})")

    # -- evaluation ----------------------------------------------------
    def check(self, plan):
        """Evaluate against a :class:`CommPlan`.  Returns a list of
        violation dicts (empty = contract holds), each carrying the
        rule, a human message, and the offending/matched ops with their
        kind/axes/phase/loop attribution."""
        violations = []
        for rule in self.rules:
            if rule["rule"] == "expect":
                ops = plan.select(
                    kind=rule["kind"], axis=rule["axis"],
                    in_loop=rule["in_loop"], phase=rule["phase"])
                n = len(ops)
                lo, hi = rule["min_count"], rule["max_count"]
                if (lo is not None and n < lo) or (
                        hi is not None and n > hi):
                    want = (f"exactly {lo}" if lo == hi
                            else f">= {lo}" if hi is None
                            else f"<= {hi}" if lo is None
                            else f"{lo}..{hi}")
                    violations.append(self._violation(
                        rule, ops,
                        f"expected {want} {self._sel(rule)} "
                        f"collective(s), found {n}"))
            elif rule["rule"] == "forbid":
                ops = plan.select(
                    kind=rule["kind"], axis=rule["axis"],
                    in_loop=rule["in_loop"], phase=rule["phase"])
                if ops:
                    violations.append(self._violation(
                        rule, ops,
                        f"{len(ops)} forbidden {self._sel(rule)} "
                        f"collective(s) present"))
            else:  # forbid_reshard
                ops = plan.select(provenance=rule["pattern"])
                if ops:
                    pat = re.compile(rule["pattern"])
                    names = sorted({
                        n for op in ops
                        for n in op.provenance_names()
                        if pat.search(n)})
                    violations.append(self._violation(
                        rule, ops,
                        f"{len(ops)} collective(s) attributed to "
                        f"forbidden reshard var(s) {names} "
                        f"(pattern {rule['pattern']!r})"))
        return violations

    def loop_insensitive(self):
        """A copy holding only the rules whose semantics survive loop
        fusion (``forbid_reshard`` — provenance-based, no in_loop/phase
        selector).  ``run_steps`` fuses N optimizer steps into one
        while loop, which confounds every loop/phase selector but not
        the reshard rules; the ``hlo.comm-contract`` check evaluates
        this subset on fused compiles."""
        c = CommContract(self.name)
        c.rules = [dict(r) for r in self.rules
                   if r["rule"] == "forbid_reshard"]
        return c

    def covered(self, plan):
        """Ops any ``expect`` rule of this contract matches — the
        intentional-communication set ``hlo.accidental-reshard``
        subtracts."""
        out = []
        for rule in self.rules:
            if rule["rule"] != "expect":
                continue
            out += plan.select(
                kind=rule["kind"], axis=rule["axis"],
                in_loop=rule["in_loop"], phase=rule["phase"])
        return out

    def _violation(self, rule, ops, message):
        return {
            "contract": self.name, "rule": dict(rule),
            "message": message,
            "ops": [op.describe() for op in ops[:8]],
            "op_count": len(ops),
            "bytes": sum(op.bytes for op in ops),
        }

    @staticmethod
    def _sel(rule):
        parts = [rule.get("kind") or "any"]
        if rule.get("axis"):
            parts.append(f"@{rule['axis']}")
        if rule.get("phase"):
            parts.append(f"phase={rule['phase']}")
        if rule.get("in_loop") is True:
            parts.append("in-loop")
        elif rule.get("in_loop") is False:
            parts.append("boundary-level")
        return " ".join(parts)

    def to_dict(self):
        return {"name": self.name, "rules": [dict(r) for r in self.rules]}

    def __repr__(self):
        return f"CommContract({self.name!r}, {len(self.rules)} rules)"


def attach_comm_contract(program, contract):
    """Attach ``contract`` to ``program`` — the Executor's compile-time
    fold-in (and ``lint``) then evaluates it against every compiled
    step's CommPlan (``hlo.comm-contract``).  Multiple contracts
    accumulate; returns the contract for chaining."""
    existing = list(getattr(program, _CONTRACT_ATTR, ()) or ())
    existing.append(contract)
    setattr(program, _CONTRACT_ATTR, existing)
    return contract


def comm_contracts(program):
    """The contracts attached to ``program`` (possibly empty)."""
    if program is None:
        return []
    return list(getattr(program, _CONTRACT_ATTR, ()) or ())
