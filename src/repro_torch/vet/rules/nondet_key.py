"""code-nondet-key: unordered collections flowing into cache-key strings.

The plan cache keys plans by a string/tuple fingerprint; iterating a
``set``/``frozenset`` (or ``dict`` whose insertion order is
call-dependent) while building that fingerprint makes the key depend on
iteration order — two processes (or two runs under hash randomization)
compute different keys for the same plan, silently duplicating cache
entries and invalidating persisted plans.

The rule scans functions whose name mentions ``key`` / ``fingerprint`` /
``cache_token`` and flags joins or tuple/str constructions over an
expression that is syntactically a set (set literal, ``set(...)``,
``frozenset(...)``, ``SetComp``) unless it is wrapped in ``sorted(...)``.
"""
from __future__ import annotations

import ast
from typing import List

from repro_torch.vet.findings import Finding
from repro_torch.vet.rules.base import (Rule, RuleContext, call_name,
                                  enclosing_map, iter_functions)

KEYISH = ("key", "fingerprint", "cache_token")


def _is_setlike(node: ast.AST) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call) and call_name(node) in ("set", "frozenset"):
        return True
    return False


class NondetKeyRule(Rule):
    rule_id = "code-nondet-key"
    description = ("set iteration order leaks into a cache key / "
                   "fingerprint (nondeterministic across processes)")

    def check(self, ctx: RuleContext) -> List[Finding]:
        if not ctx.is_hot_module():
            return []
        out: List[Finding] = []
        for qual, func, _cls in iter_functions(ctx.tree):
            name = qual.rsplit(".", 1)[-1].lower()
            if not any(k in name for k in KEYISH):
                continue
            parents = enclosing_map(func)
            # set-typed local names (x = {..} / x = set(..))
            set_locals = set()
            for node in ast.walk(func):
                if isinstance(node, ast.Assign) and _is_setlike(node.value):
                    for tgt in node.targets:
                        if isinstance(tgt, ast.Name):
                            set_locals.add(tgt.id)

            def setlike(expr: ast.AST) -> bool:
                return _is_setlike(expr) or (
                    isinstance(expr, ast.Name) and expr.id in set_locals)

            for node in ast.walk(func):
                if not isinstance(node, ast.Call):
                    continue
                cn = call_name(node)
                if cn == "sorted":
                    continue
                bad = None
                # ".".join(s) / str(s) / tuple(s) / list(s) over a set
                if isinstance(node.func, ast.Attribute) \
                        and node.func.attr == "join" and node.args:
                    if setlike(node.args[0]):
                        bad = node.args[0]
                elif cn in ("str", "tuple", "list", "repr") and node.args:
                    if setlike(node.args[0]):
                        bad = node.args[0]
                if bad is None:
                    continue
                # sorted(...) anywhere between the set and the sink is fine
                cur = parents.get(bad)
                shielded = False
                while cur is not None and cur is not func:
                    if isinstance(cur, ast.Call) \
                            and call_name(cur) == "sorted":
                        shielded = True
                        break
                    cur = parents.get(cur)
                if shielded:
                    continue
                f = self.finding(
                    ctx, node.lineno, qual,
                    "set iteration order flows into a key/fingerprint — "
                    "wrap the set in sorted(...) to make the key "
                    "deterministic across processes")
                if f:
                    out.append(f)
        return out
