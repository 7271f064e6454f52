"""code-lock-discipline / code-locked-suffix: shared-state locking lint.

The serving layer runs a scheduler thread plus N caller threads; its
convention is: shared attributes are mutated only under ``with
self._lock:`` (or ``self._cond``), and methods that *assume* the lock is
already held carry a ``_locked`` suffix and are only called from inside
a with-lock block (or from another ``*_locked`` method).

  code-lock-discipline   an attribute of ``self`` is mutated both under
                         a lock and outside one (outside ``__init__``) —
                         at least one of the two sites is a data race
  code-locked-suffix     a ``self.foo_locked(...)`` call happens outside
                         any with-lock block in a method that is not
                         itself ``*_locked``

Lock attributes are discovered from ``__init__``: any ``self.X =
threading.Lock()/RLock()/Condition()`` assignment.  Classes without a
lock attribute are skipped entirely — single-threaded helpers don't
carry a locking convention to enforce.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.vet.findings import Finding
from repro_torch.vet.rules.base import (Rule, RuleContext, call_name,
                                  enclosing_map, inside, self_attr,
                                  with_lock_items)

LOCK_CTORS = ("threading.Lock", "threading.RLock", "threading.Condition",
              "Lock", "RLock", "Condition")

#: method names that mutate their receiver in place
MUTATING_METHODS = ("append", "appendleft", "extend", "add", "remove",
                    "discard", "pop", "popleft", "clear", "update",
                    "setdefault", "insert", "sort")


def _lock_attrs(cls: ast.ClassDef) -> Set[str]:
    """Names of self attributes bound to a threading primitive in __init__."""
    locks: Set[str] = set()
    for node in cls.body:
        if not (isinstance(node, ast.FunctionDef) and node.name == "__init__"):
            continue
        for stmt in ast.walk(node):
            if not isinstance(stmt, ast.Assign):
                continue
            if not (isinstance(stmt.value, ast.Call)
                    and call_name(stmt.value) in LOCK_CTORS):
                continue
            for tgt in stmt.targets:
                attr = self_attr(tgt)
                if attr:
                    locks.add(attr)
    return locks


def _mutated_attr(node: ast.AST, parents: dict) -> Optional[str]:
    """The self-attribute ``node`` mutates, if it is a mutation site."""
    if isinstance(node, ast.AugAssign):                 # self.x += 1
        return self_attr(node.target)
    if isinstance(node, ast.Assign):                    # self.x = v / self.d[k]=v
        for tgt in node.targets:
            attr = self_attr(tgt)
            if attr:
                return attr
            if isinstance(tgt, ast.Subscript):
                attr = self_attr(tgt.value)
                if attr:
                    return attr
        return None
    if isinstance(node, ast.Call) \
            and isinstance(node.func, ast.Attribute) \
            and node.func.attr in MUTATING_METHODS:     # self.q.append(v)
        return self_attr(node.func.value)
    return None


class LockDisciplineRule(Rule):
    rule_id = "code-lock-discipline"
    description = ("self attribute mutated both under and outside the "
                   "instance lock (data race)")

    def check(self, ctx: RuleContext) -> List[Finding]:
        if not ctx.is_hot_module():
            return []
        out: List[Finding] = []
        for cls in ast.walk(ctx.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            locks = _lock_attrs(cls)
            if not locks:
                continue
            # attr -> {"locked": [(qual, line)], "unlocked": [(qual, line)]}
            sites: Dict[str, Dict[str, List[Tuple[str, int]]]] = {}
            for meth in cls.body:
                if not isinstance(meth, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                    continue
                if meth.name == "__init__":
                    continue
                parents = enclosing_map(meth)
                qual = f"{cls.name}.{meth.name}"
                # *_locked methods run with the lock held by convention
                held_by_name = meth.name.endswith("_locked")
                for node in ast.walk(meth):
                    attr = _mutated_attr(node, parents)
                    if attr is None or attr in locks:
                        continue
                    w = inside(node, parents, (ast.With, ast.AsyncWith))
                    held = held_by_name
                    while w is not None and not held:
                        if with_lock_items(w, locks):
                            held = True
                        w = inside(w, parents, (ast.With, ast.AsyncWith))
                    bucket = "locked" if held else "unlocked"
                    sites.setdefault(attr, {"locked": [], "unlocked": []})
                    sites[attr][bucket].append((qual, node.lineno))
            for attr, s in sorted(sites.items()):
                if not (s["locked"] and s["unlocked"]):
                    continue
                for qual, line in s["unlocked"]:
                    locked_at = ", ".join(
                        f"{q}:{ln}" for q, ln in s["locked"][:3])
                    f = self.finding(
                        ctx, line, qual,
                        f"self.{attr} mutated without the lock here but "
                        f"under it at {locked_at} — one of the two sites "
                        "races")
                    if f:
                        out.append(f)
        return out


class LockedSuffixRule(Rule):
    rule_id = "code-locked-suffix"
    description = ("*_locked method called without holding the instance "
                   "lock")

    def check(self, ctx: RuleContext) -> List[Finding]:
        if not ctx.is_hot_module():
            return []
        out: List[Finding] = []
        for cls in ast.walk(ctx.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            locks = _lock_attrs(cls)
            if not locks:
                continue
            for meth in cls.body:
                if not isinstance(meth, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                    continue
                if meth.name.endswith("_locked"):
                    continue            # callee context: lock already held
                parents = enclosing_map(meth)
                qual = f"{cls.name}.{meth.name}"
                for node in ast.walk(meth):
                    if not (isinstance(node, ast.Call)
                            and isinstance(node.func, ast.Attribute)
                            and node.func.attr.endswith("_locked")
                            and self_attr(node.func) is not None):
                        continue
                    held = False
                    w = inside(node, parents, (ast.With, ast.AsyncWith))
                    while w is not None and not held:
                        if with_lock_items(w, locks):
                            held = True
                        w = inside(w, parents, (ast.With, ast.AsyncWith))
                    if held:
                        continue
                    f = self.finding(
                        ctx, node.lineno, qual,
                        f"self.{node.func.attr}() assumes the lock is held "
                        "(by naming convention) but no enclosing with-lock "
                        "block acquires it")
                    if f:
                        out.append(f)
        return out
