"""code-jit-per-call: a compiled or built callable constructed per call.

``torch.compile(...)``, ``torch.jit.script(...)`` / ``torch.jit.trace(...)``
and the port's kernel build entry (``kernels/build.py``'s ``build()``)
construct a new compiled object every time they run: called per request,
every invocation recompiles (or re-runs ``nvcc``), which is exactly the
rebuild-per-call pattern the plan/engine cache exists to kill.  Inside
hot-path modules the rule flags any such construction inside a function
body unless it is provably one-time or memoized:

  * constructed in ``__init__``/``__post_init__``/``__new__`` (object
    construction happens once per engine, not per request);
  * the result is stored into a container slot (``cache[k] = fn`` — the
    memoization idiom of ``tuner/cache.py``), directly or via a local;
  * at module level (import time).

A construction inside a loop is flagged unconditionally.
"""
from __future__ import annotations

import ast
from typing import List

from repro_torch.vet.findings import Finding
from repro_torch.vet.rules.base import (Rule, RuleContext, call_name,
                                        enclosing_map, inside, iter_functions)

JIT_CALLS = ("torch.compile", "torch.jit.script", "torch.jit.trace",
             "jit.script", "jit.trace", "build.build", "kernels.build.build",
             "repro_torch.kernels.build.build")
CTOR_NAMES = ("__init__", "__post_init__", "__new__")


class JitHotPathRule(Rule):
    rule_id = "code-jit-per-call"
    description = ("torch.compile / torch.jit / the kernel build constructed "
                   "inside per-request serving/tuner call paths")

    def check(self, ctx: RuleContext) -> List[Finding]:
        if not ctx.is_hot_module():
            return []
        out: List[Finding] = []
        for qual, func, _cls in iter_functions(ctx.tree):
            name = qual.rsplit(".", 1)[-1]
            parents = enclosing_map(func)
            # locals that ever get stored into a container slot
            memoized_locals = set()
            for node in ast.walk(func):
                if isinstance(node, ast.Assign):
                    for tgt in node.targets:
                        if isinstance(tgt, ast.Subscript) and \
                                isinstance(node.value, ast.Name):
                            memoized_locals.add(node.value.id)
            for node in ast.walk(func):
                if not (isinstance(node, ast.Call)
                        and call_name(node) in JIT_CALLS):
                    continue
                # skip constructions belonging to a nested def (handled there)
                owner = inside(node, parents,
                               (ast.FunctionDef, ast.AsyncFunctionDef))
                if owner is not None and owner is not func:
                    continue
                what = call_name(node)
                in_loop = inside(node, parents, (ast.For, ast.While))
                if in_loop is not None:
                    f = self.finding(
                        ctx, node.lineno, qual,
                        f"{what}(...) inside a loop — recompiles every "
                        "iteration")
                    if f:
                        out.append(f)
                    continue
                if name in CTOR_NAMES:
                    continue
                assign = parents.get(node)
                if isinstance(assign, ast.Assign):
                    tgts = assign.targets
                    if any(isinstance(t, ast.Subscript) for t in tgts):
                        continue                  # cache[k] = torch.compile(.)
                    if any(isinstance(t, ast.Name)
                           and t.id in memoized_locals for t in tgts):
                        continue                  # fn = compile(..); cache[k]=fn
                f = self.finding(
                    ctx, node.lineno, qual,
                    f"{what}(...) in a per-request call path — build once "
                    "(constructor) or memoize it (plan/engine cache)")
                if f:
                    out.append(f)
        return out
