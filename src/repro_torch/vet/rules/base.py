"""Shared AST machinery for the repro-specific code rules.

Each rule is a :class:`Rule` subclass with a stable ``rule_id`` and a
``check(ctx)`` returning findings.  ``RuleContext`` carries the parsed
tree, the repo-relative path, and the vet config (hot-path module and
function lists, per-rule severities).  Setting a code rule's severity to
``"off"`` in ``[tool.repro-torch-vet.severity]`` disables it.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Iterator, List, Optional, Tuple

from repro_torch.vet.config import VetConfig
from repro_torch.vet.findings import Finding


@dataclasses.dataclass
class RuleContext:
    cfg: VetConfig
    path: str                       # repo-relative, forward slashes
    tree: ast.Module

    def is_hot_module(self) -> bool:
        parts = self.path.replace("\\", "/").split("/")
        return any(m in parts for m in self.cfg.hot_path_modules)

    def is_hot_function(self, name: str) -> bool:
        return name in self.cfg.hot_path_functions


class Rule:
    rule_id: str = ""
    description: str = ""

    def check(self, ctx: RuleContext) -> List[Finding]:  # pragma: no cover
        raise NotImplementedError

    def finding(self, ctx: RuleContext, line: int, symbol: str,
                message: str) -> Optional[Finding]:
        sev = ctx.cfg.severity_of(self.rule_id)
        if sev == "off":
            return None
        return Finding(rule=self.rule_id, severity=sev, path=ctx.path,
                       line=line, symbol=symbol, message=message)


def dotted_name(node: ast.AST) -> str:
    """'torch.compile' for Name/Attribute chains; '' for anything dynamic."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def call_name(node: ast.Call) -> str:
    return dotted_name(node.func)


def iter_functions(tree: ast.Module
                   ) -> Iterator[Tuple[str, ast.AST, Optional[ast.ClassDef]]]:
    """(qualname, function node, enclosing class) for every def/async def."""

    def walk(node: ast.AST, prefix: str, cls: Optional[ast.ClassDef]):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{prefix}{child.name}"
                yield qual, child, cls
                yield from walk(child, qual + ".", cls)
            elif isinstance(child, ast.ClassDef):
                yield from walk(child, f"{prefix}{child.name}.", child)

    yield from walk(tree, "", None)


def enclosing_map(func: ast.AST) -> dict:
    """node -> parent map for one function body."""
    parents = {}
    for parent in ast.walk(func):
        for child in ast.iter_child_nodes(parent):
            parents[child] = parent
    return parents


def inside(node: ast.AST, parents: dict, kinds: tuple) -> Optional[ast.AST]:
    """The nearest ancestor of ``node`` matching ``kinds``, if any."""
    cur = parents.get(node)
    while cur is not None:
        if isinstance(cur, kinds):
            return cur
        cur = parents.get(cur)
    return None


def with_lock_items(node: ast.With, lock_attrs: set) -> bool:
    """True if a ``with`` statement acquires one of the class's locks."""
    for item in node.items:
        expr = item.context_expr
        # `with self._lock:` / `with self._cond:`
        if isinstance(expr, ast.Attribute) and \
                isinstance(expr.value, ast.Name) and expr.value.id == "self" \
                and expr.attr in lock_attrs:
            return True
    return False


def self_attr(node: ast.AST) -> Optional[str]:
    """'x' when node is exactly ``self.x``."""
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None
