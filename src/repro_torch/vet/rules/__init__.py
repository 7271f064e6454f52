"""Registry of the AST rules applied by the code analyzer."""
from __future__ import annotations

from typing import List

from repro_torch.vet.rules.base import Rule, RuleContext
from repro_torch.vet.rules.host_sync import HostSyncRule
from repro_torch.vet.rules.jit_hot_path import JitHotPathRule
from repro_torch.vet.rules.lock_discipline import (LockDisciplineRule,
                                             LockedSuffixRule)
from repro_torch.vet.rules.nondet_key import NondetKeyRule

ALL_RULES: List[Rule] = [
    JitHotPathRule(),
    HostSyncRule(),
    LockDisciplineRule(),
    LockedSuffixRule(),
    NondetKeyRule(),
]

__all__ = ["ALL_RULES", "Rule", "RuleContext", "HostSyncRule",
           "JitHotPathRule", "LockDisciplineRule", "LockedSuffixRule",
           "NondetKeyRule"]
