"""code-host-sync: device->host synchronization inside serving/tuner hot paths.

``.item()``, ``.tolist()``, ``.cpu()`` and ``.numpy()`` on a card tensor,
``np.asarray`` / ``np.array`` / ``float()`` on one, ``torch.cuda.
synchronize()`` and ``Stream.synchronize()`` / ``Event.synchronize()`` all
stall the Python thread until the device catches up.  On an admission or
batch-execution path that serializes the pipeline — the device drains
while the scheduler waits, killing the continuous-batching overlap.

The rule fires only inside hot-path functions (``submit``,
``_run_batch``, ...; configurable) of hot-path modules.  Intentional
syncs (e.g. anchoring a latency metric to real completion) belong in
the baseline with a documented reason.
"""
from __future__ import annotations

import ast
from typing import List, Optional

from repro_torch.vet.findings import Finding
from repro_torch.vet.rules.base import (Rule, RuleContext, call_name,
                                        iter_functions)

SYNC_CALLS = ("np.asarray", "np.array", "numpy.asarray", "numpy.array",
              "torch.cuda.synchronize")
#: methods of a tensor (item ... numpy) or of a stream / event (synchronize)
SYNC_METHODS = ("item", "tolist", "cpu", "numpy", "synchronize")


class HostSyncRule(Rule):
    rule_id = "code-host-sync"
    description = ("host synchronization (.item() / .cpu() / np.asarray / "
                   "float() / torch.cuda.synchronize()) inside serving/tuner "
                   "hot paths")

    def check(self, ctx: RuleContext) -> List[Finding]:
        if not ctx.is_hot_module():
            return []
        out: List[Finding] = []
        for qual, func, _cls in iter_functions(ctx.tree):
            name = qual.rsplit(".", 1)[-1]
            if not ctx.is_hot_function(name):
                continue
            for node in ast.walk(func):
                if not isinstance(node, ast.Call):
                    continue
                msg = self._classify(node)
                if msg is None:
                    continue
                f = self.finding(ctx, node.lineno, qual, msg)
                if f:
                    out.append(f)
        return out

    @staticmethod
    def _classify(node: ast.Call) -> Optional[str]:
        cn = call_name(node)
        if cn in SYNC_CALLS:
            return (f"{cn}(...) waits for the device on a hot path — keep "
                    "results on the card until the caller asks")
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr in SYNC_METHODS:
            return (f".{node.func.attr}() blocks the scheduling thread "
                    "until the device drains — overlap is lost for every "
                    "queued batch behind it")
        if cn == "float" and node.args \
                and not isinstance(node.args[0], ast.Constant):
            return ("float(...) on a non-literal forces a device sync if "
                    "the value is a card tensor")
        return None
