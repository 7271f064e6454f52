"""Variant driver: trace one dry-run cell under a named variant and report
the three roofline terms — the measurement half of a hypothesis -> change
-> measure loop over the fleet layout.

The counterpart of ``repro/launch/perf.py`` on the H100 dry-run
(``launch/dryrun.py``):

    PYTHONPATH=src python -m repro_torch.launch.perf --device cpu \\
        --arch qwen3-1.7b --cell train_4k --variant mesh64x4 remat_dots

Variants combine mesh shape, sharding rules, remat policy, microbatching
and the attention / MoE knobs; ``a+b`` composes two.  Every variant keeps
the fleet's card count (256, or 512 for a three-axis mesh).
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, Optional

from repro_torch.configs.base import SHAPE_BY_NAME
from repro_torch.configs.registry import get_config
from repro_torch.device import Device
from repro_torch.distributed.sharding import sp_rules
from repro_torch.launch import mesh as MS
from repro_torch.launch.dryrun import lower_cell
from repro_torch.training.train_step import TrainConfig

#: the config fields a variant may change, carried over by ``a+b``
_CFG_FIELDS = ("remat_policy", "sliding_window", "attn_block_kv", "remat",
               "banded_attention", "attn_block_q", "moe_dispatch_dtype",
               "moe_group")


def variant_kwargs(name: str, arch: str) -> Dict[str, Any]:
    """:func:`lower_cell` keywords of a named variant (single-pod unless
    noted), as the reference's ``variant_kwargs`` (``perf.py:27-88``)."""
    cfg = get_config(arch)
    v: Dict[str, Any] = {"multi_pod": False, "extra_tag": f"/{name}"}
    if "+" in name:                               # composition a+b
        merged = cfg
        for part in name.split("+"):
            pv = variant_kwargs(part, arch)
            if "cfg_override" in pv:
                delta = {f: getattr(pv["cfg_override"], f)
                         for f in _CFG_FIELDS
                         if getattr(pv["cfg_override"], f) != getattr(cfg, f)}
                merged = merged.scaled(**delta)
                v["cfg_override"] = merged
            for k in ("mesh_override", "tc", "rules"):
                if k in pv:
                    v[k] = pv[k]
        return v
    if name == "baseline":
        pass
    elif name.startswith("mesh"):                 # mesh64x4, mesh2x32x8
        dims = tuple(int(x) for x in name[4:].split("x"))
        if len(dims) == 3:
            v["mesh_override"] = (dims, ("pod", "data", "model"))
            v["multi_pod"] = True
        else:
            v["mesh_override"] = (dims, ("data", "model"))
    elif name == "remat_dots":
        v["cfg_override"] = cfg.scaled(remat_policy="dots")
    elif name == "remat_none":
        v["cfg_override"] = cfg.scaled(remat=False)
    elif name.startswith("mb") and name.endswith("gc"):   # mb1gc
        v["tc"] = TrainConfig(microbatches=int(name[2:-2]),
                              grad_compress=True)
    elif name.startswith("mb"):                   # mb1, mb8, mb16
        v["tc"] = TrainConfig(microbatches=int(name[2:]))
    elif name == "grad_compress":
        v["tc"] = TrainConfig(microbatches=4, grad_compress=True)
    elif name == "seqpar":
        v["rules"] = sp_rules()
    elif name == "banded":                        # SWA band-skip attention
        v["cfg_override"] = cfg.scaled(banded_attention=True)
    elif name.startswith("bq"):                   # bq1024
        v["cfg_override"] = cfg.scaled(banded_attention=True,
                                       attn_block_q=int(name[2:]))
    elif name.startswith("swa"):                  # swa1024
        v["cfg_override"] = cfg.scaled(sliding_window=int(name[3:]))
    elif name.startswith("blockkv"):              # blockkv4096
        v["cfg_override"] = cfg.scaled(attn_block_kv=int(name[7:]))
    elif name == "moebf16":                       # bf16 dispatch weights
        v["cfg_override"] = cfg.scaled(moe_dispatch_dtype="bfloat16")
    elif name.startswith("moegroup"):             # moegroup256
        v["cfg_override"] = cfg.scaled(moe_group=int(name[8:]))
    else:
        raise ValueError(f"unknown variant {name}")
    return v


def run_variant(arch: str, cell_name: str, variant: str,
                out_path: Optional[str] = None,
                device: Device = None) -> Dict:
    """Trace ``arch`` x ``cell_name`` under ``variant``; print and return
    its record (appended to ``out_path`` as JSONL)."""
    cell = SHAPE_BY_NAME[cell_name]
    rec = lower_cell(arch, cell, device=device,
                     **variant_kwargs(variant, arch))
    rec["variant"] = variant
    print(f"{arch} x {cell_name} [{variant}]: "
          f"compute {rec['t_compute_s']:.3f}s  "
          f"memory {rec['t_memory_s']:.3f}s  "
          f"collective {rec['t_collective_s']:.3f}s  "
          f"-> {rec['bottleneck']}  mfu@roof {rec['mfu_at_roofline']:.3f}  "
          f"perdev {rec['per_device_gb']:.1f}GB "
          f"(trace {rec['trace_s']}s)", flush=True)
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--cell", required=True)
    ap.add_argument("--variant", default=["baseline"], nargs="+")
    ap.add_argument("--out", default="results/perf_iterations.jsonl")
    ap.add_argument("--device", default=None,
                    help="the mesh's device type (default: the card)")
    args = ap.parse_args(argv)
    failed = 0
    try:
        for v in args.variant:
            try:
                run_variant(args.arch, args.cell, v, args.out, args.device)
            except Exception as e:                    # noqa: BLE001
                failed += 1
                print(f"{args.arch} x {args.cell} [{v}]: FAILED {e}",
                      flush=True)
    finally:
        MS.release()
    if failed:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
