"""Multi-chip scaling harness: times the sharded SPMD fleet step at a
range of mesh sizes and reports throughput + parallel efficiency.

The reference has no distributed backend to compare against (SURVEY
§2.6 — one process, sequential agents); the BASELINE north star asks
for ≥85% scaling efficiency to 4 hosts. On GPUs the mesh axes ride
NVLink; under the virtual CPU mesh
(--xla_force_host_platform_device_count) the harness proves the SPMD
program and measures relative efficiency only — on hosts with fewer
physical cores than virtual devices the wall-clock table mostly
measures oversubscription (tools/collective_audit.py gives the
host-independent collective/FLOP audit).

Run as a script for the scaling table:
    python -m lsc_dr_planner_tpu.parallel.scaling
"""

from __future__ import annotations

import time
from typing import Sequence

import jax
import numpy as np


def measure_scaling(device_counts: Sequence[int] = (1, 2, 4, 8),
                    A_per_device: int = 16, steps: int = 10,
                    fixed_total: bool = False):
    """Time the sharded full-pipeline step over meshes of growing size.

    Weak scaling by default (A = A_per_device × n_devices); pass
    `fixed_total=True` for strong scaling at A = A_per_device ×
    max(device_counts). Returns a list of row dicts.
    """
    import __graft_entry__ as graft

    from lsc_dr_planner_tpu.parallel import mesh as meshmod

    rows = []
    max_dev = max(device_counts)
    for nd in device_counts:
        if nd > len(jax.devices()):
            continue
        A = A_per_device * (max_dev if fixed_total else nd)
        planner, fleet, inp = graft._build(n_agents=A)
        mesh = meshmod.make_mesh(nd)
        fleet_s, inp_s = meshmod.shard_step_inputs(mesh, fleet, inp)
        step = meshmod.make_sharded_step(planner, mesh)

        out = step(fleet_s, inp_s)  # compile
        out.desired_ctrl.block_until_ready()
        t0 = time.perf_counter()
        for _ in range(steps):
            out = step(fleet_s, inp_s)
        out.desired_ctrl.block_until_ready()
        dt = (time.perf_counter() - t0) / steps
        rows.append({
            "devices": nd,
            "agents": A,
            "step_ms": dt * 1e3,
            "steps_per_s": 1.0 / dt,
            "agent_steps_per_s": A / dt,
        })

    # parallel efficiency vs the 1-device row
    base = next((r for r in rows if r["devices"] == 1), None)
    for r in rows:
        if base is None:
            r["efficiency"] = float("nan")
        elif fixed_total:
            r["efficiency"] = (
                base["step_ms"] / (r["step_ms"] * r["devices"])
            )
        else:
            # weak scaling: perfect = constant step time
            r["efficiency"] = base["step_ms"] / r["step_ms"]
    return rows


def main():
    import json

    rows = measure_scaling()
    for r in rows:
        print(json.dumps({k: round(v, 3) if isinstance(v, float) else v
                          for k, v in r.items()}))


if __name__ == "__main__":
    main()
