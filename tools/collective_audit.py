"""Collective audit of the sharded SPMD fleet step.

Wall-clock scaling cannot be demonstrated on a CPU host with virtual
devices (they oversubscribe the cores, so weak scaling degrades by
construction). What CAN be verified host-independently:

  1. the per-device compiled HLO's collective ops — kind, count, and
     communicated BYTES per step — stay O(A_local * neighbor-state),
     not O(A^2);
  2. per-device FLOPs shrink ~1/devices (weak-scaling invariance of
     the compute).

Usage: python tools/collective_audit.py [--A 64] [--devices 1,2,4,8]
"""

import argparse
import json
import os
import re
import sys

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
if "xla_force_host_platform_device_count" not in os.environ["XLA_FLAGS"]:
    os.environ["XLA_FLAGS"] += " --xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

_DTYPE_BYTES = {"f32": 4, "s32": 4, "u32": 4, "pred": 1, "f64": 8,
                "s64": 8, "u8": 1, "bf16": 2, "f16": 2}


def _shape_bytes(shape_str):
    """'f32[128,60]' -> bytes; tuple shapes '(f32[..], s32[..])' -> sum."""
    total = 0
    for m in re.finditer(r"(\w+)\[([\d,]*)\]", shape_str):
        dt, dims = m.group(1), m.group(2)
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES.get(dt, 4)
    return total


def audit(A, nd):
    import __graft_entry__ as graft
    from lsc_dr_planner_tpu.parallel import mesh as meshmod

    planner, fleet, inp = graft._build(n_agents=A)
    mesh = meshmod.make_mesh(nd)
    fleet_s, inp_s = meshmod.shard_step_inputs(mesh, fleet, inp)
    step = meshmod.make_sharded_step(planner, mesh)
    lowered = step.lower(fleet_s, inp_s)
    compiled = lowered.compile()
    hlo = compiled.as_text()

    colls = {}
    bytes_total = 0
    for line in hlo.splitlines():
        m = re.search(r"= ((?:\([^)]*\)|\S+)) (all-reduce|all-gather|"
                      r"reduce-scatter|collective-permute|all-to-all)"
                      r"(?:-start)?\(", line)
        if m:
            kind = m.group(2)
            colls[kind] = colls.get(kind, 0) + 1
            bytes_total += _shape_bytes(m.group(1))
    try:
        cost = compiled.cost_analysis()
        if isinstance(cost, list):
            cost = cost[0]
        flops = cost.get("flops", float("nan"))
    except Exception:
        flops = float("nan")
    return {"A": A, "devices": nd, "collectives": colls,
            "collective_bytes_per_step_per_device": bytes_total,
            "flops_per_device": flops}


def _hlo_collectives(hlo):
    colls = {}
    bytes_total = 0
    for line in hlo.splitlines():
        m = re.search(r"= ((?:\([^)]*\)|\S+)) (all-reduce|all-gather|"
                      r"reduce-scatter|collective-permute|all-to-all)"
                      r"(?:-start)?\(", line)
        if m:
            kind = m.group(2)
            colls[kind] = colls.get(kind, 0) + 1
            bytes_total += _shape_bytes(m.group(1))
    return colls, bytes_total


def audit_halo(A, nd, hops=1):
    """SURVEY §5.8 halo exchange vs the all-gather sharded step: compiled
    per-device collective bytes must drop from O(A) to O(A/d · hops)."""
    import jax.numpy as jnp

    import __graft_entry__ as graft
    from lsc_dr_planner_tpu.ops import trajectory
    from lsc_dr_planner_tpu.parallel import halo, mesh as meshmod

    planner, fleet, inp = graft._build(n_agents=A)
    p = planner.param
    # spatially sorted line layout (the halo contract)
    i = np.arange(A, dtype=np.float64)
    x = 0.8 * i
    x -= x.mean()
    pos = np.stack([x, 0.05 * np.sin(i), np.full(A, 0.6)], axis=1)
    pos = jnp.asarray(pos, jnp.float32)
    ctrl = trajectory.const_vel_ctrl(
        pos, jnp.zeros((A, 3), jnp.float32), p.M, p.n, p.dt
    )
    inp = inp._replace(pos=pos, prev_ctrl=ctrl, current_goal=pos,
                       next_waypoint=pos)

    mesh = meshmod.make_mesh(nd)
    fleet_s, inp_s = meshmod.shard_step_inputs(mesh, fleet, inp)

    # all-gather baseline
    step_ag = meshmod.make_sharded_step(planner, mesh)
    hlo_ag = step_ag.lower(fleet_s, inp_s).compile().as_text()
    colls_ag, bytes_ag = _hlo_collectives(hlo_ag)

    # halo
    import jax

    from lsc_dr_planner_tpu.planner.pipeline import StepInputs
    from jax.sharding import PartitionSpec as P

    hstep_raw = halo.make_halo_step(planner, mesh, hops=hops)
    hstep_raw(fleet_s, inp_s)  # build+cache the jitted fn
    # re-lower for HLO text
    fn = None
    # reach into the closure cache for the jitted function (keyed by the
    # optional-leaf presence tuple since r5)
    for cell in hstep_raw.__closure__ or []:
        c = cell.cell_contents
        if isinstance(c, dict) and c and all(
            callable(v) for v in c.values()
        ):
            fn = next(iter(c.values()))
    hlo_h = fn.lower(fleet_s, inp_s).compile().as_text()
    colls_h, bytes_h = _hlo_collectives(hlo_h)

    return {
        "A": A, "devices": nd, "hops": hops,
        "allgather_step": {"collectives": colls_ag,
                           "bytes_per_step_per_device": bytes_ag},
        "halo_step": {"collectives": colls_h,
                      "bytes_per_step_per_device": bytes_h},
        "bytes_ratio": (bytes_h / bytes_ag) if bytes_ag else None,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--A", type=int, default=64)
    ap.add_argument("--devices", default="1,2,4,8")
    ap.add_argument("--halo", action="store_true",
                    help="audit the §5.8 halo step against the "
                         "all-gather step at each device count")
    ap.add_argument("--hops", type=int, default=1)
    args = ap.parse_args()
    for nd in [int(d) for d in args.devices.split(",")]:
        if args.halo:
            if nd < 2:
                continue
            r = audit_halo(args.A, nd, hops=args.hops)
        else:
            r = audit(args.A, nd)
        print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()
