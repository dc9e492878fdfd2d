"""Process-level DCN demonstration: a 2-process
`jax.distributed` CPU run sharding the Monte-Carlo SCENARIO axis over a
process-spanning mesh — the closest honest proxy this single-chip
environment permits for the BASELINE north star (≥85% scaling to 4
hosts, scenario axis over DCN).

What it proves:

  1. the scenario-sharded SPMD step COMPILES AND EXECUTES across a
     2-process device mesh (4 virtual CPU devices per process, the
     process boundary standing in for DCN);
  2. the compiled per-device HLO contains NO cross-scenario collectives
     — scenarios are independent, so the DCN axis is embarrassingly
     parallel by construction (scaling = adding hosts), exactly the
     §5.8 pod design argument;
  3. aggregate-throughput conservation vs the same global batch in ONE
     process (the r3 1→2-device methodology): per-process wall time for
     half the scenarios ≈ single-process time for all of them, modulo
     the 2-core host's oversubscription noise.

Usage:  PYTHONPATH= python tools/dcn_demo.py            # parent
        (spawns itself twice with --proc {0,1})
"""

import argparse
import json
import os
import re
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

A = 64
S = 8
STEPS = 5
PORT = 12973


def build_batch(S_local_slice=None):
    """Bench fleet + S perturbed scenario input stacks (deterministic,
    identical in every process)."""
    import jax
    import numpy as np

    import __graft_entry__ as graft

    planner, fleet, inp = graft._build(n_agents=A)
    rng = np.random.default_rng(7)
    inps = []
    for s in range(S):
        d = rng.uniform(-0.05, 0.05, (A, 3)).astype(np.float32)
        d[:, 2] = 0
        inps.append(inp._replace(pos=inp.pos + d))
    import numpy as _np

    stacked = jax.tree_util.tree_map(
        lambda *ls: _np.stack([_np.asarray(x) for x in ls]), *inps
    )
    return planner, fleet, stacked


def child(proc_id: int, nprocs: int):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=4"
    )
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=f"localhost:{PORT}",
        num_processes=nprocs,
        process_id=proc_id,
    )
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    devs = jax.devices()  # global: nprocs × 4
    mesh = Mesh(np.asarray(devs), ("scenarios",))
    shard = NamedSharding(mesh, P("scenarios"))
    repl = NamedSharding(mesh, P())

    planner, fleet, stacked = build_batch()

    def put_sharded(x):
        x = np.asarray(x)
        if x.ndim == 0:
            return jax.make_array_from_callback(
                x.shape, repl, lambda idx: x[idx]
            )
        return jax.make_array_from_callback(
            x.shape, shard, lambda idx: x[idx]
        )

    def put_repl(x):
        x = np.asarray(x)
        return jax.make_array_from_callback(x.shape, repl, lambda idx: x[idx])

    stacked_g = jax.tree_util.tree_map(put_sharded, stacked)
    fleet_g = jax.tree_util.tree_map(put_repl, fleet)

    step = jax.jit(jax.vmap(planner._step_impl, in_axes=(None, 0)))
    lowered = step.lower(fleet_g, stacked_g)
    compiled = lowered.compile()
    hlo = compiled.as_text()
    colls = {}
    bts = 0
    for line in hlo.splitlines():
        m = re.search(
            r"= ((?:\([^)]*\)|\S+)) (all-reduce|all-gather|reduce-scatter|"
            r"collective-permute|all-to-all)(?:-start)?\(", line)
        if m:
            colls[m.group(2)] = colls.get(m.group(2), 0) + 1
            for mm in re.finditer(r"(\w+)\[([\d,]*)\]", m.group(1)):
                n = 1
                for dd in mm.group(2).split(","):
                    if dd:
                        n *= int(dd)
                bts += n * 4

    out = compiled(fleet_g, stacked_g)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(STEPS):
        out = compiled(fleet_g, stacked_g)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / STEPS

    row = {
        "proc": proc_id, "nprocs": nprocs,
        "global_devices": len(devs),
        "local_devices": len(jax.local_devices()),
        "A": A, "S": S,
        "step_s": round(dt, 4),
        "aggregate_agent_scenario_steps_per_s": round(A * S / dt, 1),
        "cross_scenario_collectives": colls,
        "collective_bytes_per_step": bts,
    }
    print("DCNROW " + json.dumps(row), flush=True)


def single_process_baseline():
    """Same global batch on one process (8 local virtual devices)."""
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
    )
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    mesh = Mesh(np.asarray(jax.devices()), ("scenarios",))
    shard = NamedSharding(mesh, P("scenarios"))
    planner, fleet, stacked = build_batch()
    stacked_g = jax.tree_util.tree_map(
        lambda x: jax.device_put(np.asarray(x), shard), stacked
    )
    step = jax.jit(jax.vmap(planner._step_impl, in_axes=(None, 0)))
    out = step(fleet, stacked_g)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(STEPS):
        out = step(fleet, stacked_g)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / STEPS
    return {"step_s": round(dt, 4),
            "aggregate_agent_scenario_steps_per_s": round(A * S / dt, 1)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--proc", type=int, default=None)
    ap.add_argument("--nprocs", type=int, default=2)
    args = ap.parse_args()
    if args.proc is not None:
        child(args.proc, args.nprocs)
        return

    env = dict(os.environ)
    env["PYTHONPATH"] = ""
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--proc", str(i),
             "--nprocs", str(args.nprocs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env,
        )
        for i in range(args.nprocs)
    ]
    rows = []
    for p in procs:
        out, _ = p.communicate(timeout=900)
        for line in out.splitlines():
            if line.startswith("DCNROW "):
                rows.append(json.loads(line[7:]))
        if p.returncode != 0 and not rows:
            print(out[-4000:])
            raise SystemExit(f"child failed rc={p.returncode}")

    base = single_process_baseline()
    summary = {
        "what": "2-process jax.distributed CPU run, scenario axis "
                "sharded across the process boundary (DCN proxy)",
        "children": rows,
        "single_process_same_global_batch": base,
        "throughput_conservation": (
            round(min(r["aggregate_agent_scenario_steps_per_s"]
                      for r in rows)
                  / base["aggregate_agent_scenario_steps_per_s"], 3)
            if rows else None
        ),
    }
    print(json.dumps(summary, indent=1))


if __name__ == "__main__":
    main()
