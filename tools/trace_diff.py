"""Cross-run trajectory divergence localizer.

Compares two simulation CSVs of the SAME mission (e.g. a CPU-backend
and a GPU-backend run, or two commits) and reports WHERE the runs first
diverge — the diagnostic for chaotic flight-time drift: everything
before the first divergence is bitwise-equal dynamics, so the step it
reports is where backend arithmetic first flipped a decision (goal-LP
gate, contact ordering, ADMM tie).

Usage:
    python tools/trace_diff.py a.csv b.csv [--tol 1e-3] [--frames]

With --frames, renders the neighborhood of the divergence for run A if
the mission/world files are given (--mission/--world).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("csv_a")
    ap.add_argument("csv_b")
    ap.add_argument("--tol", type=float, default=1e-3,
                    help="position divergence threshold [m]")
    args = ap.parse_args()

    from lsc_dr_planner_tpu.sim.replay import read_csv

    la, lb = read_csv(args.csv_a), read_csv(args.csv_b)
    assert la.qn == lb.qn, (la.qn, lb.qn)
    T = min(len(la.times), len(lb.times))
    pa = la.agent_states[:T, :, :3]
    pb = lb.agent_states[:T, :, :3]
    d = np.max(np.abs(pa - pb), axis=(1, 2))  # [T]
    per_agent = np.max(np.abs(pa - pb), axis=2)  # [T, A]

    idx = np.nonzero(d > args.tol)[0]
    if len(idx) == 0:
        print(f"identical to {args.tol} m over {T} rows "
              f"(max diff {d.max():.2e} m)")
        return
    t0 = idx[0]
    agents = np.nonzero(per_agent[t0] > args.tol)[0]
    print(f"first divergence at row {t0} (t={la.times[t0]:.2f}s): "
          f"agents {agents.tolist()}, max {d[t0]:.4f} m")
    # growth profile after divergence
    marks = [t0, min(t0 + 10, T - 1), min(t0 + 50, T - 1), T - 1]
    for t in dict.fromkeys(marks):
        print(f"  t={la.times[t]:7.2f}s  max diff {d[t]:8.4f} m  "
              f"agents>{args.tol}: {int((per_agent[t] > args.tol).sum())}")
    if len(la.times) != len(lb.times):
        print(f"run lengths differ: {len(la.times)} vs {len(lb.times)} rows "
              f"({la.times[-1]:.1f}s vs {lb.times[-1]:.1f}s)")


if __name__ == "__main__":
    main()
