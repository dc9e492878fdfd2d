// Native MAPF backend: ECBS (w-suboptimal focal search) on a
// 4-connected grid.
//
// C++ re-implementation of lsc_dr_planner_tpu/mapf/ecbs.py (which
// mirrors the vendored mapf-IR ECBS — reference: src/mapf/ecbs.cpp,
// two-queue OPEN/FOCAL at both search levels, rebuild-on-bound-change,
// LibCBS first-conflict constraints, w = 2.0). The simulator's
// committed-plan layer solves one ECBS instance per waypoint-config
// change; on dense mazes a solve costs ~100 ms in Python, so the
// native backend keeps the MAPF layer far inside the 0.2 s/step
// replanning budget.
//
// Determinism contract: every priority key carries a monotone
// insertion counter, so the total ordering — and therefore the
// solution — is identical to the Python implementation run with the
// same inputs (asserted in tests/test_mapf.py).

#include <algorithm>
#include <chrono>
#include <cstdint>
#include <cstring>
#include <deque>
#include <limits>
#include <memory>
#include <queue>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

constexpr int kInf = 1 << 29;
const int kDx[4] = {-1, 1, 0, 0};
const int kDy[4] = {0, 0, -1, 1};

using Clock = std::chrono::steady_clock;

struct Grid {
  int X, Y;
  const uint8_t* occ;
  bool blocked(int x, int y) const { return occ[x * Y + y] != 0; }
  int id(int x, int y) const { return x * Y + y; }
};

std::vector<int> bfs_distances(const Grid& g, int gx, int gy) {
  std::vector<int> d(g.X * g.Y, kInf);
  if (g.blocked(gx, gy)) return d;
  std::deque<std::pair<int, int>> q;
  d[g.id(gx, gy)] = 0;
  q.emplace_back(gx, gy);
  while (!q.empty()) {
    auto [x, y] = q.front();
    q.pop_front();
    int dd = d[g.id(x, y)];
    for (int k = 0; k < 4; ++k) {
      int nx = x + kDx[k], ny = y + kDy[k];
      if (nx < 0 || nx >= g.X || ny < 0 || ny >= g.Y) continue;
      if (g.blocked(nx, ny)) continue;
      if (d[g.id(nx, ny)] > dd + 1) {
        d[g.id(nx, ny)] = dd + 1;
        q.emplace_back(nx, ny);
      }
    }
  }
  return d;
}

using Path = std::vector<int>;  // cell ids over time

int pad_get(const Path& p, int t) {
  return t < static_cast<int>(p.size()) ? p[t] : p.back();
}

int makespan(const std::vector<Path>& paths) {
  int ms = 0;
  for (const auto& p : paths) ms = std::max(ms, (int)p.size() - 1);
  return ms;
}

int path_cost(const Path& p) {
  int g = p.back();
  int c = static_cast<int>(p.size()) - 1;
  while (c > 0 && p[c - 1] == g) --c;
  return c;
}

int soc_of(const std::vector<Path>& paths) {
  int s = 0;
  for (const auto& p : paths) s += path_cost(p);
  return s;
}

int count_conflicts(const std::vector<Path>& paths, int only_agent,
                    const Path* agent_path) {
  int n = static_cast<int>(paths.size());
  int ms = makespan(paths);
  if (agent_path)
    ms = std::max(ms, static_cast<int>(agent_path->size()) - 1);
  int cnt = 0;
  if (only_agent >= 0) {
    const Path& pi = *agent_path;
    for (int j = 0; j < n; ++j) {
      if (j == only_agent) continue;
      for (int t = 1; t <= ms; ++t) {
        if (pad_get(pi, t) == pad_get(paths[j], t))
          ++cnt;
        else if (pad_get(pi, t) == pad_get(paths[j], t - 1) &&
                 pad_get(pi, t - 1) == pad_get(paths[j], t))
          ++cnt;
      }
    }
    return cnt;
  }
  for (int t = 1; t <= ms; ++t)
    for (int i = 0; i < n; ++i)
      for (int j = i + 1; j < n; ++j) {
        int vi = pad_get(paths[i], t), vj = pad_get(paths[j], t);
        if (vi == vj)
          ++cnt;
        else if (vi == pad_get(paths[j], t - 1) &&
                 vj == pad_get(paths[i], t - 1))
          ++cnt;
      }
  return cnt;
}

struct Constraint {
  int id, t, v, u;  // u = -1 for vertex constraints
};

// first vertex/swap conflict -> pair of constraints (lib_cbs.cpp:18-49)
bool first_constraints(const std::vector<Path>& paths, Constraint out[2]) {
  int n = static_cast<int>(paths.size());
  int ms = makespan(paths);
  for (int t = 1; t <= ms; ++t)
    for (int i = 0; i < n; ++i)
      for (int j = i + 1; j < n; ++j) {
        int vi = pad_get(paths[i], t), vj = pad_get(paths[j], t);
        if (vi == vj) {
          out[0] = {i, t, vi, -1};
          out[1] = {j, t, vj, -1};
          return true;
        }
        if (vi == pad_get(paths[j], t - 1) && vj == pad_get(paths[i], t - 1)) {
          out[0] = {i, t, vi, pad_get(paths[i], t - 1)};
          out[1] = {j, t, vj, pad_get(paths[j], t - 1)};
          return true;
        }
      }
  return false;
}

struct HLNode {
  std::vector<Path> paths;
  std::vector<Constraint> constraints;
  int soc = 0, f = 0;
  long long LB = 0;
  std::vector<int> f_mins;
  bool valid = true;
};

struct Solver {
  Grid g;
  int n;
  double w;
  int max_hl_nodes;
  Clock::time_point deadline;
  std::vector<int> currents, goals;
  std::vector<std::vector<int>> dists;  // per agent, to goal

  bool out_of_time() const { return Clock::now() > deadline; }

  std::vector<int> neighbors(int v) const {
    std::vector<int> out;
    int x = v / g.Y, y = v % g.Y;
    for (int k = 0; k < 4; ++k) {
      int nx = x + kDx[k], ny = y + kDy[k];
      if (nx < 0 || nx >= g.X || ny < 0 || ny >= g.Y) continue;
      if (g.blocked(nx, ny)) continue;
      out.push_back(g.id(nx, ny));
    }
    return out;
  }

  // ---- initial prioritized path (ecbs.cpp:152-180) -------------------
  bool initial_path(int i, const std::vector<Path>& paths, Path& out) {
    int s = currents[i], goal = goals[i];
    int ms = 0;
    for (int j = 0; j < n; ++j)
      if (!paths[j].empty())
        ms = std::max(ms, static_cast<int>(paths[j].size()) - 1);
    std::unordered_set<int> goal_cells(goals.begin(), goals.end());
    out.clear();
    out.push_back(s);
    int p = s, t = 1;
    int cap = 4 * (g.X + g.Y) + 50;
    while (p != goal) {
      if (static_cast<int>(out.size()) > cap) return false;
      auto cands = neighbors(p);
      int best = -1;
      long long best_key = std::numeric_limits<long long>::max();
      for (int a : cands) {
        int occu = 0;
        if (t <= ms) {
          for (int j = 0; j < n; ++j) {
            if (!paths[j].empty() && pad_get(paths[j], t) == a) {
              occu = 1;
              break;
            }
          }
        }
        int other_goal = (a != goal && goal_cells.count(a)) ? 1 : 0;
        long long key = (long long)dists[i][a] * 4 + occu * 2 + other_goal;
        if (key < best_key) {
          best_key = key;
          best = a;
        }
      }
      p = best;
      out.push_back(p);
      ++t;
    }
    return true;
  }

  // ---- low-level focal space-time A* (ecbs.cpp:208-394) --------------
  // returns f1_min; path empty on failure
  int focal_path(const HLNode& node, int aid, Path& out) {
    out.clear();
    int s = currents[aid], goal = goals[aid];
    std::vector<Constraint> cons;
    int max_con_t = 0;
    for (const auto& c : node.constraints)
      if (c.id == aid) {
        cons.push_back(c);
        if (c.v == goal && c.u < 0) max_con_t = std::max(max_con_t, c.t);
      }
    const auto& base_dist = dists[aid];
    int ms = makespan(node.paths);
    // occupancy: (t, cell) -> count for t <= ms over OTHER agents
    std::unordered_set<long long> occ_t;
    std::vector<const Path*> others;
    for (int j = 0; j < n; ++j)
      if (j != aid) others.push_back(&node.paths[j]);
    for (const Path* p : others)
      for (int t = 0; t <= ms; ++t)
        occ_t.insert((long long)t * g.X * g.Y + pad_get(*p, t));
    auto occ_at = [&](int t, int v) {
      return occ_t.count((long long)t * g.X * g.Y + v) != 0;
    };

    bool clamp_f1 = base_dist[s] <= max_con_t;
    auto f1_of = [&](int v, int gc) -> int {
      int h = base_dist[v];
      if (h >= kInf) return -1;
      int f = gc + h;
      if (clamp_f1) f = std::max(max_con_t + 1, f);
      return f;
    };
    auto f2_step = [&](int v, int pv, int gc) -> int {
      if (gc == 0) return 0;
      if (gc > ms) return occ_at(ms, v) ? 1 : 0;
      if (occ_at(gc, v)) return 1;
      if (occ_at(gc, pv) && occ_at(gc - 1, v)) {
        for (const Path* p : others)
          if (pad_get(*p, gc) == pv && pad_get(*p, gc - 1) == v) return 1;
      }
      return 0;
    };
    auto violates = [&](int v, int pv, int gc) {
      for (const auto& c : cons)
        if (gc == c.t && v == c.v && (c.u < 0 || c.u == pv)) return true;
      return false;
    };

    int start_f1 = f1_of(s, 0);
    if (start_f1 < 0) return 0;

    struct LLNode {
      int v, gcost, f1, f2, moves, parent;
    };
    std::vector<LLNode> nodes;
    nodes.push_back({s, 0, start_f1, 0, 0, -1});
    long long tie = 0;

    using OpenEnt = std::tuple<int, long long, int>;  // f1, tie, idx
    // f2, f1, moves, -g, tie, idx — `moves` is this build's tie-break
    // (prefer fewer non-wait transitions; SOC-free shuffles otherwise
    // survive and get walked physically by the committed-plan executor)
    using FocalEnt = std::tuple<int, int, int, int, long long, int>;
    std::priority_queue<OpenEnt, std::vector<OpenEnt>, std::greater<OpenEnt>>
        OPEN;
    std::vector<OpenEnt> open_entries;  // mirror for FOCAL rebuilds
    std::priority_queue<FocalEnt, std::vector<FocalEnt>,
                        std::greater<FocalEnt>>
        FOCAL;
    std::unordered_set<long long> CLOSE;
    auto key_of = [&](int v, int gc) {
      return (long long)gc * g.X * g.Y + v;
    };
    OPEN.push({start_f1, tie, 0});
    open_entries.push_back({start_f1, tie, 0});
    ++tie;
    FOCAL.push({0, start_f1, 0, 0, tie, 0});
    ++tie;
    int f1_min = start_f1;
    int goal_idx = -1;
    long long expansions = 0;
    const long long limit = 200000;

    while (!OPEN.empty() && expansions < limit) {
      if ((expansions & 255) == 0 && out_of_time()) return 0;
      while (!OPEN.empty()) {
        auto [f1v, tv, idx] = OPEN.top();
        if (CLOSE.count(key_of(nodes[idx].v, nodes[idx].gcost)))
          OPEN.pop();
        else
          break;
      }
      if (OPEN.empty()) break;
      if (f1_min != std::get<0>(OPEN.top()) || FOCAL.empty()) {
        f1_min = std::get<0>(OPEN.top());
        double bound = f1_min * w;
        FOCAL = {};
        // rebuild from all live OPEN entries within the bound
        std::vector<OpenEnt> live;
        for (const auto& e : open_entries) {
          int idx = std::get<2>(e);
          if (CLOSE.count(key_of(nodes[idx].v, nodes[idx].gcost))) continue;
          live.push_back(e);
          if (std::get<0>(e) <= bound)
            FOCAL.push({nodes[idx].f2, std::get<0>(e), nodes[idx].moves,
                        -nodes[idx].gcost, std::get<1>(e), idx});
        }
        open_entries.swap(live);
        if (FOCAL.empty()) break;
      }
      auto [f2v, f1v, mv, neg_g, tv, idx] = FOCAL.top();
      FOCAL.pop();
      int v = nodes[idx].v, gcost = nodes[idx].gcost;
      if (CLOSE.count(key_of(v, gcost))) continue;
      CLOSE.insert(key_of(v, gcost));
      ++expansions;

      if (v == goal && gcost > max_con_t) {
        goal_idx = idx;
        break;
      }
      auto nb = neighbors(v);
      nb.push_back(v);
      for (int u : nb) {
        int ng = gcost + 1;
        if (CLOSE.count(key_of(u, ng))) continue;
        if (violates(u, v, ng)) continue;
        int nf1 = f1_of(u, ng);
        if (nf1 < 0) continue;
        int nf2 = f2v + f2_step(u, v, ng);
        int nmv = nodes[idx].moves + (u != v ? 1 : 0);
        nodes.push_back({u, ng, nf1, nf2, nmv, idx});
        int nidx = static_cast<int>(nodes.size()) - 1;
        OPEN.push({nf1, tie, nidx});
        open_entries.push_back({nf1, tie, nidx});
        ++tie;
        if (nf1 <= f1_min * w) {
          FOCAL.push({nf2, nf1, nmv, -ng, tie, nidx});
          ++tie;
        }
      }
    }
    if (goal_idx < 0) return 0;
    int cur = goal_idx;
    while (cur >= 0) {
      out.push_back(nodes[cur].v);
      cur = nodes[cur].parent;
    }
    std::reverse(out.begin(), out.end());
    return f1_min;
  }

  // ---- high-level search (ecbs.cpp:12-110) ---------------------------
  // returns 0 on success, fills paths_out + final LB
  int run(std::vector<Path>& paths_out, long long& lb_out) {
    for (int i = 0; i < n; ++i)
      if (dists[i][currents[i]] >= kInf) return -1;

    auto root = std::make_shared<HLNode>();
    root->paths.assign(n, {});
    root->f_mins.resize(n);
    for (int i = 0; i < n; ++i) {
      Path p;
      if (!initial_path(i, root->paths, p)) return -1;
      root->paths[i] = p;
      root->f_mins[i] = static_cast<int>(p.size()) - 1;
    }
    root->soc = soc_of(root->paths);
    root->f = count_conflicts(root->paths, -1, nullptr);
    root->LB = root->soc;

    long long tie = 0;
    using HLEnt = std::tuple<long long, long long, std::shared_ptr<HLNode>>;
    struct HlGt {
      bool operator()(const HLEnt& a, const HLEnt& b) const {
        if (std::get<0>(a) != std::get<0>(b))
          return std::get<0>(a) > std::get<0>(b);
        return std::get<1>(a) > std::get<1>(b);
      }
    };
    using FEnt =
        std::tuple<int, int, long long, std::shared_ptr<HLNode>>;  // f,soc,tie
    struct FGt {
      bool operator()(const FEnt& a, const FEnt& b) const {
        if (std::get<0>(a) != std::get<0>(b))
          return std::get<0>(a) > std::get<0>(b);
        if (std::get<1>(a) != std::get<1>(b))
          return std::get<1>(a) > std::get<1>(b);
        return std::get<2>(a) > std::get<2>(b);
      }
    };
    std::priority_queue<HLEnt, std::vector<HLEnt>, HlGt> OPEN;
    std::vector<HLEnt> open_entries;
    std::priority_queue<FEnt, std::vector<FEnt>, FGt> FOCAL;

    OPEN.push({root->LB, tie, root});
    open_entries.push_back({root->LB, tie, root});
    ++tie;
    FOCAL.push({root->f, root->soc, tie, root});
    ++tie;
    long long LB_min = root->LB;
    std::shared_ptr<HLNode> solved;
    int explored = 0;

    while (!OPEN.empty() && explored < max_hl_nodes) {
      if (out_of_time()) break;
      while (!OPEN.empty() && !std::get<2>(OPEN.top())->valid) OPEN.pop();
      if (OPEN.empty()) break;
      if (LB_min != std::get<0>(OPEN.top()) || FOCAL.empty()) {
        LB_min = std::get<0>(OPEN.top());
        double bound = LB_min * w;
        FOCAL = {};
        std::vector<HLEnt> live;
        for (const auto& e : open_entries) {
          const auto& nd = std::get<2>(e);
          if (!nd->valid) continue;
          live.push_back(e);
          if (static_cast<double>(std::get<0>(e)) <= bound)
            FOCAL.push({nd->f, nd->soc, std::get<1>(e), nd});
        }
        open_entries.swap(live);
        if (FOCAL.empty()) break;
      }
      auto nd = std::get<3>(FOCAL.top());
      FOCAL.pop();
      if (!nd->valid) continue;
      nd->valid = false;
      ++explored;

      Constraint cons[2];
      if (!first_constraints(nd->paths, cons)) {
        solved = nd;
        break;
      }
      for (int ci = 0; ci < 2; ++ci) {
        int aid = cons[ci].id;
        auto m = std::make_shared<HLNode>(*nd);
        m->valid = true;
        m->constraints.push_back(cons[ci]);
        Path new_path;
        int f_min = focal_path(*m, aid, new_path);
        if (new_path.empty()) continue;
        const Path old = m->paths[aid];
        m->f = m->f - count_conflicts(m->paths, aid, &old) +
               count_conflicts(m->paths, aid, &new_path);
        m->paths[aid] = new_path;
        m->soc = soc_of(m->paths);
        m->LB = m->LB - m->f_mins[aid] + f_min;
        m->f_mins[aid] = f_min;
        OPEN.push({m->LB, tie, m});
        open_entries.push_back({m->LB, tie, m});
        ++tie;
        if (static_cast<double>(m->LB) <= LB_min * w) {
          FOCAL.push({m->f, m->soc, tie, m});
          ++tie;
        }
      }
    }

    lb_out = LB_min;
    if (!solved) return -1;
    int ms = makespan(solved->paths);
    paths_out.resize(n);
    for (int i = 0; i < n; ++i) {
      paths_out[i].resize(ms + 1);
      for (int t = 0; t <= ms; ++t)
        paths_out[i][t] = pad_get(solved->paths[i], t);
    }
    // strip repeated all-agent prefix
    int repeated = 0;
    for (int t = 1; t <= ms; ++t) {
      bool rep = true;
      for (int i = 0; i < n; ++i)
        if (paths_out[i][0] != paths_out[i][t]) {
          rep = false;
          break;
        }
      if (rep) repeated = t;
    }
    for (int i = 0; i < n; ++i)
      paths_out[i].erase(paths_out[i].begin(),
                         paths_out[i].begin() + repeated);
    return 0;
  }
};

}  // namespace

extern "C" {

// returns path length T (>0) on success, -1 on failure.
// out_paths: [n, max_len, 2] int32; out_lb: final high-level lower bound
int ecbs_solve(const uint8_t* occ, int X, int Y, const int* currents,
               const int* goals, int n, double w, int max_hl_nodes,
               double time_limit_s, int* out_paths, int max_len,
               long long* out_lb) {
  Solver s;
  s.g = {X, Y, occ};
  s.n = n;
  s.w = w;
  s.max_hl_nodes = max_hl_nodes;
  s.deadline = Clock::now() + std::chrono::microseconds(
                                  (long long)(time_limit_s * 1e6));
  s.currents.resize(n);
  s.goals.resize(n);
  for (int i = 0; i < n; ++i) {
    s.currents[i] = currents[2 * i] * Y + currents[2 * i + 1];
    s.goals[i] = goals[2 * i] * Y + goals[2 * i + 1];
  }
  s.dists.resize(n);
  for (int i = 0; i < n; ++i)
    s.dists[i] = bfs_distances(s.g, goals[2 * i], goals[2 * i + 1]);

  std::vector<Path> paths;
  long long lb = 0;
  int rc = s.run(paths, lb);
  if (out_lb) *out_lb = lb;
  if (rc != 0) return -1;
  int T = static_cast<int>(paths[0].size());
  if (T > max_len) return -1;
  for (int i = 0; i < n; ++i)
    for (int t = 0; t < T; ++t) {
      out_paths[(i * max_len + t) * 2] = paths[i][t] / Y;
      out_paths[(i * max_len + t) * 2 + 1] = paths[i][t] % Y;
    }
  return T;
}
}
