// Native scheduling core: fixed-point resource accounting + hybrid policy.
//
// TPU-native analog of the reference's raylet scheduling layer
// (reference: src/ray/raylet/scheduling/fixed_point.h FixedPoint;
// cluster_resource_manager + scheduling/policy/hybrid_scheduling_policy.h:48
// — pack onto the best-utilized feasible node below a utilization
// threshold, else spread to the least utilized; top-k randomization to
// avoid herding).  The head server calls this through ctypes for every
// placement decision; resource names are interned to dense indices on the
// Python side.
//
// Fixed point: int64 at 1e4 scale (reference uses the same 1e4 factor).

#include <cstdint>
#include <cstring>
#include <mutex>
#include <random>
#include <unordered_map>
#include <vector>

namespace {

constexpr int64_t kScale = 10000;
constexpr int kMaxResources = 128;

struct Node {
  bool alive = false;
  int64_t total[kMaxResources] = {0};
  int64_t available[kMaxResources] = {0};
};

struct Scheduler {
  std::vector<Node> nodes;
  std::mutex mu;
  std::mt19937 rng{12345};
};

int64_t util_of(const Node& n) {
  // max over resources of used/total, at kScale
  int64_t best = 0;
  for (int i = 0; i < kMaxResources; ++i) {
    if (n.total[i] > 0) {
      int64_t used = n.total[i] - n.available[i];
      int64_t u = used * kScale / n.total[i];
      if (u > best) best = u;
    }
  }
  return best;
}

bool fits(const Node& n, const int64_t* demand, int nd) {
  for (int i = 0; i < nd; ++i) {
    if (demand[i] > 0 && n.available[i] < demand[i]) return false;
  }
  return true;
}

bool total_fits(const Node& n, const int64_t* demand, int nd) {
  for (int i = 0; i < nd; ++i) {
    if (demand[i] > 0 && n.total[i] < demand[i]) return false;
  }
  return true;
}

}  // namespace

extern "C" {

void* sched_create() { return new Scheduler(); }

void sched_destroy(void* h) { delete static_cast<Scheduler*>(h); }

// Ensure capacity for node_idx and set its totals (also resets availability
// to total minus current usage delta — used at (re)registration).
int sched_upsert_node(void* h, int node_idx, const int64_t* totals, int n) {
  if (node_idx < 0 || n > kMaxResources) return -1;
  auto* s = static_cast<Scheduler*>(h);
  std::lock_guard<std::mutex> g(s->mu);
  if ((size_t)node_idx >= s->nodes.size()) s->nodes.resize(node_idx + 1);
  Node& node = s->nodes[node_idx];
  for (int i = 0; i < n; ++i) {
    int64_t used = node.alive ? node.total[i] - node.available[i] : 0;
    node.total[i] = totals[i];
    node.available[i] = totals[i] - used;
  }
  node.alive = true;
  return 0;
}

int sched_remove_node(void* h, int node_idx) {
  auto* s = static_cast<Scheduler*>(h);
  std::lock_guard<std::mutex> g(s->mu);
  if ((size_t)node_idx >= s->nodes.size()) return -1;
  s->nodes[node_idx].alive = false;
  return 0;
}

// Try to reserve demand on a node. 0 = ok, -1 = insufficient.
int sched_acquire(void* h, int node_idx, const int64_t* demand, int n) {
  auto* s = static_cast<Scheduler*>(h);
  std::lock_guard<std::mutex> g(s->mu);
  if ((size_t)node_idx >= s->nodes.size()) return -1;
  Node& node = s->nodes[node_idx];
  if (!node.alive || !fits(node, demand, n)) return -1;
  for (int i = 0; i < n; ++i) node.available[i] -= demand[i];
  return 0;
}

// Force-reserve (oversubscription allowed — blocked-task re-acquire path).
void sched_acquire_force(void* h, int node_idx, const int64_t* demand, int n) {
  auto* s = static_cast<Scheduler*>(h);
  std::lock_guard<std::mutex> g(s->mu);
  if ((size_t)node_idx >= s->nodes.size()) return;
  Node& node = s->nodes[node_idx];
  for (int i = 0; i < n; ++i) node.available[i] -= demand[i];
}

void sched_release(void* h, int node_idx, const int64_t* demand, int n) {
  auto* s = static_cast<Scheduler*>(h);
  std::lock_guard<std::mutex> g(s->mu);
  if ((size_t)node_idx >= s->nodes.size()) return;
  Node& node = s->nodes[node_idx];
  for (int i = 0; i < n; ++i) {
    node.available[i] += demand[i];
    if (node.available[i] > node.total[i]) node.available[i] = node.total[i];
  }
}

int64_t sched_utilization(void* h, int node_idx) {
  auto* s = static_cast<Scheduler*>(h);
  std::lock_guard<std::mutex> g(s->mu);
  if ((size_t)node_idx >= s->nodes.size()) return 0;
  return util_of(s->nodes[node_idx]);
}

void sched_available(void* h, int node_idx, int64_t* out, int n) {
  auto* s = static_cast<Scheduler*>(h);
  std::lock_guard<std::mutex> g(s->mu);
  if ((size_t)node_idx >= s->nodes.size()) return;
  std::memcpy(out, s->nodes[node_idx].available, n * sizeof(int64_t));
}

// Hybrid policy: among feasible nodes with utilization < threshold pick the
// MOST utilized (pack); if none below threshold, pick the LEAST utilized
// (spread).  Returns node idx and reserves, or -1 if none feasible.
// prefer_idx (e.g. the head/local node) wins ties, as in the reference's
// local-node preference.
int sched_pick_and_acquire(void* h, const int64_t* demand, int n,
                           int64_t spread_threshold_fp, int prefer_idx) {
  auto* s = static_cast<Scheduler*>(h);
  std::lock_guard<std::mutex> g(s->mu);
  int best_pack = -1, best_spread = -1;
  int64_t best_pack_util = -1, best_spread_util = INT64_MAX;
  for (size_t i = 0; i < s->nodes.size(); ++i) {
    Node& node = s->nodes[i];
    if (!node.alive || !fits(node, demand, n)) continue;
    int64_t u = util_of(node);
    if (u < spread_threshold_fp) {
      if (u > best_pack_util ||
          (u == best_pack_util && (int)i == prefer_idx)) {
        best_pack_util = u;
        best_pack = (int)i;
      }
    }
    if (u < best_spread_util || (u == best_spread_util && (int)i == prefer_idx)) {
      best_spread_util = u;
      best_spread = (int)i;
    }
  }
  int pick = best_pack >= 0 ? best_pack : best_spread;
  if (pick < 0) return -1;
  Node& node = s->nodes[pick];
  for (int i = 0; i < n; ++i) node.available[i] -= demand[i];
  return pick;
}

// Any alive node whose TOTAL capacity could ever fit the demand?
int sched_feasible(void* h, const int64_t* demand, int n) {
  auto* s = static_cast<Scheduler*>(h);
  std::lock_guard<std::mutex> g(s->mu);
  for (auto& node : s->nodes) {
    if (node.alive && total_fits(node, demand, n)) return 1;
  }
  return 0;
}

}  // extern "C"
