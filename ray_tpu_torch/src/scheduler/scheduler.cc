// TPU-native cluster scheduler core: node feasibility + hybrid pack/spread
// node selection over fixed-point resource vectors.
//
// Counterpart of the reference's C++ scheduling stack
// (reference: src/ray/raylet/scheduling/cluster_resource_scheduler.h:46,
// policy/hybrid_scheduling_policy.h:50, common/scheduling/
// cluster_resource_data.h:36,290 with fixed_point.h arithmetic and interned
// resource ids, scheduling_ids.h). The head's Python ClusterScheduler mirrors
// membership/acquire/release into this core and delegates the per-task
// pick_node decision; semantics match the Python implementation exactly
// (max-over-resources utilization score, pack-below-threshold-else-spread,
// lexicographic node-id tie-break) so either side can serve as the oracle
// for the other in tests.
//
// Exposed as a C API consumed from Python via ctypes
// (ray_tpu/_private/native_sched.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <map>
#include <string>
#include <vector>

namespace {

struct Node {
  std::string name;  // node id (tie-break key)
  bool alive = true;
  // resource id -> fixed-point amount
  std::map<uint32_t, int64_t> total;
  std::map<uint32_t, int64_t> avail;

  double Utilization() const {
    double best = 0.0;
    for (const auto& [rid, tot] : total) {
      if (tot <= 0) continue;
      auto it = avail.find(rid);
      int64_t av = (it == avail.end()) ? 0 : it->second;
      double used = static_cast<double>(tot - av);
      best = std::max(best, used / static_cast<double>(tot));
    }
    return best;
  }

  static bool Fits(const std::map<uint32_t, int64_t>& have, int n,
                   const uint32_t* ids, const int64_t* amts) {
    for (int i = 0; i < n; i++) {
      auto it = have.find(ids[i]);
      int64_t av = (it == have.end()) ? 0 : it->second;
      if (av < amts[i]) return false;
    }
    return true;
  }
};

struct Sched {
  double spread_threshold;
  std::map<int64_t, Node> nodes;  // key -> node
  uint64_t rr = 0;
};

// Deterministic 4-decimal utilization rounding, bit-identical to the
// Python oracle's _round4 (floor(x*1e4 + 0.5) over doubles).
int64_t Round4(double x) {
  return static_cast<int64_t>(std::floor(x * 10000.0 + 0.5));
}

// 64-bit FNV-1a, identical to scheduler._fnv1a (SPREAD tie-break).
uint64_t Fnv1a(const std::string& s) {
  uint64_t h = 0xCBF29CE484222325ULL;
  for (unsigned char c : s) {
    h ^= c;
    h *= 0x100000001B3ULL;
  }
  return h;
}

}  // namespace

extern "C" {

void* sched_create(double spread_threshold) {
  auto* s = new Sched();
  s->spread_threshold = spread_threshold;
  return s;
}

void sched_destroy(void* h) { delete static_cast<Sched*>(h); }

void sched_add_node(void* h, int64_t key, const char* name, int n,
                    const uint32_t* ids, const int64_t* totals,
                    const int64_t* avails) {
  auto* s = static_cast<Sched*>(h);
  Node node;
  node.name = name;
  for (int i = 0; i < n; i++) {
    node.total[ids[i]] = totals[i];
    node.avail[ids[i]] = avails[i];
  }
  s->nodes[key] = std::move(node);
}

void sched_remove_node(void* h, int64_t key) {
  static_cast<Sched*>(h)->nodes.erase(key);
}

void sched_set_alive(void* h, int64_t key, int alive) {
  auto* s = static_cast<Sched*>(h);
  auto it = s->nodes.find(key);
  if (it != s->nodes.end()) it->second.alive = alive != 0;
}

// 1 on success (resources deducted), 0 if they do not fit.
int sched_acquire(void* h, int64_t key, int n, const uint32_t* ids,
                  const int64_t* amts) {
  auto* s = static_cast<Sched*>(h);
  auto it = s->nodes.find(key);
  if (it == s->nodes.end()) return 0;
  if (!Node::Fits(it->second.avail, n, ids, amts)) return 0;
  for (int i = 0; i < n; i++) it->second.avail[ids[i]] -= amts[i];
  return 1;
}

void sched_release(void* h, int64_t key, int n, const uint32_t* ids,
                   const int64_t* amts) {
  auto* s = static_cast<Sched*>(h);
  auto it = s->nodes.find(key);
  if (it == s->nodes.end()) return;
  for (int i = 0; i < n; i++) it->second.avail[ids[i]] += amts[i];
}

// strategy: 0 = hybrid (default), 1 = SPREAD.
// Returns the chosen node key, or -1 if no node currently fits (the head
// queues the task either way, exactly like the Python policy).
int64_t sched_pick_node(void* h, int n, const uint32_t* ids,
                        const int64_t* amts, int strategy) {
  auto* s = static_cast<Sched*>(h);
  const Node* best = nullptr;
  int64_t best_key = -1;
  int64_t best_score = 0;

  std::vector<std::pair<int64_t, const Node*>> available;
  for (const auto& [key, node] : s->nodes) {
    if (!node.alive) continue;
    if (!Node::Fits(node.total, n, ids, amts)) continue;
    if (Node::Fits(node.avail, n, ids, amts)) available.emplace_back(key, &node);
  }
  if (available.empty()) return -1;

  if (strategy == 1) {  // SPREAD: least utilized, deterministic rr tie-break
    s->rr++;
    size_t m = available.size();
    uint64_t best_tb = 0;
    for (size_t i = 0; i < m; i++) {
      const auto& [key, node] = available[i];
      int64_t u = Round4(node->Utilization());
      uint64_t tb = (Fnv1a(node->name) + s->rr) % m;
      if (best == nullptr || u < best_score ||
          (u == best_score && tb < best_tb)) {
        best = node;
        best_key = key;
        best_score = u;
        best_tb = tb;
      }
    }
    return best_key;
  }

  // Hybrid: among nodes below threshold, PACK onto the most utilized
  // (lexicographically-largest name breaks ties); else SPREAD to least
  // utilized (lexicographically-smallest name breaks ties).
  std::vector<std::pair<int64_t, const Node*>> below;
  for (const auto& p : available)
    if (p.second->Utilization() < s->spread_threshold) below.push_back(p);

  if (!below.empty()) {
    for (const auto& [key, node] : below) {
      int64_t u = Round4(node->Utilization());
      if (best == nullptr || u > best_score ||
          (u == best_score && node->name > best->name)) {
        best = node;
        best_key = key;
        best_score = u;
      }
    }
    return best_key;
  }
  for (const auto& [key, node] : available) {
    int64_t u = Round4(node->Utilization());
    if (best == nullptr || u < best_score ||
        (u == best_score && node->name < best->name)) {
      best = node;
      best_key = key;
      best_score = u;
    }
  }
  return best_key;
}

double sched_utilization(void* h, int64_t key) {
  auto* s = static_cast<Sched*>(h);
  auto it = s->nodes.find(key);
  return it == s->nodes.end() ? -1.0 : it->second.Utilization();
}

int64_t sched_num_nodes(void* h) {
  return static_cast<int64_t>(static_cast<Sched*>(h)->nodes.size());
}

}  // extern "C"
