// Native host-side runtime for sara-tpu: disjoint sets / feature-track
// connected components.
//
// TPU-native counterpart of the reference's union-find machinery
// (reference: cpp/src/DO/Sara/DisjointSets/DisjointSets.hpp, DisjointSetsV2.hpp,
// SfM/Graph/FeatureDisjointSets.hpp; used by
// SfM/Graph/FeatureTracker.cpp:21-130 to maintain feature tracks).
//
// The device side of the framework is JAX/XLA; this is deliberately host
// code: incremental graph bookkeeping is branchy, pointer-chasing work that
// belongs on the CPU next to the Python orchestrator. Exposed via a C ABI
// for ctypes (no pybind11 in the image).

#include <cmath>
#include <cstdint>
#include <memory>
#include <unordered_map>
#include <utility>
#include <vector>

namespace {

struct DisjointSets {
  std::vector<int64_t> parent;
  std::vector<int32_t> rank;

  explicit DisjointSets(int64_t n) : parent(n), rank(n, 0) {
    for (int64_t i = 0; i < n; ++i) parent[i] = i;
  }

  int64_t find(int64_t x) {
    int64_t root = x;
    while (parent[root] != root) root = parent[root];
    // Path compression.
    while (parent[x] != root) {
      int64_t next = parent[x];
      parent[x] = root;
      x = next;
    }
    return root;
  }

  void unite(int64_t a, int64_t b) {
    int64_t ra = find(a), rb = find(b);
    if (ra == rb) return;
    if (rank[ra] < rank[rb]) std::swap(ra, rb);
    parent[rb] = ra;
    if (rank[ra] == rank[rb]) ++rank[ra];
  }
};

// Incremental feature-track core: union-find + per-component per-frame
// non-max suppression, maintained ONLINE so per-frame tracker cost stays
// flat in sequence length (the reference recomputes components and filters
// per call, FeatureTracker.cpp:21-130; the Python batch path re-sorted the
// full feature history every frame — O(N log N) per frame by design).
//
// Exact semantics preserved vs the batch path: within each (component,
// frame) pair the member with the largest |response| is kept, ties broken
// toward the smallest feature gid. A component's distinct-frame count is
// the size of its winner map (independent of which member wins). Winner
// maps merge small-into-large on union, so total merge work over a run is
// O(N log N) amortized — per frame that is flat.
struct TrackerCore {
  int64_t cap;
  int64_t n = 0;
  DisjointSets uf;
  std::vector<int32_t> frame_of;
  std::vector<float> resp;     // |response|
  std::vector<uint8_t> kept;   // per-feature: wins its (comp, frame) slot
  std::vector<int64_t> min_gid;   // valid at root indices
  std::vector<int32_t> nframes;   // valid at root indices
  // frame -> winning feature gid; null for singleton components (implicit
  // single entry {frame_of[r]: r}).
  std::vector<std::unique_ptr<std::unordered_map<int32_t, int64_t>>> wmap;

  explicit TrackerCore(int64_t capacity)
      : cap(capacity), uf(capacity), frame_of(capacity), resp(capacity),
        kept(capacity), min_gid(capacity), nframes(capacity),
        wmap(capacity) {}

  void add_features(int32_t frame, const float* r, int64_t count) {
    for (int64_t i = 0; i < count; ++i) {
      int64_t g = n + i;
      frame_of[g] = frame;
      resp[g] = std::fabs(r[i]);
      kept[g] = 1;
      min_gid[g] = g;
      nframes[g] = 1;
    }
    n += count;
  }

  // True if challenger c beats incumbent w for the same (comp, frame) slot.
  bool beats(int64_t c, int64_t w) const {
    return resp[c] > resp[w] || (resp[c] == resp[w] && c < w);
  }

  // Insert (frame f, winner g) into map m, resolving the duel.
  void insert(std::unordered_map<int32_t, int64_t>& m, int32_t f, int64_t g) {
    auto it = m.find(f);
    if (it == m.end()) {
      m.emplace(f, g);
    } else if (beats(g, it->second)) {
      kept[it->second] = 0;
      it->second = g;
    } else {
      kept[g] = 0;
    }
  }

  void unite(int64_t a, int64_t b) {
    int64_t ra = uf.find(a), rb = uf.find(b);
    if (ra == rb) return;
    uf.unite(ra, rb);  // links by rank; re-find the surviving root
    int64_t r = uf.find(ra);
    int64_t other = (r == ra) ? rb : ra;
    // Merge winner state of `other` into `r` (small map into large).
    auto& mr = wmap[r];
    auto& mo = wmap[other];
    if (!mr && !mo) {
      mr.reset(new std::unordered_map<int32_t, int64_t>());
      mr->emplace(frame_of[r], r);
      insert(*mr, frame_of[other], other);
    } else if (!mo) {
      insert(*mr, frame_of[other], other);
    } else if (!mr) {
      insert(*mo, frame_of[r], r);
      mr = std::move(mo);
    } else {
      if (mo->size() > mr->size()) mr.swap(mo);
      for (auto& kv : *mo) insert(*mr, kv.first, kv.second);
      mo.reset();
    }
    if (min_gid[other] < min_gid[r]) min_gid[r] = min_gid[other];
    nframes[r] = static_cast<int32_t>(mr->size());
  }

  void fill(int64_t count, int64_t* roots, uint8_t* kept_out,
            int64_t* comp_min, int32_t* comp_nframes) {
    for (int64_t i = 0; i < count; ++i) {
      int64_t r = uf.find(i);
      roots[i] = r;
      kept_out[i] = kept[i];
      comp_min[i] = min_gid[r];
      comp_nframes[i] = nframes[r];
    }
  }

  // One-pass construction of every compute_tracks output (dense component
  // labels in first-occurrence order — identical to compress_labels — plus
  // track ids over good components, representatives, counts). Keeping this
  // native makes the per-call cost a few memory sweeps.
  std::vector<int64_t> dense_of_root;  // reused scratch
  void tracks(int64_t count, int64_t min_length, int64_t* out_track,
              int64_t* out_label, int64_t* comp_min_out, int64_t* reps_out,
              int64_t* k_out, int64_t* t_out) {
    if (static_cast<int64_t>(dense_of_root.size()) < count)
      dense_of_root.assign(cap, -1);
    else
      for (int64_t i = 0; i < count; ++i) dense_of_root[i] = -1;
    int64_t k = 0;
    std::vector<int64_t> min_d, track_d;
    min_d.reserve(1024);
    track_d.reserve(1024);
    int64_t t = 0;
    for (int64_t i = 0; i < count; ++i) {
      int64_t r = uf.find(i);
      int64_t d = dense_of_root[r];
      if (d < 0) {
        d = dense_of_root[r] = k++;
        min_d.push_back(min_gid[r]);
        if (nframes[r] >= min_length) {
          track_d.push_back(t);
          reps_out[t++] = min_gid[r];
        } else {
          track_d.push_back(-1);
        }
      }
      out_label[i] = d;
      out_track[i] = kept[i] ? track_d[d] : -1;
    }
    for (int64_t d = 0; d < k; ++d) comp_min_out[d] = min_d[d];
    *k_out = k;
    *t_out = t;
  }
};

}  // namespace

extern "C" {

// Opaque handle API ---------------------------------------------------------

void* ds_create(int64_t n) { return new DisjointSets(n); }

void ds_destroy(void* h) { delete static_cast<DisjointSets*>(h); }

void ds_union_edges(void* h, const int64_t* a, const int64_t* b, int64_t m) {
  auto* ds = static_cast<DisjointSets*>(h);
  for (int64_t i = 0; i < m; ++i) ds->unite(a[i], b[i]);
}

// Writes the representative of every element into out[n].
void ds_components(void* h, int64_t* out, int64_t n) {
  auto* ds = static_cast<DisjointSets*>(h);
  for (int64_t i = 0; i < n; ++i) out[i] = ds->find(i);
}

// One-shot connected components over an edge list: out[i] = component root.
void connected_components(int64_t n, const int64_t* a, const int64_t* b,
                          int64_t m, int64_t* out) {
  DisjointSets ds(n);
  for (int64_t i = 0; i < m; ++i) ds.unite(a[i], b[i]);
  for (int64_t i = 0; i < n; ++i) out[i] = ds.find(i);
}

// Relabel roots to dense [0, k) component ids; returns k.
int64_t compress_labels(int64_t* labels, int64_t n, int64_t* scratch) {
  // scratch must have size n; maps old root -> dense id via sort-free pass.
  for (int64_t i = 0; i < n; ++i) scratch[i] = -1;
  int64_t k = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t r = labels[i];
    if (scratch[r] < 0) scratch[r] = k++;
    labels[i] = scratch[r];
  }
  return k;
}

// Incremental tracker core -------------------------------------------------

void* tk_create(int64_t cap) { return new TrackerCore(cap); }

void tk_destroy(void* h) { delete static_cast<TrackerCore*>(h); }

void tk_add_features(void* h, int32_t frame, const float* resp,
                     int64_t count) {
  static_cast<TrackerCore*>(h)->add_features(frame, resp, count);
}

void tk_union_edges(void* h, const int64_t* a, const int64_t* b, int64_t m) {
  auto* tk = static_cast<TrackerCore*>(h);
  for (int64_t i = 0; i < m; ++i) tk->unite(a[i], b[i]);
}

// Per-feature root / kept flag / component min-gid / component distinct
// kept-frame count, for the first `count` features.
void tk_fill(void* h, int64_t count, int64_t* roots, uint8_t* kept,
             int64_t* comp_min, int32_t* comp_nframes) {
  static_cast<TrackerCore*>(h)->fill(count, roots, kept, comp_min,
                                     comp_nframes);
}

// One-pass full compute_tracks outputs. out_track/out_label are
// per-feature (size count); comp_min/reps are per-component buffers the
// caller sizes at `count` (upper bound); writes k (components) and t
// (tracks).
void tk_tracks(void* h, int64_t count, int64_t min_length, int64_t* out_track,
               int64_t* out_label, int64_t* comp_min, int64_t* reps,
               int64_t* k_out, int64_t* t_out) {
  static_cast<TrackerCore*>(h)->tracks(count, min_length, out_track,
                                       out_label, comp_min, reps, k_out,
                                       t_out);
}

}  // extern "C"
