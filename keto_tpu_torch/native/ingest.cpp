// Native tuple→graph ingest: string interning and edge construction.
//
// The hot host-side path when (re)building a device snapshot is interning
// millions of tuple rows into int32 node ids (keto_tpu/graph/interner.py
// documents the node/edge model and wildcard-expansion semantics; this file
// implements the same contract behind a C ABI). The Python fallback walks
// rows in a Python loop; this implementation consumes either
//
//  - **columnar arrays** (graph_build_columnar): five string columns as
//    (blob, starts, lens) triples plus int/kind arrays, produced by
//    keto_tpu/graph/native.py in a handful of vectorized numpy passes —
//    the fast path: zero per-row Python work; or
//  - a **packed byte buffer** (graph_build), one 0x1F/0x1E-separated record
//    per row:
//      ns_id '\x1f' object '\x1f' relation '\x1f' kind '\x1f' f0 '\x1f' f1 '\x1f' f2 '\x1e'
//    where kind is "0" (subject set: f0=ns_id, f1=object, f2=relation) or
//    "1" (subject id: f0=id, f1=f2 empty); ns_id is decimal ASCII. Kept for
//    odd encodings the columnar packer rejects and for resolve_queries.
//
// **Parallel ingest.** The columnar entry points chunk the row stream
// across worker threads (ctypes releases the GIL for the whole call, so
// the workers own the machine). Each worker interns its chunk into
// thread-local tables; a serial merge then folds the local tables into
// the global ones IN CHUNK ORDER. Within a chunk, local ids are assigned
// in first-occurrence order, so replaying each chunk's locals in
// local-id order reproduces the exact id assignment a serial pass over
// the concatenated stream would make — the parallel build is
// bit-identical to the serial one (tests/test_native_ingest.py asserts
// equality against the Python interner either way). Thread count:
// KETO_TPU_INGEST_THREADS, else min(hardware_concurrency, 16); inputs
// under ~256k rows stay serial (spawn cost dominates).
//
// Interning internals: open-addressed flat hash tables (cached hashes,
// linear probing, deque string arenas with stable addresses for the
// reverse lookups); a set node key is the integer triple
// (ns, obj_code, rel_code) probed directly against the key arrays.
// Node-id assignment order is identical to interner.py (ids in first-
// occurrence order, field codes interned at node creation then per tuple).
//
// Exported functions use plain C types; ownership of the Graph handle stays
// with the caller (graph_free).

#include <algorithm>
#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <string_view>
#include <thread>
#include <vector>

namespace {

// FNV-1a: fast enough, no allocation, identical across builds (the table
// layout never leaks into results — ids assign in first-occurrence order)
inline uint64_t hash_bytes(const char* p, size_t n) {
    uint64_t h = 1469598103934665603ULL;
    for (size_t i = 0; i < n; ++i) {
        h ^= (uint8_t)p[i];
        h *= 1099511628211ULL;
    }
    return h;
}
inline uint64_t hash_sv(std::string_view s) { return hash_bytes(s.data(), s.size()); }
inline uint64_t hash_mix(uint64_t a, uint64_t b) {
    uint64_t h = a * 0x9e3779b97f4a7c15ULL;
    h ^= b + 0x9e3779b97f4a7c15ULL + (h << 6) + (h >> 2);
    return h * 0xff51afd7ed558ccdULL;
}

// Open-addressed string intern table: codes are dense first-occurrence
// ids, strings live in a deque arena (stable addresses for the reverse
// tables), slots hold code+1 (0 = empty) with cached hashes. ~2-3x
// faster than node-based unordered_map at tens of millions of lookups —
// one cache line per probe, no per-node allocation.
struct StrTable {
    std::deque<std::string> arena;     // code → string
    std::vector<uint64_t> hashes;      // code → hash
    std::vector<int64_t> slots;        // slot → code+1 (0 empty)
    std::vector<uint64_t> slot_hash;   // slot → hash of its string
    size_t mask = 0;

    size_t size() const { return arena.size(); }

    void reserve(size_t n) {
        size_t cap = 16;
        while (cap < n * 2) cap <<= 1;
        if (cap > slots.size()) rehash(cap);
    }

    void rehash(size_t cap) {
        slots.assign(cap, 0);
        slot_hash.assign(cap, 0);
        mask = cap - 1;
        for (size_t code = 0; code < arena.size(); ++code) {
            size_t i = (size_t)hashes[code] & mask;
            while (slots[i]) i = (i + 1) & mask;
            slots[i] = (int64_t)code + 1;
            slot_hash[i] = hashes[code];
        }
    }

    int64_t find(std::string_view s) const {
        if (slots.empty()) return -1;
        uint64_t h = hash_sv(s);
        size_t i = (size_t)h & mask;
        while (slots[i]) {
            if (slot_hash[i] == h && arena[(size_t)slots[i] - 1] == s)
                return slots[i] - 1;
            i = (i + 1) & mask;
        }
        return -1;
    }

    int64_t intern(std::string_view s) {
        if (slots.empty()) rehash(16);
        uint64_t h = hash_sv(s);
        size_t i = (size_t)h & mask;
        while (slots[i]) {
            if (slot_hash[i] == h && arena[(size_t)slots[i] - 1] == s)
                return slots[i] - 1;
            i = (i + 1) & mask;
        }
        int64_t code = (int64_t)arena.size();
        arena.emplace_back(s);
        hashes.push_back(h);
        slots[i] = code + 1;
        slot_hash[i] = h;
        if (arena.size() * 10 >= slots.size() * 7) rehash(slots.size() * 2);
        return code;
    }
};

// Open-addressed (ns, obj_code, rel_code) → set id table. Key fields live
// in the id-indexed arrays (no duplicated key storage); sizing goes
// through rebuild(), which always reinserts the keys living in the
// arrays — a bare slot reset would orphan them. Used for the global
// graph AND each worker's thread-local shard.
struct SetTable {
    std::vector<int64_t> key_ns, key_obj, key_rel;  // per set node
    std::vector<uint8_t> wild;
    std::vector<int64_t> slots;  // slot → id+1 (0 empty)
    size_t mask = 0;

    size_t size() const { return key_ns.size(); }

    static inline uint64_t triple_hash(int64_t ns, int64_t oc, int64_t rc) {
        return hash_mix(hash_mix((uint64_t)ns, (uint64_t)oc), (uint64_t)rc);
    }

    void rebuild(size_t cap) {
        slots.assign(cap, 0);
        mask = cap - 1;
        for (size_t id = 0; id < key_ns.size(); ++id) {
            size_t j = (size_t)triple_hash(key_ns[id], key_obj[id], key_rel[id]) & mask;
            while (slots[j]) j = (j + 1) & mask;
            slots[j] = (int64_t)id + 1;
        }
    }

    void reserve(size_t n) {
        size_t cap = 16;
        while (cap < n * 2) cap <<= 1;
        if (cap > slots.size()) rebuild(cap);
    }

    // find-or-insert; returns id, or with insert=false returns -1 on miss
    int64_t lookup(int64_t ns, int64_t oc, int64_t rc, bool insert, bool wild_flag) {
        if (slots.empty()) {
            if (!insert) return -1;
            rebuild(16);
        }
        size_t i = (size_t)triple_hash(ns, oc, rc) & mask;
        while (slots[i]) {
            size_t id = (size_t)slots[i] - 1;
            if (key_ns[id] == ns && key_obj[id] == oc && key_rel[id] == rc)
                return (int64_t)id;
            i = (i + 1) & mask;
        }
        if (!insert) return -1;
        int64_t id = (int64_t)key_ns.size();
        key_ns.push_back(ns);
        key_obj.push_back(oc);
        key_rel.push_back(rc);
        wild.push_back(wild_flag);
        slots[i] = id + 1;
        if (key_ns.size() * 10 >= slots.size() * 7) rebuild(slots.size() * 2);
        return id;
    }
};

struct Graph {
    SetTable sets;
    StrTable leaf_ids;
    StrTable obj_codes;
    StrTable rel_codes;
    // tuples (lhs set id, per-field codes, subject raw kind/idx)
    std::vector<int64_t> t_lhs, t_ns, t_obj, t_rel, t_sub_idx;
    std::vector<uint8_t> t_sub_kind;
    // final edges (raw ids; dst offset by num_sets for leaves)
    std::vector<int64_t> src, dst;
    std::vector<int64_t> wild_ns_ids;

    size_t num_set_nodes() const { return sets.size(); }
};

int64_t set_node_coded(Graph& g, int64_t ns, int64_t oc, int64_t rc, bool any_empty,
                       bool ns_wild) {
    return g.sets.lookup(ns, oc, rc, /*insert=*/true, ns_wild || any_empty);
}

int64_t set_node(Graph& g, int64_t ns, std::string_view obj, std::string_view rel,
                 bool ns_wild) {
    // intern field codes first (matches interner.py set_node: codes are
    // interned at node creation), then key on the integer triple
    int64_t oc = g.obj_codes.intern(obj);
    int64_t rc = g.rel_codes.intern(rel);
    return set_node_coded(g, ns, oc, rc, obj.empty() || rel.empty(), ns_wild);
}

int64_t leaf_node(Graph& g, std::string_view s) {
    return g.leaf_ids.intern(s);
}

bool in_wild_ns(const std::vector<int64_t>& wild_ns_ids, int64_t ns) {
    for (int64_t w : wild_ns_ids)
        if (w == ns) return true;
    return false;
}

bool is_wild_ns(const Graph& g, int64_t ns) { return in_wild_ns(g.wild_ns_ids, ns); }

inline void add_row(Graph& g, int64_t ns, std::string_view obj, std::string_view rel,
                    bool sub_is_leaf, std::string_view sid, int64_t sns,
                    std::string_view sso, std::string_view ssr) {
    // intern each LHS field once and reuse the code for both the node key
    // and the per-tuple arrays (the extra per-field lookup was ~25% of the
    // interning pass at 10M rows)
    int64_t oc = g.obj_codes.intern(obj);
    int64_t rc = g.rel_codes.intern(rel);
    int64_t lhs = set_node_coded(g, ns, oc, rc, obj.empty() || rel.empty(),
                                 is_wild_ns(g, ns));
    g.t_lhs.push_back(lhs);
    g.t_ns.push_back(ns);
    g.t_obj.push_back(oc);
    g.t_rel.push_back(rc);
    if (sub_is_leaf) {
        g.t_sub_kind.push_back(1);
        g.t_sub_idx.push_back(leaf_node(g, sid));
    } else {
        g.t_sub_kind.push_back(0);
        g.t_sub_idx.push_back(set_node(g, sns, sso, ssr, is_wild_ns(g, sns)));
    }
}

// edges + dedup + temporary teardown, shared by both build entry points
void finish_edges(Graph* g) {
    // edges: literal LHS nodes take their own tuples; wildcard-bearing set
    // nodes take every matching tuple's subject (see interner.py pass 2)
    const int64_t num_sets = (int64_t)g->num_set_nodes();
    const size_t nt = g->t_lhs.size();
    auto sub_raw = [&](size_t i) {
        return g->t_sub_kind[i] ? g->t_sub_idx[i] + num_sets : g->t_sub_idx[i];
    };
    g->src.reserve(nt);
    g->dst.reserve(nt);
    for (size_t i = 0; i < nt; ++i) {
        if (!g->sets.wild[(size_t)g->t_lhs[i]]) {
            g->src.push_back(g->t_lhs[i]);
            g->dst.push_back(sub_raw(i));
        }
    }
    const int64_t empty_obj = g->obj_codes.find(std::string_view(""));
    const int64_t empty_rel = g->rel_codes.find(std::string_view(""));
    for (int64_t s = 0; s < num_sets; ++s) {
        if (!g->sets.wild[(size_t)s]) continue;
        const bool ns_w = is_wild_ns(*g, g->sets.key_ns[(size_t)s]);
        const bool obj_w = g->sets.key_obj[(size_t)s] == empty_obj;
        const bool rel_w = g->sets.key_rel[(size_t)s] == empty_rel;
        for (size_t i = 0; i < nt; ++i) {
            if (!ns_w && g->t_ns[i] != g->sets.key_ns[(size_t)s]) continue;
            if (!obj_w && g->t_obj[i] != g->sets.key_obj[(size_t)s]) continue;
            if (!rel_w && g->t_rel[i] != g->sets.key_rel[(size_t)s]) continue;
            g->src.push_back(s);
            g->dst.push_back(sub_raw(i));
        }
    }

    // dedup edges (duplicate tuples add nothing to reachability), keeping
    // the FIRST occurrence in emission order: rows arrive in the store's
    // ORDER BY, so each set node's surviving out-edge order is the order
    // the Manager pages that node's tuples — the expand engine's
    // tree-child order depends on this (keto_tpu/expand/tpu_engine.py,
    // mirrored in interner.py intern_rows)
    if (!g->src.empty()) {
        const int64_t n_nodes = num_sets + (int64_t)g->leaf_ids.size();
        std::vector<std::pair<int64_t, size_t>> packed(g->src.size());
        for (size_t i = 0; i < packed.size(); ++i)
            packed[i] = {g->src[i] * n_nodes + g->dst[i], i};
        std::sort(packed.begin(), packed.end());
        std::vector<size_t> keep;
        keep.reserve(packed.size());
        for (size_t i = 0; i < packed.size(); ++i)
            if (i == 0 || packed[i].first != packed[i - 1].first)
                keep.push_back(packed[i].second);
        std::sort(keep.begin(), keep.end());
        std::vector<int64_t> src2(keep.size()), dst2(keep.size());
        for (size_t i = 0; i < keep.size(); ++i) {
            src2[i] = g->src[keep[i]];
            dst2[i] = g->dst[keep[i]];
        }
        g->src.swap(src2);
        g->dst.swap(dst2);
    }

    // per-tuple build temporaries are dead once edges exist; the handle
    // stays resident for string resolution, so drop them now
    std::vector<int64_t>().swap(g->t_lhs);
    std::vector<int64_t>().swap(g->t_ns);
    std::vector<int64_t>().swap(g->t_obj);
    std::vector<int64_t>().swap(g->t_rel);
    std::vector<int64_t>().swap(g->t_sub_idx);
    std::vector<uint8_t>().swap(g->t_sub_kind);
}

void reserve_rows(Graph* g, size_t n) {
    g->t_lhs.reserve(n);
    g->t_ns.reserve(n);
    g->t_obj.reserve(n);
    g->t_rel.reserve(n);
    g->t_sub_idx.reserve(n);
    g->t_sub_kind.reserve(n);
    // pre-size the intern tables: growth rehashes at 10M inserts cost more
    // than the (transient) bucket-array over-allocation
    g->sets.reserve(n / 2 + 16);
    g->leaf_ids.reserve(n / 2 + 16);
    g->obj_codes.reserve(n / 2 + 16);
    g->rel_codes.reserve(1024);
    g->sets.key_ns.reserve(n / 2 + 16);
    g->sets.key_obj.reserve(n / 2 + 16);
    g->sets.key_rel.reserve(n / 2 + 16);
    g->sets.wild.reserve(n / 2 + 16);
}

// Decode one fixed-width UCS4 (numpy '<U*') cell into utf-8 in ``out``;
// returns a view over ``out``. Cells are NUL-padded to ``width`` code
// points; decoding stops at the first NUL.
inline std::string_view sv_from_ucs4(const uint32_t* p, int64_t width,
                                     std::string& out) {
    out.clear();
    for (int64_t i = 0; i < width; ++i) {
        uint32_t cp = p[i];
        if (cp == 0) break;
        if (cp < 0x80) {
            out.push_back((char)cp);
        } else if (cp < 0x800) {
            out.push_back((char)(0xC0 | (cp >> 6)));
            out.push_back((char)(0x80 | (cp & 0x3F)));
        } else if (cp < 0x10000) {
            out.push_back((char)(0xE0 | (cp >> 12)));
            out.push_back((char)(0x80 | ((cp >> 6) & 0x3F)));
            out.push_back((char)(0x80 | (cp & 0x3F)));
        } else {
            out.push_back((char)(0xF0 | (cp >> 18)));
            out.push_back((char)(0x80 | ((cp >> 12) & 0x3F)));
            out.push_back((char)(0x80 | ((cp >> 6) & 0x3F)));
            out.push_back((char)(0x80 | (cp & 0x3F)));
        }
    }
    return std::string_view(out);
}

// ---------------------------------------------------------------------------
// Parallel ingest.
//
// A worker interns its chunk into a thread-local Shard; the serial merge
// replays each shard's local ids IN LOCAL-ID ORDER, chunk by chunk, into
// the global tables. Local-id order IS first-occurrence order within the
// chunk, so the global assignment equals a serial pass over the whole
// stream — deterministic and bit-identical to the single-threaded path.

struct Shard {
    SetTable sets;
    StrTable leaf_ids, obj_codes, rel_codes;
    // per-tuple arrays with LOCAL codes/ids (remapped at merge)
    std::vector<int64_t> t_lhs, t_ns, t_obj, t_rel, t_sub_idx;
    std::vector<uint8_t> t_sub_kind;
};

inline void shard_add_row(Shard& s, const std::vector<int64_t>& wild_ns,
                          int64_t ns, std::string_view obj, std::string_view rel,
                          bool sub_is_leaf, std::string_view sid, int64_t sns,
                          std::string_view sso, std::string_view ssr) {
    int64_t oc = s.obj_codes.intern(obj);
    int64_t rc = s.rel_codes.intern(rel);
    int64_t lhs = s.sets.lookup(ns, oc, rc, true,
                                in_wild_ns(wild_ns, ns) || obj.empty() || rel.empty());
    s.t_lhs.push_back(lhs);
    s.t_ns.push_back(ns);
    s.t_obj.push_back(oc);
    s.t_rel.push_back(rc);
    if (sub_is_leaf) {
        s.t_sub_kind.push_back(1);
        s.t_sub_idx.push_back(s.leaf_ids.intern(sid));
    } else {
        s.t_sub_kind.push_back(0);
        int64_t soc = s.obj_codes.intern(sso);
        int64_t src = s.rel_codes.intern(ssr);
        s.t_sub_idx.push_back(s.sets.lookup(
            sns, soc, src, true,
            in_wild_ns(wild_ns, sns) || sso.empty() || ssr.empty()));
    }
}

unsigned ingest_threads(int64_t n) {
    const char* e = std::getenv("KETO_TPU_INGEST_THREADS");
    if (e && *e) {
        long v = std::atol(e);
        if (v >= 1) return (unsigned)v;
    }
    if (n < 262144) return 1;  // spawn + merge overhead dominates tiny builds
    unsigned hc = std::thread::hardware_concurrency();
    return std::max(1u, std::min(hc ? hc : 1u, 16u));
}

void merge_shards(Graph* g, std::vector<Shard*>& shards, int64_t n);

// RowFn: void(Shard&, int64_t row_index) — interns one source row into the
// shard. Builds the graph's per-tuple arrays from n rows, parallel when
// worthwhile, then emits edges.
template <typename RowFn>
void build_tuples(Graph* g, int64_t n, RowFn&& intern_row) {
    unsigned nt = ingest_threads(n);
    if (nt <= 1 || n < (int64_t)nt) {
        reserve_rows(g, (size_t)n);
        Shard whole;  // serial path reuses the shard logic (one chunk)
        whole.sets.reserve((size_t)n / 2 + 16);
        whole.leaf_ids.reserve((size_t)n / 2 + 16);
        whole.obj_codes.reserve((size_t)n / 2 + 16);
        whole.rel_codes.reserve(1024);
        for (int64_t i = 0; i < n; ++i) intern_row(whole, i);
        std::vector<Shard*> shards{&whole};
        merge_shards(g, shards, n);
        finish_edges(g);
        return;
    }
    std::vector<Shard> shards(nt);
    std::vector<std::thread> workers;
    workers.reserve(nt);
    const int64_t chunk = (n + nt - 1) / nt;
    for (unsigned t = 0; t < nt; ++t) {
        workers.emplace_back([&, t]() {
            Shard& s = shards[t];
            const int64_t i0 = (int64_t)t * chunk;
            const int64_t i1 = std::min(n, i0 + chunk);
            if (i0 >= i1) return;
            const size_t cn = (size_t)(i1 - i0);
            s.sets.reserve(cn / 2 + 16);
            s.leaf_ids.reserve(cn / 2 + 16);
            s.obj_codes.reserve(cn / 2 + 16);
            s.rel_codes.reserve(256);
            s.t_lhs.reserve(cn);
            s.t_sub_idx.reserve(cn);
            for (int64_t i = i0; i < i1; ++i) intern_row(s, i);
        });
    }
    for (auto& w : workers) w.join();
    std::vector<Shard*> ptrs;
    ptrs.reserve(nt);
    for (auto& s : shards) ptrs.push_back(&s);
    reserve_rows(g, (size_t)n);
    merge_shards(g, ptrs, n);
    finish_edges(g);
}

// Serial merge: chunk order × local-id order = serial first-occurrence
// order (see the module comment). The per-tuple remap afterwards is the
// only O(rows) serial work and is a handful of array lookups per row.
void merge_shards(Graph* g, std::vector<Shard*>& shards, int64_t n) {
    g->t_lhs.resize((size_t)n);
    g->t_ns.resize((size_t)n);
    g->t_obj.resize((size_t)n);
    g->t_rel.resize((size_t)n);
    g->t_sub_idx.resize((size_t)n);
    g->t_sub_kind.resize((size_t)n);
    size_t off = 0;
    std::vector<int64_t> obj_map, rel_map, leaf_map, set_map;
    for (Shard* s : shards) {
        obj_map.resize(s->obj_codes.size());
        for (size_t c = 0; c < s->obj_codes.size(); ++c)
            obj_map[c] = g->obj_codes.intern(s->obj_codes.arena[c]);
        rel_map.resize(s->rel_codes.size());
        for (size_t c = 0; c < s->rel_codes.size(); ++c)
            rel_map[c] = g->rel_codes.intern(s->rel_codes.arena[c]);
        leaf_map.resize(s->leaf_ids.size());
        for (size_t c = 0; c < s->leaf_ids.size(); ++c)
            leaf_map[c] = g->leaf_ids.intern(s->leaf_ids.arena[c]);
        set_map.resize(s->sets.size());
        for (size_t id = 0; id < s->sets.size(); ++id)
            set_map[id] = g->sets.lookup(
                s->sets.key_ns[id], obj_map[(size_t)s->sets.key_obj[id]],
                rel_map[(size_t)s->sets.key_rel[id]], true, s->sets.wild[id]);
        const size_t cn = s->t_lhs.size();
        for (size_t i = 0; i < cn; ++i) {
            g->t_lhs[off + i] = set_map[(size_t)s->t_lhs[i]];
            g->t_ns[off + i] = s->t_ns[i];
            g->t_obj[off + i] = obj_map[(size_t)s->t_obj[i]];
            g->t_rel[off + i] = rel_map[(size_t)s->t_rel[i]];
            g->t_sub_kind[off + i] = s->t_sub_kind[i];
            g->t_sub_idx[off + i] = s->t_sub_kind[i]
                                        ? leaf_map[(size_t)s->t_sub_idx[i]]
                                        : set_map[(size_t)s->t_sub_idx[i]];
        }
        off += cn;
        // free the shard's per-tuple arrays eagerly (peak-memory control;
        // the intern tables die with the Shard vector)
        std::vector<int64_t>().swap(s->t_lhs);
        std::vector<int64_t>().swap(s->t_ns);
        std::vector<int64_t>().swap(s->t_obj);
        std::vector<int64_t>().swap(s->t_rel);
        std::vector<int64_t>().swap(s->t_sub_idx);
        std::vector<uint8_t>().swap(s->t_sub_kind);
    }
}

// Parse one packed-record buffer (graph_build's wire format) into a
// thread-local Shard; returns parsed row count, or -1 on a malformed
// buffer. Shared by the streaming builder's workers.
int64_t parse_packed_into_shard(Shard& s, const std::vector<int64_t>& wild,
                                const char* p, const char* end) {
    std::string_view fields[7];
    int64_t count = 0;
    while (p < end) {
        int f = 0;
        const char* field_start = p;
        while (p < end && f < 7) {
            if (*p == '\x1f' || *p == '\x1e') {
                fields[f++] = std::string_view(field_start, (size_t)(p - field_start));
                bool rec_end = (*p == '\x1e');
                ++p;
                field_start = p;
                if (rec_end) break;
            } else {
                ++p;
            }
        }
        if (f != 7) return -1;
        int64_t ns = 0;
        for (char c : fields[0]) {
            if (c < '0' || c > '9') return -1;
            ns = ns * 10 + (c - '0');
        }
        if (fields[3] == "1") {
            shard_add_row(s, wild, ns, fields[1], fields[2], true, fields[4], 0,
                          std::string_view(), std::string_view());
        } else {
            int64_t sns = 0;
            for (char c : fields[4]) {
                if (c < '0' || c > '9') return -1;
                sns = sns * 10 + (c - '0');
            }
            shard_add_row(s, wild, ns, fields[1], fields[2], false,
                          std::string_view(), sns, fields[5], fields[6]);
        }
        ++count;
    }
    return count;
}

// ---------------------------------------------------------------------------
// Streaming build: the chunked-cursor counterpart of build_tuples.
//
// The one-shot entry points require the whole input up front, which
// serializes SQL I/O *before* interning. stream_build_feed instead
// enqueues each scan chunk (copied — the caller's buffer is transient)
// onto a bounded work queue drained by a worker pool; workers intern
// chunks into per-CHUNK Shards concurrently with the caller's next
// fetch, so store I/O overlaps interning. stream_build_finish merges
// the shards IN FEED ORDER — the same chunk-order × local-id-order
// replay build_tuples uses — so the result is bit-identical to a
// serial pass over the concatenated stream (and therefore to the
// one-shot graph_build and the Python interner).

struct StreamBuilder {
    std::vector<int64_t> wild_ns_ids;
    std::mutex mu;
    std::condition_variable cv_work;   // workers wait for chunks
    std::condition_variable cv_space;  // feeder waits for queue room
    std::deque<std::pair<size_t, std::string>> queue;  // (chunk idx, buf)
    std::vector<Shard*> shards;        // per chunk, in feed order
    std::vector<std::thread> workers;
    size_t max_queue = 0;
    bool done = false;
    bool error = false;

    ~StreamBuilder() {
        for (Shard* s : shards) delete s;
    }
};

void stream_worker(StreamBuilder* sb) {
    for (;;) {
        Shard* s;
        std::string buf;
        {
            std::unique_lock<std::mutex> lk(sb->mu);
            sb->cv_work.wait(lk, [&] { return !sb->queue.empty() || sb->done; });
            if (sb->queue.empty()) return;  // done and drained
            // read under the lock: the feeder's push_back may move the
            // vector's storage while this chunk is interned
            s = sb->shards[sb->queue.front().first];
            buf = std::move(sb->queue.front().second);
            sb->queue.pop_front();
            sb->cv_space.notify_one();
        }
        if (parse_packed_into_shard(*s, sb->wild_ns_ids, buf.data(),
                                    buf.data() + buf.size()) < 0) {
            std::unique_lock<std::mutex> lk(sb->mu);
            sb->error = true;
        }
    }
}

}  // namespace

extern "C" {

// Create a streaming builder: n_threads workers (0 = the ingest_threads
// default for a large input) drain the chunk queue concurrently with
// the caller's scan loop.
StreamBuilder* stream_build_new(const int64_t* wild_ns_ids, int64_t n_wild_ns,
                                int64_t n_threads) {
    StreamBuilder* sb = new StreamBuilder();
    sb->wild_ns_ids.assign(wild_ns_ids, wild_ns_ids + n_wild_ns);
    unsigned nt = n_threads > 0 ? (unsigned)n_threads : ingest_threads(1 << 20);
    sb->max_queue = 2 * nt + 2;  // bounds buffered-chunk memory
    sb->workers.reserve(nt);
    for (unsigned t = 0; t < nt; ++t)
        sb->workers.emplace_back(stream_worker, sb);
    return sb;
}

// Enqueue one packed-record chunk (copied). n_rows sizes the chunk
// shard's intern-table reserves. Blocks while the queue is full (the
// scan is ahead of interning — backpressure bounds memory). Returns 0,
// or -1 if a previous chunk was malformed (the stream is dead; callers
// fall back to the Python interner over their accumulated rows).
int64_t stream_build_feed(StreamBuilder* sb, const char* buf, int64_t len,
                          int64_t n_rows) {
    Shard* s = new Shard();
    const size_t cn = (size_t)(n_rows > 0 ? n_rows : 1024);
    s->sets.reserve(cn / 2 + 16);
    s->leaf_ids.reserve(cn / 2 + 16);
    s->obj_codes.reserve(cn / 2 + 16);
    s->rel_codes.reserve(256);
    s->t_lhs.reserve(cn);
    s->t_sub_idx.reserve(cn);
    {
        std::unique_lock<std::mutex> lk(sb->mu);
        if (sb->error) {
            delete s;
            return -1;
        }
        sb->cv_space.wait(lk, [&] { return sb->queue.size() < sb->max_queue; });
        size_t idx = sb->shards.size();
        sb->shards.push_back(s);
        sb->queue.emplace_back(idx, std::string(buf, (size_t)len));
    }
    sb->cv_work.notify_one();
    return 0;
}

// Drain the queue, join the workers, and merge the per-chunk shards in
// feed order into a Graph (identical ids to the one-shot build over the
// concatenated stream). Consumes the builder. Returns nullptr when any
// chunk was malformed.
Graph* stream_build_finish(StreamBuilder* sb) {
    {
        std::unique_lock<std::mutex> lk(sb->mu);
        sb->done = true;
    }
    sb->cv_work.notify_all();
    for (auto& w : sb->workers) w.join();
    if (sb->error) {
        delete sb;
        return nullptr;
    }
    int64_t n = 0;
    for (Shard* s : sb->shards) n += (int64_t)s->t_lhs.size();
    Graph* g = new Graph();
    g->wild_ns_ids = sb->wild_ns_ids;
    reserve_rows(g, (size_t)n);
    merge_shards(g, sb->shards, n);
    finish_edges(g);
    delete sb;
    return g;
}

// Tear a builder down without producing a graph (a failed scan retries
// with a fresh builder).
void stream_build_abort(StreamBuilder* sb) {
    {
        std::unique_lock<std::mutex> lk(sb->mu);
        sb->done = true;
        sb->queue.clear();
    }
    sb->cv_work.notify_all();
    for (auto& w : sb->workers) w.join();
    delete sb;
}

// UCS4 columnar fast path: string columns as numpy '<U*' fixed-width
// arrays (data pointer + per-cell width in code points). This is the
// zero-copy handoff from the store's bulk-ingest column cache
// (keto_tpu/persistence/memory.py): no Python-side encoding at all.
Graph* graph_build_ucs4(
    int64_t n, const int64_t* ns, const uint8_t* kind, const int64_t* sns,
    const uint32_t* obj, int64_t obj_w,
    const uint32_t* rel, int64_t rel_w,
    const uint32_t* sid, int64_t sid_w,
    const uint32_t* sso, int64_t sso_w,
    const uint32_t* ssr, int64_t ssr_w,
    const int64_t* wild_ns_ids, int64_t n_wild_ns) {
    Graph* g = new Graph();
    g->wild_ns_ids.assign(wild_ns_ids, wild_ns_ids + n_wild_ns);
    const std::vector<int64_t>& wild = g->wild_ns_ids;
    // per-thread decode buffers live in the lambda's captured-by-value
    // copies — thread_local keeps one set per worker
    build_tuples(g, n, [&](Shard& s, int64_t i) {
        thread_local std::string b_obj, b_rel, b_sid, b_sso, b_ssr;
        std::string_view v_obj = sv_from_ucs4(obj + i * obj_w, obj_w, b_obj);
        std::string_view v_rel = sv_from_ucs4(rel + i * rel_w, rel_w, b_rel);
        if (kind[i]) {
            shard_add_row(s, wild, ns[i], v_obj, v_rel, true,
                          sv_from_ucs4(sid + i * sid_w, sid_w, b_sid), 0,
                          std::string_view(), std::string_view());
        } else {
            shard_add_row(s, wild, ns[i], v_obj, v_rel, false, std::string_view(),
                          sns[i], sv_from_ucs4(sso + i * sso_w, sso_w, b_sso),
                          sv_from_ucs4(ssr + i * ssr_w, ssr_w, b_ssr));
        }
    });
    return g;
}

// Columnar fast path: n rows as arrays. String column i of a row r is
// blob[starts[r] .. starts[r]+lens[r]); kind[r]=1 means subject-id row
// (sid column; sns/sso/ssr ignored), 0 means subject-set row (sid ignored).
Graph* graph_build_columnar(
    int64_t n, const int64_t* ns, const uint8_t* kind, const int64_t* sns,
    const char* obj_blob, const int64_t* obj_starts, const int64_t* obj_lens,
    const char* rel_blob, const int64_t* rel_starts, const int64_t* rel_lens,
    const char* sid_blob, const int64_t* sid_starts, const int64_t* sid_lens,
    const char* sso_blob, const int64_t* sso_starts, const int64_t* sso_lens,
    const char* ssr_blob, const int64_t* ssr_starts, const int64_t* ssr_lens,
    const int64_t* wild_ns_ids, int64_t n_wild_ns) {
    Graph* g = new Graph();
    g->wild_ns_ids.assign(wild_ns_ids, wild_ns_ids + n_wild_ns);
    const std::vector<int64_t>& wild = g->wild_ns_ids;
    build_tuples(g, n, [&](Shard& s, int64_t i) {
        shard_add_row(
            s, wild, ns[i],
            std::string_view(obj_blob + obj_starts[i], (size_t)obj_lens[i]),
            std::string_view(rel_blob + rel_starts[i], (size_t)rel_lens[i]),
            kind[i] != 0,
            std::string_view(sid_blob + sid_starts[i], (size_t)sid_lens[i]),
            sns[i],
            std::string_view(sso_blob + sso_starts[i], (size_t)sso_lens[i]),
            std::string_view(ssr_blob + ssr_starts[i], (size_t)ssr_lens[i]));
    });
    return g;
}

// Parse the packed row buffer; returns a Graph handle or nullptr on a
// malformed buffer. Stays serial: this path survives for odd encodings
// the columnar packer rejects — never the bulk-rebuild hot path.
Graph* graph_build(const char* buf, int64_t len, const int64_t* wild_ns_ids,
                   int64_t n_wild_ns) {
    Graph* g = new Graph();
    g->wild_ns_ids.assign(wild_ns_ids, wild_ns_ids + n_wild_ns);

    const char* p = buf;
    const char* end = buf + len;
    std::string_view fields[7];
    while (p < end) {
        // split one record into 7 fields
        int f = 0;
        const char* field_start = p;
        while (p < end && f < 7) {
            if (*p == '\x1f' || *p == '\x1e') {
                fields[f++] = std::string_view(field_start, (size_t)(p - field_start));
                bool rec_end = (*p == '\x1e');
                ++p;
                field_start = p;
                if (rec_end) break;
            } else {
                ++p;
            }
        }
        if (f != 7) {
            delete g;
            return nullptr;
        }
        int64_t ns = 0;
        for (char c : fields[0]) {
            if (c < '0' || c > '9') { delete g; return nullptr; }
            ns = ns * 10 + (c - '0');
        }
        int64_t sns = 0;
        if (fields[3] != "1") {
            for (char c : fields[4]) {
                if (c < '0' || c > '9') { delete g; return nullptr; }
                sns = sns * 10 + (c - '0');
            }
            add_row(*g, ns, fields[1], fields[2], false, std::string_view(), sns,
                    fields[5], fields[6]);
        } else {
            add_row(*g, ns, fields[1], fields[2], true, fields[4], 0,
                    std::string_view(), std::string_view());
        }
    }
    finish_edges(g);
    return g;
}

// Free the edge arrays once the caller has copied them out; resolution
// keeps working off the intern tables.
void graph_release_edges(Graph* g) {
    std::vector<int64_t>().swap(g->src);
    std::vector<int64_t>().swap(g->dst);
}

void graph_free(Graph* g) { delete g; }

int64_t graph_num_sets(const Graph* g) { return (int64_t)g->num_set_nodes(); }
int64_t graph_num_leaves(const Graph* g) { return (int64_t)g->leaf_ids.size(); }
int64_t graph_num_edges(const Graph* g) { return (int64_t)g->src.size(); }

// Code-table sizes: the compaction layer's ExtendedInterned assigns fresh
// field codes for new set keys ABOVE these (keto_tpu/graph/interner.py).
int64_t graph_num_obj_codes(const Graph* g) { return (int64_t)g->obj_codes.size(); }
int64_t graph_num_rel_codes(const Graph* g) { return (int64_t)g->rel_codes.size(); }

// Copy-out accessors; caller allocates.
void graph_edges(const Graph* g, int64_t* src, int64_t* dst) {
    std::memcpy(src, g->src.data(), g->src.size() * sizeof(int64_t));
    std::memcpy(dst, g->dst.data(), g->dst.size() * sizeof(int64_t));
}

void graph_keys(const Graph* g, int64_t* key_ns, int64_t* key_obj, int64_t* key_rel,
                uint8_t* wild) {
    std::memcpy(key_ns, g->sets.key_ns.data(), g->sets.key_ns.size() * sizeof(int64_t));
    std::memcpy(key_obj, g->sets.key_obj.data(), g->sets.key_obj.size() * sizeof(int64_t));
    std::memcpy(key_rel, g->sets.key_rel.data(), g->sets.key_rel.size() * sizeof(int64_t));
    std::memcpy(wild, g->sets.wild.data(), g->sets.wild.size());
}

// Resolution: -1 = not present.
int64_t graph_resolve_set(const Graph* g, int64_t ns, const char* obj, int64_t obj_len,
                          const char* rel, int64_t rel_len) {
    int64_t oc = g->obj_codes.find(std::string_view(obj, (size_t)obj_len));
    if (oc < 0) return -1;
    int64_t rc = g->rel_codes.find(std::string_view(rel, (size_t)rel_len));
    if (rc < 0) return -1;
    return const_cast<Graph*>(g)->sets.lookup(ns, oc, rc, /*insert=*/false, false);
}

int64_t graph_resolve_leaf(const Graph* g, const char* s, int64_t len) {
    return g->leaf_ids.find(std::string_view(s, (size_t)len));
}

// Bulk query resolution: the serving hot path. One call resolves n
// check queries packed in the same 7-field record format as rows
// (kind "1": f0 = subject id; kind "0": f0/f1/f2 = subject set). Writes
// out_start[i] = LHS set id or -1, out_sub[i] = subject raw id (leaves
// offset by num_sets, matching edge dst encoding) or -1. Returns 0 on
// success, -1 on a malformed buffer. Wildcard/pattern queries never
// reach this path (keto_tpu/check/tpu_engine.py routes them to the
// host-side pattern resolver).
int64_t graph_resolve_queries(const Graph* g, const char* buf, int64_t len,
                              int64_t n, int64_t* out_start, int64_t* out_sub) {
    const char* p = buf;
    const char* end = buf + len;
    const int64_t num_sets = (int64_t)g->num_set_nodes();
    std::string_view fields[7];
    int64_t i = 0;
    auto resolve_set_sv = [&](int64_t ns, std::string_view obj, std::string_view rel) {
        int64_t oc = g->obj_codes.find(obj);
        if (oc < 0) return (int64_t)-1;
        int64_t rc = g->rel_codes.find(rel);
        if (rc < 0) return (int64_t)-1;
        return const_cast<Graph*>(g)->sets.lookup(ns, oc, rc, false, false);
    };
    while (p < end && i < n) {
        int f = 0;
        const char* field_start = p;
        while (p < end && f < 7) {
            if (*p == '\x1f' || *p == '\x1e') {
                fields[f++] = std::string_view(field_start, (size_t)(p - field_start));
                bool rec_end = (*p == '\x1e');
                ++p;
                field_start = p;
                if (rec_end) break;
            } else {
                ++p;
            }
        }
        if (f != 7) return -1;
        int64_t ns = 0;
        for (char c : fields[0]) {
            if (c < '0' || c > '9') return -1;
            ns = ns * 10 + (c - '0');
        }
        out_start[i] = resolve_set_sv(ns, fields[1], fields[2]);
        if (fields[3] == "1") {
            int64_t lt = g->leaf_ids.find(fields[4]);
            out_sub[i] = lt < 0 ? -1 : lt + num_sets;
        } else {
            int64_t sns = 0;
            for (char c : fields[4]) {
                if (c < '0' || c > '9') return -1;
                sns = sns * 10 + (c - '0');
            }
            out_sub[i] = resolve_set_sv(sns, fields[5], fields[6]);
        }
        ++i;
    }
    return (i == n && p >= end) ? 0 : -1;
}

int64_t graph_obj_code(const Graph* g, const char* s, int64_t len) {
    return g->obj_codes.find(std::string_view(s, (size_t)len));
}

int64_t graph_rel_code(const Graph* g, const char* s, int64_t len) {
    return g->rel_codes.find(std::string_view(s, (size_t)len));
}

// Reverse lookups (expand-tree reconstruction): pointer into the resident
// intern table + length, or nullptr when out of range. The pointer stays
// valid for the Graph's lifetime.
const char* graph_obj_str(const Graph* g, int64_t code, int64_t* out_len) {
    if (code < 0 || (size_t)code >= g->obj_codes.size()) return nullptr;
    const std::string& s = g->obj_codes.arena[(size_t)code];
    *out_len = (int64_t)s.size();
    return s.data();
}

const char* graph_rel_str(const Graph* g, int64_t code, int64_t* out_len) {
    if (code < 0 || (size_t)code >= g->rel_codes.size()) return nullptr;
    const std::string& s = g->rel_codes.arena[(size_t)code];
    *out_len = (int64_t)s.size();
    return s.data();
}

const char* graph_leaf_str(const Graph* g, int64_t idx, int64_t* out_len) {
    if (idx < 0 || (size_t)idx >= g->leaf_ids.size()) return nullptr;
    const std::string& s = g->leaf_ids.arena[(size_t)idx];
    *out_len = (int64_t)s.size();
    return s.data();
}

}  // extern "C"
