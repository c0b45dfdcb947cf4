// Native row engine of baikaldb_tpu_torch: memcomparable key codec + MVCC
// memtable.  A copy of baikaldb_tpu/native/engine.cpp (same key bytes, same
// WAL records), so the port reads a WAL the JAX package wrote.  One change:
// a table counts its live keys as versions are pushed, so
// bk_table_num_live_keys (read after every replicated write) is O(1), not a
// walk of the map.
//
// The reference's OLTP tier is RocksDB behind a memcomparable key encoding
// (include/common/key_encoder.h: sign-flipped big-endian ints, IEEE-rearranged
// floats, escaped strings) and pessimistic transactions
// (src/engine/transaction.cpp).  This is a ground-up miniature with the same
// *capabilities* re-scoped for an accelerator build: the hot row tier only needs to
// absorb OLTP writes and feed the columnar tier, so it is an ordered in-memory
// table (std::map over encoded keys) with sequence-number MVCC, snapshot
// reads, and an append-only redo log for durability.  C ABI only — Python
// binds via ctypes (no pybind11 in this image).
//
// Key encoding (order-preserving bytes):
//   NULL byte:   0x00 = NULL, 0x01 = value follows (NULLs sort first)
//   int64:       8 bytes big-endian with the sign bit flipped
//   float64:     IEEE bits; if negative flip all bits else flip sign bit
//   string:      escape 0x00 -> {0x00,0xFF}; terminate with {0x00,0x00}
//
// MVCC: every write gets a monotonically increasing sequence; a read at
// snapshot S sees the newest version with seq <= S that is not a tombstone.

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <map>
#include <mutex>
#include <string>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// key codec

static inline void put_u64_be(std::string& out, uint64_t v) {
    for (int i = 7; i >= 0; --i) out.push_back((char)((v >> (i * 8)) & 0xFF));
}

void bk_encode_i64(std::string* out, int64_t v) {
    put_u64_be(*out, (uint64_t)v ^ 0x8000000000000000ULL);
}

void bk_encode_f64(std::string* out, double d) {
    uint64_t bits;
    memcpy(&bits, &d, 8);
    if (bits & 0x8000000000000000ULL) bits = ~bits;       // negative: flip all
    else bits |= 0x8000000000000000ULL;                    // positive: flip sign
    put_u64_be(*out, bits);
}

void bk_encode_bytes(std::string* out, const uint8_t* s, int64_t len) {
    for (int64_t i = 0; i < len; ++i) {
        if (s[i] == 0x00) { out->push_back((char)0x00); out->push_back((char)0xFF); }
        else out->push_back((char)s[i]);
    }
    out->push_back((char)0x00);
    out->push_back((char)0x00);
}

// Batch encode one column into per-row buffers.  kinds: 0=i64, 1=f64, 2=bytes.
// For bytes, vals points at concatenated utf8 and offs[n+1] gives slices.
struct BkKeyBatch {
    std::vector<std::string> rows;
};

BkKeyBatch* bk_batch_new(int64_t n) {
    auto* b = new BkKeyBatch();
    b->rows.resize((size_t)n);
    return b;
}

void bk_batch_free(BkKeyBatch* b) { delete b; }

void bk_batch_append_i64(BkKeyBatch* b, const int64_t* vals,
                         const uint8_t* valid, int64_t n) {
    for (int64_t i = 0; i < n; ++i) {
        std::string& r = b->rows[(size_t)i];
        if (valid && !valid[i]) { r.push_back((char)0x00); continue; }
        r.push_back((char)0x01);
        bk_encode_i64(&r, vals[i]);
    }
}

void bk_batch_append_f64(BkKeyBatch* b, const double* vals,
                         const uint8_t* valid, int64_t n) {
    for (int64_t i = 0; i < n; ++i) {
        std::string& r = b->rows[(size_t)i];
        if (valid && !valid[i]) { r.push_back((char)0x00); continue; }
        r.push_back((char)0x01);
        bk_encode_f64(&r, vals[i]);
    }
}

void bk_batch_append_bytes(BkKeyBatch* b, const uint8_t* data,
                           const int64_t* offs, const uint8_t* valid,
                           int64_t n) {
    for (int64_t i = 0; i < n; ++i) {
        std::string& r = b->rows[(size_t)i];
        if (valid && !valid[i]) { r.push_back((char)0x00); continue; }
        r.push_back((char)0x01);
        bk_encode_bytes(&r, data + offs[i], offs[i + 1] - offs[i]);
    }
}

// copy out: concatenated keys + offsets
int64_t bk_batch_total(BkKeyBatch* b) {
    int64_t t = 0;
    for (auto& r : b->rows) t += (int64_t)r.size();
    return t;
}

void bk_batch_dump(BkKeyBatch* b, uint8_t* out, int64_t* offs) {
    int64_t pos = 0;
    int64_t i = 0;
    for (auto& r : b->rows) {
        offs[i++] = pos;
        memcpy(out + pos, r.data(), r.size());
        pos += (int64_t)r.size();
    }
    offs[i] = pos;
}

// ---------------------------------------------------------------------------
// MVCC memtable

struct Version {
    uint64_t seq;
    bool tombstone;
    std::string value;
};

struct BkTable {
    std::map<std::string, std::vector<Version>> rows;  // newest last
    uint64_t next_seq = 1;
    int64_t live = 0;        // keys whose newest version is not a tombstone
    std::mutex mu;
    FILE* wal = nullptr;
};

// append a key's newest version, keeping the live-key count (the region
// size signal read after every replicated write) without a scan
static void push_version(BkTable* t, const std::string& k, uint64_t seq,
                         bool tombstone, const std::string& v) {
    auto& vs = t->rows[k];
    bool was_live = !vs.empty() && !vs.back().tombstone;
    vs.push_back(Version{seq, tombstone, v});
    t->live += (tombstone ? 0 : 1) - (was_live ? 1 : 0);
}

BkTable* bk_table_new() { return new BkTable(); }

void bk_table_free(BkTable* t) {
    if (t->wal) fclose(t->wal);
    delete t;
}

static void wal_record(BkTable* t, uint8_t op, const std::string& k,
                       const std::string& v, uint64_t seq) {
    if (!t->wal) return;
    uint64_t kl = k.size(), vl = v.size();
    fwrite(&op, 1, 1, t->wal);
    fwrite(&seq, 8, 1, t->wal);
    fwrite(&kl, 8, 1, t->wal);
    fwrite(&vl, 8, 1, t->wal);
    fwrite(k.data(), 1, kl, t->wal);
    fwrite(v.data(), 1, vl, t->wal);
}

int bk_table_open_wal(BkTable* t, const char* path) {
    std::lock_guard<std::mutex> g(t->mu);
    // replay existing log, then append
    FILE* f = fopen(path, "rb");
    if (f) {
        while (true) {
            uint8_t op;
            uint64_t seq, kl, vl;
            if (fread(&op, 1, 1, f) != 1) break;
            if (fread(&seq, 8, 1, f) != 1) break;
            if (fread(&kl, 8, 1, f) != 1) break;
            if (fread(&vl, 8, 1, f) != 1) break;
            std::string k(kl, '\0'), v(vl, '\0');
            if (kl && fread(&k[0], 1, kl, f) != kl) break;
            if (vl && fread(&v[0], 1, vl, f) != vl) break;
            push_version(t, k, seq, op == 1, v);
            if (seq >= t->next_seq) t->next_seq = seq + 1;
        }
        fclose(f);
    }
    t->wal = fopen(path, "ab");
    return t->wal ? 0 : -1;
}

void bk_table_wal_sync(BkTable* t) {
    std::lock_guard<std::mutex> g(t->mu);
    if (t->wal) fflush(t->wal);
}

// batch write: op 0=put 1=delete.  Returns the commit sequence (all rows in
// one call share it — a write batch is the atomic commit unit, like the
// reference's rocksdb WriteBatch in Transaction::commit).
uint64_t bk_table_write_batch(BkTable* t, const uint8_t* ops,
                              const uint8_t* keys, const int64_t* key_offs,
                              const uint8_t* vals, const int64_t* val_offs,
                              int64_t n) {
    std::lock_guard<std::mutex> g(t->mu);
    uint64_t seq = t->next_seq++;
    for (int64_t i = 0; i < n; ++i) {
        std::string k((const char*)keys + key_offs[i],
                      (size_t)(key_offs[i + 1] - key_offs[i]));
        std::string v((const char*)vals + val_offs[i],
                      (size_t)(val_offs[i + 1] - val_offs[i]));
        push_version(t, k, seq, ops[i] == 1, v);
        wal_record(t, ops[i], k, v, seq);
    }
    return seq;
}

uint64_t bk_table_snapshot(BkTable* t) {
    std::lock_guard<std::mutex> g(t->mu);
    return t->next_seq - 1;
}

// point get at snapshot: returns length (>=0) and writes value pointer info;
// -1 = not found / deleted.  Value bytes are copied into caller buffer if it
// fits, else only the needed size is returned via *need.
int64_t bk_table_get(BkTable* t, const uint8_t* key, int64_t klen,
                     uint64_t snapshot, uint8_t* out, int64_t cap,
                     int64_t* need) {
    std::lock_guard<std::mutex> g(t->mu);
    auto it = t->rows.find(std::string((const char*)key, (size_t)klen));
    if (it == t->rows.end()) return -1;
    const Version* best = nullptr;
    for (const auto& v : it->second)
        if (v.seq <= snapshot) best = &v;
    if (!best || best->tombstone) return -1;
    *need = (int64_t)best->value.size();
    if ((int64_t)best->value.size() <= cap)
        memcpy(out, best->value.data(), best->value.size());
    return *need;
}

// range scan [lo, hi) at snapshot.  Two-phase: first call with out=null gets
// counts; second call copies.  Caller holds no lock between calls, so the
// scan object snapshots results.
struct BkScan {
    std::vector<std::string> keys;
    std::vector<std::string> vals;
};

BkScan* bk_table_scan(BkTable* t, const uint8_t* lo, int64_t lo_len,
                      const uint8_t* hi, int64_t hi_len, uint64_t snapshot,
                      int64_t limit) {
    std::lock_guard<std::mutex> g(t->mu);
    auto* s = new BkScan();
    auto it = lo_len ? t->rows.lower_bound(std::string((const char*)lo, (size_t)lo_len))
                     : t->rows.begin();
    std::string hikey = hi_len ? std::string((const char*)hi, (size_t)hi_len)
                               : std::string();
    for (; it != t->rows.end(); ++it) {
        if (hi_len && it->first >= hikey) break;
        const Version* best = nullptr;
        for (const auto& v : it->second)
            if (v.seq <= snapshot) best = &v;
        if (!best || best->tombstone) continue;
        s->keys.push_back(it->first);
        s->vals.push_back(best->value);
        if (limit > 0 && (int64_t)s->keys.size() >= limit) break;
    }
    return s;
}

int64_t bk_scan_count(BkScan* s) { return (int64_t)s->keys.size(); }

int64_t bk_scan_total_key_bytes(BkScan* s) {
    int64_t t = 0;
    for (auto& k : s->keys) t += (int64_t)k.size();
    return t;
}

int64_t bk_scan_total_val_bytes(BkScan* s) {
    int64_t t = 0;
    for (auto& v : s->vals) t += (int64_t)v.size();
    return t;
}

void bk_scan_dump(BkScan* s, uint8_t* kout, int64_t* koffs, uint8_t* vout,
                  int64_t* voffs) {
    int64_t kp = 0, vp = 0, i = 0;
    for (size_t j = 0; j < s->keys.size(); ++j) {
        koffs[i] = kp;
        voffs[i] = vp;
        memcpy(kout + kp, s->keys[j].data(), s->keys[j].size());
        memcpy(vout + vp, s->vals[j].data(), s->vals[j].size());
        kp += (int64_t)s->keys[j].size();
        vp += (int64_t)s->vals[j].size();
        ++i;
    }
    koffs[i] = kp;
    voffs[i] = vp;
}

void bk_scan_free(BkScan* s) { delete s; }

// garbage-collect versions older than `keep` (compaction analog)
void bk_table_gc(BkTable* t, uint64_t keep) {
    std::lock_guard<std::mutex> g(t->mu);
    for (auto it = t->rows.begin(); it != t->rows.end();) {
        auto& vs = it->second;
        // keep the newest version <= keep plus everything newer
        size_t first_keep = 0;
        for (size_t i = 0; i < vs.size(); ++i)
            if (vs[i].seq <= keep) first_keep = i;
        if (first_keep > 0)
            vs.erase(vs.begin(), vs.begin() + (long)first_keep);
        if (vs.size() == 1 && vs[0].tombstone && vs[0].seq <= keep)
            it = t->rows.erase(it);
        else
            ++it;
    }
}

int64_t bk_table_num_keys(BkTable* t) {
    std::lock_guard<std::mutex> g(t->mu);
    return (int64_t)t->rows.size();
}

int64_t bk_table_num_live_keys(BkTable* t) {
    // keys whose newest version is not a tombstone — the region-size signal
    // for split/merge policy (tombstoned keys linger until gc, so
    // num_keys would re-trigger splits on just-trimmed regions); counted as
    // versions are pushed (gc drops only older versions and dead keys)
    std::lock_guard<std::mutex> g(t->mu);
    return t->live;
}

}  // extern "C"
