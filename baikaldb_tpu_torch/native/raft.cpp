// baikaldb_tpu native Raft core — a deterministic consensus state machine.
//
// The reference replicates every Region through a braft::StateMachine with a
// RocksDB-backed log (include/raft/my_raft_log_storage.h:55, per-region
// node in include/store/region.h:445).  This is a ground-up re-design with
// the same capabilities but a different architecture, chosen for the TPU
// build's runtime: the consensus CORE is a pure, single-threaded,
// deterministic state machine (no threads, no clocks, no IO) behind a C ABI;
// the host (Python runtime, baikaldb_tpu/raft/) owns transport, timers and
// the applied-state storage, driving the core with tick()/receive() and
// draining (a) outbound messages, (b) committed entries, (c) snapshot
// events.  Determinism makes elections, partitions and crashes replayable
// in unit tests — the piece braft gets from real time and real sockets and
// therefore cannot test deterministically.
//
// Implemented: leader election with randomized timeouts (seeded PRNG),
// log replication with conflict fast-backtracking, commit via median match
// (current-term rule), leader no-op on election, log compaction + snapshot
// install for lagging followers, and single-server membership change
// (add/remove one peer per committed config entry).
//
// Message wire format (little-endian):
//   u8 type | u64 term | i64 from | i64 to | type-specific fields
// Entry wire format inside AppendEntries:
//   u64 term | u8 kind | u32 len | bytes
// Entry kinds: 0 = noop, 1 = data, 2 = config (payload = i64 count + ids).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <deque>
#include <map>
#include <string>
#include <vector>

namespace {

enum MsgType : uint8_t {
    MSG_VOTE_REQ = 1,
    MSG_VOTE_REPLY = 2,
    MSG_APPEND = 3,
    MSG_APPEND_REPLY = 4,
    MSG_SNAP = 5,
    MSG_SNAP_REPLY = 6,
    MSG_TIMEOUT_NOW = 7,   // leadership transfer: target elects immediately
};

enum Role : int { FOLLOWER = 0, CANDIDATE = 1, LEADER = 2 };
enum EntryKind : uint8_t { E_NOOP = 0, E_DATA = 1, E_CONFIG = 2 };

struct Entry {
    uint64_t term = 0;
    uint8_t kind = E_NOOP;
    std::string data;
};

struct Out {         // one outbound message
    int64_t dest;
    std::string bytes;
};

struct Commit {      // one committed entry handed to the host
    uint64_t index;
    uint8_t kind;
    std::string data;
};

// -- little-endian pack helpers --------------------------------------------
void put_u8(std::string* s, uint8_t v) { s->push_back((char)v); }
void put_u32(std::string* s, uint32_t v) { s->append((const char*)&v, 4); }
void put_u64(std::string* s, uint64_t v) { s->append((const char*)&v, 8); }
void put_i64(std::string* s, int64_t v) { s->append((const char*)&v, 8); }

struct Reader {
    const uint8_t* p;
    const uint8_t* end;
    bool ok = true;
    template <typename T> T get() {
        T v{};
        if (p + sizeof(T) > end) { ok = false; return v; }
        std::memcpy(&v, p, sizeof(T));
        p += sizeof(T);
        return v;
    }
    std::string bytes(size_t n) {
        if (p + n > end) { ok = false; return {}; }
        std::string s((const char*)p, n);
        p += n;
        return s;
    }
};

// xorshift PRNG — deterministic per (seed, node id)
struct Rng {
    uint64_t s;
    uint64_t next() {
        s ^= s << 13; s ^= s >> 7; s ^= s << 17;
        return s;
    }
};

struct RaftNode {
    // -- identity / config
    int64_t id;
    std::vector<int64_t> peers;       // ALL voting members incl self
    Rng rng;
    int election_min, election_max;   // ticks
    int hb_interval;                  // ticks

    // -- persistent-ish state (host persists via WAL of applied entries +
    //    the hard-state callbacks below)
    uint64_t term = 0;
    int64_t voted_for = -1;
    std::vector<Entry> log;           // log[i] = entry at index first_index+i
    uint64_t first_index = 1;         // index of log[0]
    uint64_t snap_index = 0;          // last index covered by snapshot
    uint64_t snap_term = 0;
    std::string snapshot;             // opaque host payload
    // membership as of first_index-1 (the snapshot point); the CURRENT
    // config is always base_peers replayed through the in-log E_CONFIG
    // entries, so truncating a conflicting suffix reverts memberships too
    std::vector<int64_t> base_peers;
    // LEARNERS: non-voting members (reference: learner replicas,
    // include/store/region.h:261-267).  They receive full log replication
    // and apply commits — read-serving replicas — but never count toward
    // quorum, never vote, and never start elections.
    std::vector<int64_t> learners;
    std::vector<int64_t> base_learners;

    // -- volatile state
    Role role = FOLLOWER;
    int64_t leader = -1;
    uint64_t commit_index = 0;
    uint64_t applied = 0;             // last index handed to host
    int ticks_since_reset = 0;
    int election_deadline = 0;
    int hb_elapsed = 0;
    std::map<int64_t, uint64_t> next_index, match_index;
    std::map<int64_t, bool> votes;

    std::deque<Out> outbox;
    std::deque<Commit> commits;

    RaftNode(int64_t id_, const int64_t* ps, int n, uint64_t seed,
             int emin, int emax, int hb)
        : id(id_), election_min(emin), election_max(emax), hb_interval(hb) {
        peers.assign(ps, ps + n);
        base_peers = peers;
        rng.s = seed * 0x9E3779B97F4A7C15ull + (uint64_t)id_ + 1;
        reset_election_deadline();
    }

    // -- log accessors ------------------------------------------------------
    uint64_t last_index() const { return first_index + log.size() - 1; }
    bool has(uint64_t idx) const {
        return idx >= first_index && idx <= last_index();
    }
    const Entry& at(uint64_t idx) const { return log[idx - first_index]; }
    uint64_t term_at(uint64_t idx) const {
        if (idx == 0) return 0;
        if (idx == snap_index) return snap_term;
        if (!has(idx)) return 0;
        return at(idx).term;
    }

    bool is_member(int64_t nid) const {
        return std::find(peers.begin(), peers.end(), nid) != peers.end();
    }
    bool is_learner(int64_t nid) const {
        return std::find(learners.begin(), learners.end(), nid)
            != learners.end();
    }
    size_t quorum() const { return peers.size() / 2 + 1; }

    std::vector<int64_t> repl_targets() const {
        // everyone the leader replicates to: voters + learners
        std::vector<int64_t> out = peers;
        for (int64_t l : learners)
            if (!is_member(l)) out.push_back(l);
        return out;
    }

    void reset_election_deadline() {
        ticks_since_reset = 0;
        election_deadline = election_min +
            (int)(rng.next() % (uint64_t)(election_max - election_min + 1));
    }

    // -- message builders ---------------------------------------------------
    std::string header(uint8_t type, int64_t to) {
        std::string m;
        put_u8(&m, type);
        put_u64(&m, term);
        put_i64(&m, id);
        put_i64(&m, to);
        return m;
    }
    void send(int64_t to, std::string msg) {
        outbox.push_back({to, std::move(msg)});
    }

    // -- role transitions ---------------------------------------------------
    void start_election() {
        role = CANDIDATE;
        term += 1;
        voted_for = id;
        leader = -1;
        votes.clear();
        votes[id] = true;
        reset_election_deadline();
        if (votes.size() >= quorum()) {  // single-node group
            become_leader();
            return;
        }
        for (int64_t p : peers) {
            if (p == id) continue;
            std::string m = header(MSG_VOTE_REQ, p);
            put_u64(&m, last_index());
            put_u64(&m, term_at(last_index()));
            send(p, std::move(m));
        }
    }

    void become_leader() {
        role = LEADER;
        leader = id;
        hb_elapsed = 0;
        next_index.clear();
        match_index.clear();
        for (int64_t p : repl_targets()) {
            next_index[p] = last_index() + 1;
            match_index[p] = 0;
        }
        match_index[id] = last_index();
        // commit-from-current-term rule: append a no-op so prior-term
        // entries commit promptly
        append_local(E_NOOP, "");
        broadcast_append();
    }

    bool uncommitted_config_pending() const {
        for (uint64_t i = std::max(commit_index + 1, first_index);
             i <= last_index(); i++)
            if (at(i).kind == E_CONFIG) return true;
        return false;
    }

    uint64_t append_local(uint8_t kind, std::string data) {
        Entry e;
        e.term = term;
        e.kind = kind;
        e.data = std::move(data);
        log.push_back(std::move(e));
        match_index[id] = last_index();
        return last_index();
    }

    // -- replication --------------------------------------------------------
    void broadcast_append() {
        for (int64_t p : repl_targets()) {
            if (p == id) continue;
            send_append(p);
        }
    }

    void send_append(int64_t p) {
        uint64_t ni = next_index.count(p) ? next_index[p] : last_index() + 1;
        if (ni < first_index) {  // follower needs compacted entries: snapshot
            std::string m = header(MSG_SNAP, p);
            put_u64(&m, snap_index);
            put_u64(&m, snap_term);
            // membership as of the snapshot point rides along, so the
            // receiver's recompute base stays correct after log reset
            put_u32(&m, (uint32_t)base_peers.size());
            for (int64_t bp : base_peers) put_i64(&m, bp);
            put_u32(&m, (uint32_t)base_learners.size());
            for (int64_t bl : base_learners) put_i64(&m, bl);
            put_u64(&m, (uint64_t)snapshot.size());
            m += snapshot;
            send(p, std::move(m));
            return;
        }
        std::string m = header(MSG_APPEND, p);
        uint64_t prev = ni - 1;
        put_u64(&m, prev);
        put_u64(&m, term_at(prev));
        put_u64(&m, commit_index);
        uint32_t n = 0;
        std::string body;
        const uint32_t MAX_BATCH = 256;
        for (uint64_t i = ni; i <= last_index() && n < MAX_BATCH; i++, n++) {
            const Entry& e = at(i);
            put_u64(&body, e.term);
            put_u8(&body, e.kind);
            put_u32(&body, (uint32_t)e.data.size());
            body += e.data;
        }
        put_u32(&m, n);
        m += body;
        send(p, std::move(m));
    }

    void advance_commit() {
        if (role != LEADER) return;
        std::vector<uint64_t> ms;
        for (int64_t p : peers)
            ms.push_back(match_index.count(p) ? match_index[p] : 0);
        std::sort(ms.begin(), ms.end());
        uint64_t majority = ms[ms.size() - quorum()];
        if (majority > commit_index && term_at(majority) == term) {
            commit_index = majority;
            emit_commits();
            broadcast_append();   // propagate the new commit index promptly
        }
    }

    void emit_commits() {
        // configs already applied at append/propose time; here entries only
        // stream out to the host in commit order
        while (applied < commit_index) {
            uint64_t i = applied + 1;
            if (!has(i)) break;   // inside snapshot: host already has it
            const Entry& e = at(i);
            commits.push_back({i, e.kind, e.data});
            applied = i;
        }
    }

    static void apply_config_to(std::vector<int64_t>* ps,
                                std::vector<int64_t>* ls,
                                const std::string& data) {
        // payload: u8 op (0=add voter, 1=remove voter, 2=add learner,
        // 3=remove learner) + i64 id.  Adding a learner as a voter
        // PROMOTES it (erased from learners); a voter is never added as a
        // learner.
        if (data.size() < 9) return;
        uint8_t op = (uint8_t)data[0];
        int64_t nid;
        std::memcpy(&nid, data.data() + 1, 8);
        auto in = [](std::vector<int64_t>* v, int64_t x) {
            return std::find(v->begin(), v->end(), x) != v->end();
        };
        auto drop = [](std::vector<int64_t>* v, int64_t x) {
            v->erase(std::remove(v->begin(), v->end(), x), v->end());
        };
        if (op == 0) {
            if (!in(ps, nid)) ps->push_back(nid);
            drop(ls, nid);
        } else if (op == 1) {
            drop(ps, nid);
        } else if (op == 2) {
            if (!in(ps, nid) && !in(ls, nid)) ls->push_back(nid);
        } else if (op == 3) {
            drop(ls, nid);
        }
    }

    void apply_config(const std::string& data) {
        std::vector<int64_t> before = repl_targets();
        apply_config_to(&peers, &learners, data);
        for (int64_t p : repl_targets()) {
            if (role == LEADER && !next_index.count(p)) {
                next_index[p] = last_index() + 1;
                match_index[p] = 0;
            }
        }
        for (int64_t p : before) {
            if (!is_member(p) && !is_learner(p)) {
                next_index.erase(p);
                match_index.erase(p);
            }
        }
    }

    void recompute_config() {
        // CURRENT config = base (snapshot-point) config replayed through
        // every E_CONFIG entry still in the log; called after any suffix
        // truncation so reverted membership changes actually revert
        std::vector<int64_t> ps = base_peers;
        std::vector<int64_t> ls = base_learners;
        for (const Entry& e : log)
            if (e.kind == E_CONFIG) apply_config_to(&ps, &ls, e.data);
        peers = ps;
        learners = ls;
        auto keep = [this](int64_t n) {
            return is_member(n) || is_learner(n);
        };
        for (auto it = next_index.begin(); it != next_index.end();)
            it = keep(it->first) ? std::next(it) : next_index.erase(it);
        for (auto it = match_index.begin(); it != match_index.end();)
            it = keep(it->first) ? std::next(it) : match_index.erase(it);
    }

    // -- input: tick --------------------------------------------------------
    void tick() {
        if (role == LEADER) {
            hb_elapsed++;
            if (hb_elapsed >= hb_interval) {
                hb_elapsed = 0;
                broadcast_append();
            }
            return;
        }
        ticks_since_reset++;
        if (ticks_since_reset >= election_deadline && is_member(id))
            start_election();
    }

    // -- input: message -----------------------------------------------------
    void receive(Reader* r) {
        uint8_t type = r->get<uint8_t>();
        uint64_t mterm = r->get<uint64_t>();
        int64_t from = r->get<int64_t>();
        r->get<int64_t>();   // to (us)
        if (!r->ok) return;

        if (mterm > term) {
            term = mterm;
            voted_for = -1;
            if (role != FOLLOWER) role = FOLLOWER;
            leader = -1;
        }

        switch (type) {
        case MSG_VOTE_REQ: {
            uint64_t cand_last = r->get<uint64_t>();
            uint64_t cand_last_term = r->get<uint64_t>();
            bool grant = false;
            if (r->ok && mterm >= term) {
                bool up_to_date =
                    cand_last_term > term_at(last_index()) ||
                    (cand_last_term == term_at(last_index()) &&
                     cand_last >= last_index());
                if ((voted_for == -1 || voted_for == from) && up_to_date) {
                    grant = true;
                    voted_for = from;
                    reset_election_deadline();
                }
            }
            std::string m = header(MSG_VOTE_REPLY, from);
            put_u8(&m, grant ? 1 : 0);
            send(from, std::move(m));
            break;
        }
        case MSG_VOTE_REPLY: {
            uint8_t granted = r->get<uint8_t>();
            if (!r->ok || role != CANDIDATE || mterm != term) break;
            if (granted) {
                votes[from] = true;
                size_t n = 0;
                for (auto& kv : votes) if (kv.second && is_member(kv.first)) n++;
                if (n >= quorum()) become_leader();
            }
            break;
        }
        case MSG_APPEND: {
            uint64_t prev = r->get<uint64_t>();
            uint64_t prev_term = r->get<uint64_t>();
            uint64_t leader_commit = r->get<uint64_t>();
            uint32_t n = r->get<uint32_t>();
            if (!r->ok) break;
            if (mterm < term) {
                std::string m = header(MSG_APPEND_REPLY, from);
                put_u8(&m, 0);
                put_u64(&m, last_index());
                send(from, std::move(m));
                break;
            }
            role = FOLLOWER;
            leader = from;
            reset_election_deadline();
            bool ok_prev = prev == 0 || prev == snap_index
                ? (prev == 0 || term_at(prev) == prev_term)
                : (has(prev) && term_at(prev) == prev_term);
            if (prev > last_index()) ok_prev = false;
            if (!ok_prev) {
                std::string m = header(MSG_APPEND_REPLY, from);
                put_u8(&m, 0);
                // fast backtrack hint: our last index (leader jumps there)
                put_u64(&m, std::min(last_index(), prev > 0 ? prev - 1 : 0));
                send(from, std::move(m));
                break;
            }
            uint64_t idx = prev;
            for (uint32_t k = 0; k < n; k++) {
                uint64_t eterm = r->get<uint64_t>();
                uint8_t kind = r->get<uint8_t>();
                uint32_t len = r->get<uint32_t>();
                std::string data = r->bytes(len);
                if (!r->ok) return;
                idx++;
                if (has(idx) && term_at(idx) != eterm) {
                    // conflict: truncate suffix, reverting any membership
                    // changes the removed entries carried
                    bool had_config = false;
                    for (uint64_t j = idx; j <= last_index(); j++)
                        if (at(j).kind == E_CONFIG) had_config = true;
                    log.resize(idx - first_index);
                    if (had_config) recompute_config();
                }
                if (idx > last_index()) {
                    Entry e;
                    e.term = eterm;
                    e.kind = kind;
                    e.data = std::move(data);
                    log.push_back(std::move(e));
                    if (kind == E_CONFIG) apply_config(log.back().data);
                }
            }
            if (leader_commit > commit_index) {
                commit_index = std::min(leader_commit, last_index());
                emit_commits();
            }
            std::string m = header(MSG_APPEND_REPLY, from);
            put_u8(&m, 1);
            put_u64(&m, idx);
            send(from, std::move(m));
            break;
        }
        case MSG_APPEND_REPLY: {
            uint8_t success = r->get<uint8_t>();
            uint64_t idx = r->get<uint64_t>();
            // a reply from a PRIOR term may describe entries the follower
            // has since truncated: ignore anything not from our term
            if (!r->ok || role != LEADER || mterm != term) break;
            if (success) {
                match_index[from] = std::max(match_index[from], idx);
                next_index[from] = match_index[from] + 1;
                advance_commit();
                if (next_index[from] <= last_index()) send_append(from);
            } else {
                uint64_t ni = next_index.count(from) ? next_index[from] : 1;
                next_index[from] = std::max<uint64_t>(1,
                    std::min<uint64_t>(idx + 1, ni > 1 ? ni - 1 : 1));
                send_append(from);
            }
            break;
        }
        case MSG_SNAP: {
            uint64_t sidx = r->get<uint64_t>();
            uint64_t sterm = r->get<uint64_t>();
            uint32_t np = r->get<uint32_t>();
            std::vector<int64_t> snap_peers;
            for (uint32_t k = 0; k < np && r->ok; k++)
                snap_peers.push_back(r->get<int64_t>());
            uint32_t nl = r->get<uint32_t>();
            std::vector<int64_t> snap_learners;
            for (uint32_t k = 0; k < nl && r->ok; k++)
                snap_learners.push_back(r->get<int64_t>());
            uint64_t len = r->get<uint64_t>();
            std::string data = r->bytes(len);
            if (!r->ok || mterm < term) break;
            role = FOLLOWER;
            leader = from;
            reset_election_deadline();
            if (sidx > commit_index) {
                snap_index = sidx;
                snap_term = sterm;
                snapshot = data;
                log.clear();
                first_index = sidx + 1;
                commit_index = sidx;
                applied = sidx;
                base_peers = snap_peers;
                peers = snap_peers;
                base_learners = snap_learners;
                learners = snap_learners;
                // host must install: surface as a special commit record
                commits.push_back({sidx, 255, std::move(data)});
            }
            std::string m = header(MSG_SNAP_REPLY, from);
            put_u64(&m, sidx);
            send(from, std::move(m));
            break;
        }
        case MSG_TIMEOUT_NOW: {
            // TimeoutNow (leadership transfer, braft transfer_leadership
            // analog): start an election at once, bypassing the deadline.
            // A stale transfer from a deposed leader must not depose the
            // current one: only honor transfers from the CURRENT term.
            if (r->ok && mterm == term && is_member(id) && role != LEADER)
                start_election();
            break;
        }
        case MSG_SNAP_REPLY: {
            uint64_t sidx = r->get<uint64_t>();
            if (!r->ok || role != LEADER || mterm != term) break;
            match_index[from] = std::max(match_index[from], sidx);
            next_index[from] = match_index[from] + 1;
            if (next_index[from] <= last_index()) send_append(from);
            break;
        }
        default:
            break;
        }
    }

    // -- host API -----------------------------------------------------------
    int64_t propose(uint8_t kind, const uint8_t* data, int64_t len) {
        if (role != LEADER) return -1;
        // one membership change at a time (quorum-overlap guarantee of the
        // single-server change rule)
        if (kind == E_CONFIG && uncommitted_config_pending()) return -2;
        uint64_t idx = append_local(kind,
                                    std::string((const char*)data, len));
        if (kind == E_CONFIG) apply_config(at(idx).data);
        broadcast_append();
        advance_commit();   // single-node group commits immediately
        return (int64_t)idx;
    }

    int transfer_leader(int64_t target) {
        if (role != LEADER || !is_member(target) || target == id) return -1;
        // bring the target fully up to date first, then TimeoutNow
        send_append(target);
        send(target, header(MSG_TIMEOUT_NOW, target));
        return 0;
    }

    void compact(uint64_t upto, const uint8_t* snap, int64_t len) {
        if (upto > commit_index) upto = commit_index;
        if (upto < first_index) return;
        snap_term = term_at(upto);
        snap_index = upto;
        snapshot.assign((const char*)snap, len);
        // roll the config base forward through the entries being dropped
        for (uint64_t i = first_index; i <= upto; i++)
            if (at(i).kind == E_CONFIG)
                apply_config_to(&base_peers, &base_learners, at(i).data);
        log.erase(log.begin(), log.begin() + (upto - first_index + 1));
        first_index = upto + 1;
    }
};

}  // namespace

// ---------------------------------------------------------------------------
// C ABI

extern "C" {

void* rf_new(int64_t id, const int64_t* peers, int n, uint64_t seed,
             int election_min, int election_max, int hb_interval) {
    return new RaftNode(id, peers, n, seed, election_min, election_max,
                        hb_interval);
}

void rf_free(void* h) { delete (RaftNode*)h; }

void rf_tick(void* h) { ((RaftNode*)h)->tick(); }

void rf_receive(void* h, const uint8_t* msg, int64_t len) {
    Reader r{msg, msg + len};
    ((RaftNode*)h)->receive(&r);
}

// kind: 0=noop 1=data 2=config; returns index, -1 not leader, -2 config busy
int64_t rf_propose(void* h, uint8_t kind, const uint8_t* data, int64_t len) {
    return ((RaftNode*)h)->propose(kind, data, len);
}

int rf_role(void* h) { return ((RaftNode*)h)->role; }
// Read barrier (Raft §8): a fresh leader may not apply entries committed
// under the old term until its own election no-op commits; leaders must
// not serve reads before then or failover loses acknowledged writes.
int rf_committed_current_term(void* h) {
    RaftNode* n = (RaftNode*)h;
    return (n->commit_index > 0 &&
            n->term_at(n->commit_index) == n->term) ? 1 : 0;
}
uint64_t rf_term(void* h) { return ((RaftNode*)h)->term; }
int64_t rf_leader(void* h) { return ((RaftNode*)h)->leader; }
uint64_t rf_commit_index(void* h) { return ((RaftNode*)h)->commit_index; }
uint64_t rf_last_index(void* h) { return ((RaftNode*)h)->last_index(); }
uint64_t rf_first_index(void* h) { return ((RaftNode*)h)->first_index; }

int rf_peer_count(void* h) { return (int)((RaftNode*)h)->peers.size(); }
void rf_peers(void* h, int64_t* out) {
    auto& p = ((RaftNode*)h)->peers;
    std::copy(p.begin(), p.end(), out);
}
int rf_learner_count(void* h) {
    return (int)((RaftNode*)h)->learners.size();
}
void rf_learners(void* h, int64_t* out) {
    auto& l = ((RaftNode*)h)->learners;
    std::copy(l.begin(), l.end(), out);
}

// outbound messages
int64_t rf_out_count(void* h) { return (int64_t)((RaftNode*)h)->outbox.size(); }
int64_t rf_out_dest(void* h, int64_t i) { return ((RaftNode*)h)->outbox[i].dest; }
int64_t rf_out_size(void* h, int64_t i) {
    return (int64_t)((RaftNode*)h)->outbox[i].bytes.size();
}
void rf_out_copy(void* h, int64_t i, uint8_t* buf) {
    auto& b = ((RaftNode*)h)->outbox[i].bytes;
    std::memcpy(buf, b.data(), b.size());
}
void rf_out_clear(void* h) { ((RaftNode*)h)->outbox.clear(); }

// committed entries (kind 255 = snapshot-install event)
int64_t rf_commit_count(void* h) {
    return (int64_t)((RaftNode*)h)->commits.size();
}
uint64_t rf_commit_index_at(void* h, int64_t i) {
    return ((RaftNode*)h)->commits[i].index;
}
int rf_commit_kind(void* h, int64_t i) {
    return ((RaftNode*)h)->commits[i].kind;
}
int64_t rf_commit_size(void* h, int64_t i) {
    return (int64_t)((RaftNode*)h)->commits[i].data.size();
}
void rf_commit_copy(void* h, int64_t i, uint8_t* buf) {
    auto& d = ((RaftNode*)h)->commits[i].data;
    std::memcpy(buf, d.data(), d.size());
}
void rf_commit_clear(void* h) { ((RaftNode*)h)->commits.clear(); }

// snapshot/compaction
void rf_compact(void* h, uint64_t upto, const uint8_t* snap, int64_t len) {
    ((RaftNode*)h)->compact(upto, snap, len);
}

// leadership transfer (returns 0 if initiated)
int rf_transfer(void* h, int64_t target) {
    return ((RaftNode*)h)->transfer_leader(target);
}

}  // extern "C"
