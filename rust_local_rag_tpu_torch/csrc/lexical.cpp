// Native BM25 inverted index of the port. Built with g++ by
// rust_local_rag_tpu_torch/kernels/build.py and reached through the C ABI
// by rust_local_rag_tpu_torch/ops/native_bm25.py. (The reference's
// LexicalIndex is native Rust, rag_engine.rs:2083-2237.) It answers as the
// JAX package's native/lexical.cpp does, ties included, over its own
// posting layout and write path:
//
//   * terms are interned once (term -> int32 id); each term keeps an
//     append-only vector of (slot, tf) postings in ascending slot order
//     and its live-posting count (df), and a document keeps the ids of its
//     terms, not copies of their strings;
//   * bm25_add_batch indexes many documents in one call: a text flagged
//     ASCII is tokenised here (for ASCII the byte rule below equals
//     ops/bm25.tokenize), any other arrives tokenised by the Python side.
//
// Semantics match ops/bm25.py: tokens are lowercased alphanumeric runs with
// UTF-8 byte length >= 3; BM25 k1=1.5 b=0.75; idf = max(ln((N-df+.5)/(df+.5)), 0).
// Pre-tokenised text ('\x01'-joined UTF-8 tokens, no further filtering)
// goes through bm25_add_batch's flag and bm25_score_tokens; the byte-level
// tokeniser (non-ASCII bytes treated as letters) serves ASCII text only,
// where the two rules agree.
//
// Concurrency: an Index is NOT safe for concurrent calls, scoring included.
// score_tokens writes the index's shared scratch (acc, epoch, touched) and
// builds posting snapshots lazily, so two scores at once corrupt each
// other. The wrapper (NativeLexicalIndex) serialises every call on a
// handle with a lock.

#include <algorithm>
#include <cctype>
#include <cstdint>
#include <cstring>
#include <cmath>
#include <memory>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

// Slots below this bound use flat arrays (ChunkStore slab slots are dense
// from 0); the rare auto-allocated legacy slots (>= 2^40 on the Python
// side) fall back to hash maps.
constexpr int64_t DENSE_LIMIT = 1LL << 26;

inline bool is_dense(int64_t slot) { return slot >= 0 && slot < DENSE_LIMIT; }

// Read-optimized per-term posting snapshot: contiguous (slot asc, tf)
// arrays of the live postings, built lazily on first use in a query.
// Contiguous ascending-slot walks turn the scorer's memory pattern from a
// pointer-chase into prefetchable sweeps.
struct Compiled {
    std::vector<int32_t> slots;  // ascending
    // tf*(k1+1) / (tf + k1*(1-b + b*dl/avgdl)) — the full per-posting BM25
    // factor except idf, precomputed at snapshot time. Valid for the
    // avgdl frozen at `version`; any index mutation bumps the global
    // version and stales EVERY snapshot (avgdl is global).
    std::vector<float> contrib;
    int64_t version = -1;
};

struct Posting {
    int32_t slot;
    int32_t tf;  // 0: removed, dropped at the next compaction
};

struct Term {
    // dense slots, ascending: appends while slots arrive in order (a
    // reindex), a binary-searched insert or revival otherwise
    std::vector<Posting> posts;
    int64_t df = 0;    // live postings, dense and legacy
    int64_t dead = 0;  // removed postings still in `posts`
    // legacy slots (outside [0, DENSE_LIMIT)): slot -> tf, created on the
    // first such posting and dropped when it empties
    std::unique_ptr<std::unordered_map<int64_t, int32_t>> legacy;
    Compiled compiled;

    void add(int32_t slot, int32_t tf) {
        df++;
        if (posts.empty() || posts.back().slot < slot) {
            posts.push_back(Posting{slot, tf});
            return;
        }
        auto it = std::lower_bound(
            posts.begin(), posts.end(), slot,
            [](const Posting& p, int32_t s) { return p.slot < s; });
        if (it != posts.end() && it->slot == slot) {  // a removed posting
            it->tf = tf;
            dead--;
        } else {
            posts.insert(it, Posting{slot, tf});
        }
    }

    void remove(int32_t slot) {
        auto it = std::lower_bound(
            posts.begin(), posts.end(), slot,
            [](const Posting& p, int32_t s) { return p.slot < s; });
        if (it == posts.end() || it->slot != slot || it->tf == 0) return;
        it->tf = 0;
        df--;
        dead++;
        if (df == 0) {
            clear();
        } else if (dead > 16 && 2 * dead > (int64_t)posts.size()) {
            // removed postings outnumber live ones: compact (amortised
            // O(1) a removal)
            posts.erase(std::remove_if(posts.begin(), posts.end(),
                                       [](const Posting& p) { return p.tf == 0; }),
                        posts.end());
            dead = 0;
        }
    }

    void add_legacy(int64_t slot, int32_t tf) {
        if (!legacy) legacy.reset(new std::unordered_map<int64_t, int32_t>());
        (*legacy)[slot] = tf;
        df++;
    }

    void remove_legacy(int64_t slot) {
        if (!legacy || !legacy->erase(slot)) return;
        df--;
        // an emptied map is dropped, so the next one starts fresh (its
        // iteration order, which orders tied legacy hits, then matches
        // a map built anew)
        if (legacy->empty()) legacy.reset();
        if (df == 0) clear();
    }

    // the last posting went: free the vectors
    void clear() {
        std::vector<Posting>().swap(posts);
        dead = 0;
        compiled = Compiled();
    }

    bool has_dense() const { return df > (legacy ? (int64_t)legacy->size() : 0); }
};

// Term -> id, interned once: open addressing with linear probing over a
// power-of-two table kept at most half full. A cell holds the term's hash,
// id and length and, for terms of up to 16 bytes (nearly all), the bytes
// themselves, so a lookup reads one cache line; longer terms compare
// against the arena of every term's bytes.
class Interner {
  public:
    Interner() : cells_(1 << 16), mask_((1 << 16) - 1) { starts_.push_back(0); }

    int32_t size() const { return (int32_t)(starts_.size() - 1); }

    // the id of `t`, or -1
    int32_t find(const std::string& t) const {
        const uint64_t h = hash(t);
        for (size_t i = h & mask_;; i = (i + 1) & mask_) {
            const Cell& c = cells_[i];
            if (c.id < 0) return -1;
            if (c.h == h && same(c, t)) return c.id;
        }
    }

    // the id of `t`, a new one (size() before the call) if it had none
    int32_t intern(const std::string& t) {
        const uint64_t h = hash(t);
        size_t i = h & mask_;
        for (;; i = (i + 1) & mask_) {
            const Cell& c = cells_[i];
            if (c.id < 0) break;
            if (c.h == h && same(c, t)) return c.id;
        }
        const int32_t id = size();
        text_.append(t);
        starts_.push_back((int64_t)text_.size());
        Cell& c = cells_[i];
        c.h = h;
        c.id = id;
        c.len = (uint32_t)t.size();
        std::memcpy(c.key, t.data(), std::min(t.size(), sizeof c.key));
        if (2 * (size_t)(id + 1) > cells_.size()) grow();
        return id;
    }

  private:
    struct Cell {
        uint64_t h = 0;
        int32_t id = -1;  // -1: empty
        uint32_t len = 0;
        char key[16];
    };

    static uint64_t hash(const std::string& t) {  // FNV-1a, then a mix
        uint64_t h = 1469598103934665603ULL;
        for (unsigned char c : t) {
            h ^= c;
            h *= 1099511628211ULL;
        }
        return h ^ (h >> 29);
    }

    bool same(const Cell& c, const std::string& t) const {
        if (c.len != t.size()) return false;
        if (t.size() <= sizeof c.key) return std::memcmp(c.key, t.data(), t.size()) == 0;
        return text_.compare((size_t)starts_[(size_t)c.id], t.size(), t) == 0;
    }

    void grow() {
        std::vector<Cell> old(cells_.size() * 2);
        old.swap(cells_);
        mask_ = cells_.size() - 1;
        for (const Cell& c : old) {
            if (c.id < 0) continue;
            size_t i = c.h & mask_;
            while (cells_[i].id >= 0) i = (i + 1) & mask_;
            cells_[i] = c;
        }
    }

    std::vector<Cell> cells_;
    size_t mask_;
    std::string text_;             // every term's bytes, by id
    std::vector<int64_t> starts_;  // term id's bytes start at starts_[id]
};

// accumulator cell: value + visited-epoch share one 8-byte line so each
// posting's random access touches ONE cache line
struct Acc {
    float v;
    int32_t stamp;
};

struct Index {
    Interner term_ids;
    std::vector<Term> terms;  // by term id; a term is never un-interned
    // dense slot -> the ids of its document's unique terms (empty: no
    // document there) and its length
    std::vector<std::vector<int32_t>> doc_terms;
    std::vector<int32_t> dl_dense;
    // legacy slots: the same, in maps
    std::unordered_map<int64_t, std::vector<int32_t>> legacy_terms;
    std::unordered_map<int64_t, int64_t> legacy_lengths;
    int64_t total_docs = 0;
    int64_t total_length = 0;
    int64_t version = 0;  // bumped on every mutation (stales snapshots)
    // scoring scratch (persistent across queries): `stamp`/`epoch` dedupe
    // the touched list (zero contributions are legal, so the accumulator
    // value cannot double as the visited flag)
    std::vector<Acc> acc;
    int32_t epoch = 0;
    std::vector<int64_t> touched;
    // adding scratch: a document's token ids, its unique ones, their
    // counts by term id (zero between documents), the token being read
    std::vector<int32_t> ids;
    std::vector<int32_t> uniq;
    std::vector<int32_t> tf;
    std::string cur;

    int32_t intern(const std::string& t) {
        const int32_t id = term_ids.intern(t);
        if (id == (int32_t)terms.size()) {
            terms.emplace_back();
            tf.push_back(0);
        }
        return id;
    }

    // the live term `t`, or null
    Term* find(const std::string& t) {
        const int32_t id = term_ids.find(t);
        if (id < 0 || terms[(size_t)id].df == 0) return nullptr;
        return &terms[(size_t)id];
    }

    bool contains(int64_t slot) const {
        if (is_dense(slot))
            return slot < (int64_t)doc_terms.size() &&
                   !doc_terms[(size_t)slot].empty();
        return legacy_terms.count(slot) != 0;
    }

    void grow_dense(int64_t slot) {
        if ((int64_t)dl_dense.size() <= slot) {
            dl_dense.resize((size_t)(slot + 1024), 0);
            doc_terms.resize(dl_dense.size());
        }
    }
};

// Calls emit(token) for each token of ASCII text: lowercased alphanumeric
// runs of >= 3 bytes (bytes >= 0x80 count as letters).
template <class Emit>
void scan_ascii(const char* text, size_t len, std::string& cur, Emit emit) {
    cur.clear();
    for (size_t i = 0; i < len; i++) {
        unsigned char c = (unsigned char)text[i];
        if (std::isalnum(c) || c >= 0x80) {
            cur.push_back((char)std::tolower(c));
        } else if (!cur.empty()) {
            if (cur.size() >= 3) emit(cur);
            cur.clear();
        }
    }
    if (cur.size() >= 3) emit(cur);
}

// Calls emit(token) for each token of pre-tokenised text: tokens joined
// by '\x01'. No filtering — the caller (Python wrapper) already applied
// the Unicode-aware tokenization rules.
template <class Emit>
void scan_pretokenized(const char* text, size_t len, std::string& cur, Emit emit) {
    cur.clear();
    for (size_t i = 0; i < len; i++) {
        char c = text[i];
        if (c == '\x01') {
            if (!cur.empty()) { emit(cur); cur.clear(); }
        } else {
            cur.push_back(c);
        }
    }
    if (!cur.empty()) emit(cur);
}

void tokenize(const char* text, size_t len, std::vector<std::string>& out) {
    std::string cur;
    scan_ascii(text, len, cur, [&](const std::string& t) { out.push_back(t); });
}

void split_pretokenized(const char* text, size_t len,
                        std::vector<std::string>& out) {
    std::string cur;
    scan_pretokenized(text, len, cur, [&](const std::string& t) { out.push_back(t); });
}

void remove_slot(Index* idx, int64_t slot);

// Index the document whose token ids are idx->ids at `slot`, replacing the
// one there.
void add_ids(Index* idx, int64_t slot) {
    if (idx->contains(slot)) remove_slot(idx, slot);
    const std::vector<int32_t>& ids = idx->ids;
    if (ids.empty()) return;

    std::vector<int32_t>& uniq = idx->uniq;
    int32_t* tf = idx->tf.data();
    uniq.clear();
    for (int32_t id : ids)
        if (tf[id]++ == 0) uniq.push_back(id);
    const bool dense = is_dense(slot);
    for (int32_t id : uniq) {
        if (dense)
            idx->terms[(size_t)id].add((int32_t)slot, tf[id]);
        else
            idx->terms[(size_t)id].add_legacy(slot, tf[id]);
        tf[id] = 0;
    }
    const int64_t doc_length = (int64_t)ids.size();
    idx->version++;  // stales every snapshot (avgdl changed)
    if (dense) {
        idx->grow_dense(slot);
        idx->dl_dense[(size_t)slot] = (int32_t)doc_length;
        idx->doc_terms[(size_t)slot] = uniq;
    } else {
        idx->legacy_lengths[slot] = doc_length;
        idx->legacy_terms[slot] = uniq;
    }
    idx->total_docs++;
    idx->total_length += doc_length;
}

// The term's snapshot, (re)built when a mutation staled it.
const Compiled& compiled(Index* idx, Term& t) {
    Compiled& c = t.compiled;
    if (c.version == idx->version) return c;
    const double k1 = 1.5, b = 0.75;
    const double avg_dl = (double)idx->total_length / (double)idx->total_docs;
    const double kb = k1 * b / avg_dl;
    const double k1b = k1 * (1.0 - b);
    const size_t live = t.posts.size() - (size_t)t.dead;
    c.slots.clear();
    c.contrib.clear();
    c.slots.reserve(live);
    c.contrib.reserve(live);
    for (const Posting& p : t.posts) {
        if (p.tf == 0) continue;
        double dl = (double)idx->dl_dense[(size_t)p.slot];
        double tf = (double)p.tf;
        double denom = tf + k1b + kb * dl;
        c.slots.push_back(p.slot);
        c.contrib.push_back(dl > 0.0 && denom != 0.0
                                ? (float)(tf * (k1 + 1.0) / denom)
                                : 0.0f);
    }
    c.version = idx->version;
    return c;
}

// Exact BM25 top-`limit`, optimized for large corpora (the original
// per-posting hash lookups + full result sort cost ~0.4 s/query at 1.25M
// docs with mid-frequency terms):
//   * terms with df >= N/2 have idf = max(ln((N-df+.5)/(df+.5)), 0) == 0
//     and are skipped WITHOUT walking their postings — exact, since their
//     contribution is identically zero under the reference formula
//     (rag_engine.rs:2197-2199 clamps idf at 0);
//   * scores accumulate into a persistent flat f32 array indexed by slot
//     (one array read + FMA per posting; doc lengths read the same way),
//     with the touched set tracked for O(touched) reset;
//   * selection is nth_element + sort over the top instead of sorting
//     every touched doc.
// Slots >= DENSE_LIMIT (legacy auto-allocated ids) take a map fallback.
int64_t score_tokens(Index* idx, std::vector<std::string>& tokens,
                     int64_t limit, int64_t* out_slots, float* out_scores) {
    if (idx->total_docs == 0 || limit <= 0 || tokens.empty()) return 0;
    std::sort(tokens.begin(), tokens.end());
    tokens.erase(std::unique(tokens.begin(), tokens.end()), tokens.end());

    const double k1 = 1.5, b = 0.75;
    const double avg_dl = (double)idx->total_length / (double)idx->total_docs;
    const double n_docs = (double)idx->total_docs;

    if (idx->acc.size() < idx->dl_dense.size())
        idx->acc.resize(idx->dl_dense.size(), Acc{0.0f, 0});
    if (idx->epoch == INT32_MAX) {  // wrap: invalidate all stamps
        for (auto& a : idx->acc) a.stamp = 0;
        idx->epoch = 0;
    }
    idx->epoch++;
    const int32_t epoch = idx->epoch;
    std::vector<int64_t>& touched = idx->touched;
    touched.clear();
    std::unordered_map<int64_t, double> overflow;  // slots >= DENSE_LIMIT

    for (const auto& token : tokens) {
        Term* term = idx->find(token);
        if (term == nullptr) continue;
        double df = (double)term->df;
        double idf = std::log((n_docs - df + 0.5) / (df + 0.5));
        // exact skip for LARGE zero-idf lists (clamped contribution is 0);
        // small corpora keep the walk so docs matching only ubiquitous
        // terms still appear in the raw list (mirrors ops/bm25.py)
        if (idf <= 0.0 && df >= 1024.0) continue;
        if (idf < 0.0) idf = 0.0;
        const float fidf = (float)idf;

        if (term->has_dense()) {
            const Compiled& c = compiled(idx, *term);
            const size_t m = c.slots.size();
            Acc* acc = idx->acc.data();
            const int32_t* sl = c.slots.data();
            const float* co = c.contrib.data();
            for (size_t i = 0; i < m; i++) {
                int32_t slot = sl[i];
                Acc& a = acc[slot];
                float add = fidf * co[i];
                if (a.stamp != epoch) {
                    a.stamp = epoch;
                    a.v = add;
                    touched.push_back(slot);
                } else {
                    a.v += add;
                }
            }
        }
        if (!term->legacy) continue;

        // legacy slots beyond DENSE_LIMIT: hash-map walk
        const double kb = k1 * b / avg_dl;
        const double k1b = k1 * (1.0 - b);
        for (const auto& kv : *term->legacy) {
            int64_t slot = kv.first;
            double tf = (double)kv.second;
            auto lit = idx->legacy_lengths.find(slot);
            if (lit == idx->legacy_lengths.end() || lit->second == 0)
                continue;
            double denom = tf + k1b + kb * (double)lit->second;
            overflow[slot] += idf * tf * (k1 + 1.0) / denom;
        }
    }

    std::vector<std::pair<float, int64_t>> rows;
    rows.reserve(touched.size() + overflow.size());
    for (int64_t slot : touched)
        rows.emplace_back(idx->acc[(size_t)slot].v, slot);
    for (const auto& kv : overflow)
        rows.emplace_back((float)kv.second, kv.first);

    int64_t n = std::min<int64_t>(limit, (int64_t)rows.size());
    if (n <= 0) return 0;
    std::nth_element(rows.begin(), rows.begin() + n, rows.end(),
                     [](const auto& a, const auto& b) {
                         return a.first > b.first;
                     });
    std::sort(rows.begin(), rows.begin() + n,
              [](const auto& a, const auto& b) { return a.first > b.first; });
    for (int64_t i = 0; i < n; i++) {
        out_slots[i] = rows[i].second;
        out_scores[i] = rows[i].first;
    }
    return n;
}

void remove_slot(Index* idx, int64_t slot) {
    idx->version++;  // stales every snapshot (avgdl changed)
    int64_t length = -1;
    if (is_dense(slot)) {
        if (idx->contains(slot)) {
            std::vector<int32_t>& ids = idx->doc_terms[(size_t)slot];
            for (int32_t id : ids) idx->terms[(size_t)id].remove((int32_t)slot);
            std::vector<int32_t>().swap(ids);
            length = idx->dl_dense[(size_t)slot];
        }
        if (slot < (int64_t)idx->dl_dense.size())
            idx->dl_dense[(size_t)slot] = 0;
    } else {
        auto it = idx->legacy_terms.find(slot);
        if (it != idx->legacy_terms.end()) {
            for (int32_t id : it->second) idx->terms[(size_t)id].remove_legacy(slot);
            idx->legacy_terms.erase(it);
            length = idx->legacy_lengths[slot];
        }
        idx->legacy_lengths.erase(slot);
    }
    if (length >= 0) {
        idx->total_length = std::max<int64_t>(0, idx->total_length - length);
        if (idx->total_docs > 0) idx->total_docs--;
    }
    if (idx->total_docs == 0) idx->total_length = 0;
}

}  // namespace

extern "C" {

void* bm25_create() { return new Index(); }

void bm25_destroy(void* h) { delete (Index*)h; }

// Index n documents, one call: document i is buf[offsets[i], offsets[i+1])
// at slots[i], replacing the one there; ASCII text tokenised here, or,
// where pretokenized[i] is set, '\x01'-joined tokens. indexed_out[i] says
// whether document i produced tokens (a document without is not indexed,
// and leaves its slot empty).
void bm25_add_batch(void* h, const int64_t* slots, const char* buf,
                    const int64_t* offsets, const uint8_t* pretokenized,
                    int64_t n, uint8_t* indexed_out) {
    Index* idx = (Index*)h;
    auto push = [idx](const std::string& t) { idx->ids.push_back(idx->intern(t)); };
    for (int64_t i = 0; i < n; i++) {
        const char* text = buf + offsets[i];
        const size_t len = (size_t)(offsets[i + 1] - offsets[i]);
        idx->ids.clear();
        if (pretokenized[i])
            scan_pretokenized(text, len, idx->cur, push);
        else
            scan_ascii(text, len, idx->cur, push);
        add_ids(idx, slots[i]);
        indexed_out[i] = idx->contains(slots[i]) ? 1 : 0;
    }
}

void bm25_remove_chunk(void* h, int64_t slot) { remove_slot((Index*)h, slot); }

int32_t bm25_contains(void* h, int64_t slot) {
    return ((Index*)h)->contains(slot) ? 1 : 0;
}

int64_t bm25_num_docs(void* h) { return ((Index*)h)->total_docs; }

// Scores the query; writes up to `limit` (slot, score) pairs sorted by
// descending score. Returns the number written.
int64_t bm25_score(void* h, const char* query, int64_t qlen, int64_t limit,
                   int64_t* out_slots, float* out_scores) {
    std::vector<std::string> tokens;
    tokenize(query, (size_t)qlen, tokens);
    return score_tokens((Index*)h, tokens, limit, out_slots, out_scores);
}

// Unicode-correct scoring path: `toks` is '\x01'-joined pre-tokenized text.
int64_t bm25_score_tokens(void* h, const char* toks, int64_t qlen,
                          int64_t limit, int64_t* out_slots,
                          float* out_scores) {
    std::vector<std::string> tokens;
    split_pretokenized(toks, (size_t)qlen, tokens);
    return score_tokens((Index*)h, tokens, limit, out_slots, out_scores);
}

// Build the read-optimized snapshot for EVERY term up front (index-load /
// post-ingest warmup), so no query ever pays the lazy per-term compile.
// Terms whose idf clamps to zero on a large posting list are skipped — the
// scorer never walks them (their contribution is identically zero) — and
// so are terms held at legacy slots only, which have no snapshot.
// Returns the number of terms compiled.
int64_t bm25_compile_all(void* h) {
    Index* idx = (Index*)h;
    if (idx->total_docs == 0) return 0;
    const double n_docs = (double)idx->total_docs;
    int64_t built = 0;
    for (Term& t : idx->terms) {
        if (!t.has_dense() || t.compiled.version == idx->version) continue;
        double df = (double)t.df;
        double idf = std::log((n_docs - df + 0.5) / (df + 0.5));
        if (idf <= 0.0 && df >= 1024.0) continue;  // never walked
        compiled(idx, t);
        built++;
    }
    return built;
}

// IDF-weighted unseen-term mass of a query: the share of the query's
// total idf weight carried by terms the index has NEVER seen (df == 0),
// where an unseen term is assigned the maximum idf ln((N+0.5)/0.5) —
// the limit of the BM25 idf formula as df -> 0. A query whose informative
// terms are absent from the whole corpus cannot be grounded by retrieval,
// which makes this the engine-level out-of-domain signal the rejection
// gate pairs with the dense-cosine ceiling (rag_engine.py joint gate).
// `toks` is '\x01'-joined pre-tokenized text; duplicates count once.
// Returns 0.0 for an empty query or an empty index (never rejects).
float bm25_unseen_mass(void* h, const char* toks, int64_t len) {
    Index* idx = (Index*)h;
    std::vector<std::string> tokens;
    split_pretokenized(toks, (size_t)len, tokens);
    if (tokens.empty() || idx->total_docs <= 0) return 0.0f;
    std::sort(tokens.begin(), tokens.end());
    tokens.erase(std::unique(tokens.begin(), tokens.end()), tokens.end());
    const double n_docs = (double)idx->total_docs;
    const double idf_max = std::log((n_docs + 0.5) / 0.5);
    double num = 0.0, den = 0.0;
    for (const auto& t : tokens) {
        Term* term = idx->find(t);
        double df = term == nullptr ? 0.0 : (double)term->df;
        double idf = df > 0.0
                         ? std::max(
                               std::log((n_docs - df + 0.5) / (df + 0.5)),
                               0.0)
                         : idf_max;
        den += idf;
        if (df == 0.0) num += idf;
    }
    return den > 0.0 ? (float)(num / den) : 0.0f;
}

// Bulk-drop any slot NOT present in `valid` (sorted ascending, nv entries).
void bm25_drop_stale(void* h, const int64_t* valid, int64_t nv) {
    Index* idx = (Index*)h;
    std::vector<int64_t> doomed;
    for (size_t s = 0; s < idx->doc_terms.size(); s++) {
        if (!idx->doc_terms[s].empty() &&
            !std::binary_search(valid, valid + nv, (int64_t)s))
            doomed.push_back((int64_t)s);
    }
    for (const auto& kv : idx->legacy_terms) {
        if (!std::binary_search(valid, valid + nv, kv.first))
            doomed.push_back(kv.first);
    }
    for (int64_t slot : doomed) remove_slot(idx, slot);
}

}  // extern "C"
