// Native BM25 inverted index of the port: a copy of the JAX package's
// native/lexical.cpp, unchanged below this header. Built with g++ by
// rust_local_rag_tpu_torch/kernels/build.py and reached through the C ABI
// by rust_local_rag_tpu_torch/ops/native_bm25.py. (The reference's
// LexicalIndex is native Rust, rag_engine.rs:2083-2237.)
//
// Semantics match ops/bm25.py: tokens are lowercased alphanumeric runs with
// UTF-8 byte length >= 3; BM25 k1=1.5 b=0.75; idf = max(ln((N-df+.5)/(df+.5)), 0).
//
// Tokenization lives on the PYTHON side (ops/bm25.tokenize — Unicode-aware
// splitting and lowercasing, bit-identical to the pure-Python index); the
// wrapper ships pre-tokenized text through bm25_add_tokens /
// bm25_score_tokens ('\x01'-joined UTF-8 tokens, no further filtering).
// The byte-level bm25_add_chunk / bm25_score entry points apply ASCII-only
// rules (non-ASCII bytes treated as letters); the wrapper calls bm25_score
// for pure-ASCII queries only, where the two rules agree.
//
// Concurrency: an Index is NOT safe for concurrent calls, scoring included.
// score_tokens writes the index's shared scratch (acc, epoch, touched) and
// builds posting snapshots lazily into `compiled`, so two scores at once
// corrupt each other. The wrapper (NativeLexicalIndex) serialises every
// call on a handle with a lock; this file is left as the JAX package has it.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <cmath>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

// Slots below this bound use flat arrays (ChunkStore slab slots are dense
// from 0); the rare auto-allocated legacy slots (>= 2^40 on the Python
// side) fall back to hash maps.
constexpr int64_t DENSE_LIMIT = 1LL << 26;

// Read-optimized per-term posting snapshot: contiguous (slot asc, tf)
// arrays. The mutable truth stays in the hash map; a term's snapshot is
// built lazily on first use in a query and dropped whenever a mutation
// touches the term. Contiguous ascending-slot walks turn the scorer's
// memory pattern from a pointer-chase (~200 ns/posting) into prefetchable
// sweeps.
struct Compiled {
    std::vector<int32_t> slots;  // ascending
    // tf*(k1+1) / (tf + k1*(1-b + b*dl/avgdl)) — the full per-posting BM25
    // factor except idf, precomputed at snapshot time. Valid for the
    // avgdl frozen at `version`; any index mutation bumps the global
    // version and stales EVERY snapshot (avgdl is global).
    std::vector<float> contrib;
    int64_t version = -1;
};

// accumulator cell: value + visited-epoch share one 8-byte line so each
// posting's random access touches ONE cache line
struct Acc {
    float v;
    int32_t stamp;
};

struct Index {
    // term -> (slot -> tf)
    std::unordered_map<std::string, std::unordered_map<int64_t, int32_t>> postings;
    std::unordered_map<std::string, Compiled> compiled;
    std::unordered_map<int64_t, int64_t> doc_lengths;
    std::unordered_map<int64_t, std::vector<std::string>> doc_terms;  // unique terms per doc
    int64_t total_docs = 0;
    int64_t total_length = 0;
    int64_t version = 0;  // bumped on every mutation (stales snapshots)
    // scoring scratch (persistent across queries):
    // dl_dense mirrors doc_lengths for slots < DENSE_LIMIT; `stamp`/
    // `epoch` dedupe the touched list (zero contributions are legal, so
    // the accumulator value cannot double as the visited flag)
    std::vector<int32_t> dl_dense;
    std::vector<Acc> acc;
    int32_t epoch = 0;
    std::vector<int64_t> touched;

    void set_dl(int64_t slot, int64_t dl) {
        if (slot >= 0 && slot < DENSE_LIMIT) {
            if ((int64_t)dl_dense.size() <= slot)
                dl_dense.resize((size_t)(slot + 1024), 0);
            dl_dense[(size_t)slot] = (int32_t)dl;
        }
    }
};

inline bool is_token_byte(unsigned char c) {
    return std::isalnum(c) || c >= 0x80;
}

void tokenize(const char* text, size_t len, std::vector<std::string>& out) {
    std::string cur;
    for (size_t i = 0; i < len; i++) {
        unsigned char c = (unsigned char)text[i];
        if (is_token_byte(c)) {
            cur.push_back((char)std::tolower(c));
        } else if (!cur.empty()) {
            if (cur.size() >= 3) out.push_back(cur);
            cur.clear();
        }
    }
    if (cur.size() >= 3) out.push_back(cur);
}

// Pre-tokenized input: tokens joined by '\x01'. No filtering — the caller
// (Python wrapper) already applied the Unicode-aware tokenization rules.
void split_pretokenized(const char* text, size_t len,
                        std::vector<std::string>& out) {
    std::string cur;
    for (size_t i = 0; i < len; i++) {
        char c = text[i];
        if (c == '\x01') {
            if (!cur.empty()) { out.push_back(cur); cur.clear(); }
        } else {
            cur.push_back(c);
        }
    }
    if (!cur.empty()) out.push_back(cur);
}

void remove_slot(Index* idx, int64_t slot);

void add_tokens(Index* idx, int64_t slot, std::vector<std::string>& tokens) {
    if (idx->doc_terms.count(slot)) remove_slot(idx, slot);
    if (tokens.empty()) return;

    std::unordered_map<std::string, int32_t> counts;
    for (auto& t : tokens) counts[t]++;

    int64_t doc_length = 0;
    std::vector<std::string> uniq;
    uniq.reserve(counts.size());
    for (auto& kv : counts) {
        doc_length += kv.second;
        idx->postings[kv.first][slot] = kv.second;
        uniq.push_back(kv.first);
    }
    idx->version++;  // stales every snapshot (avgdl changed)
    idx->doc_lengths[slot] = doc_length;
    idx->set_dl(slot, doc_length);
    idx->doc_terms[slot] = std::move(uniq);
    idx->total_docs++;
    idx->total_length += doc_length;
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

    for (const auto& term : tokens) {
        auto pit = idx->postings.find(term);
        if (pit == idx->postings.end()) continue;
        double df = (double)pit->second.size();
        double idf = std::log((n_docs - df + 0.5) / (df + 0.5));
        // exact skip for LARGE zero-idf lists (clamped contribution is 0);
        // small corpora keep the walk so docs matching only ubiquitous
        // terms still appear in the raw list (mirrors ops/bm25.py)
        if (idf <= 0.0 && df >= 1024.0) continue;
        if (idf < 0.0) idf = 0.0;
        const float fidf = (float)idf;
        const double kb = k1 * b / avg_dl;
        const double k1b = k1 * (1.0 - b);

        // contiguous snapshot (built lazily on first use of this term,
        // rebuilt when any mutation staled it — avgdl is global)
        auto cit = idx->compiled.find(term);
        if (cit == idx->compiled.end() ||
            cit->second.version != idx->version) {
            Compiled cs;
            bool dense_ok = true;
            std::vector<std::pair<int32_t, float>> tmp;
            tmp.reserve(pit->second.size());
            for (const auto& kv : pit->second) {
                if (kv.first < 0 || kv.first >= DENSE_LIMIT) {
                    dense_ok = false;
                    break;
                }
                tmp.emplace_back((int32_t)kv.first, (float)kv.second);
            }
            if (dense_ok) {
                std::sort(tmp.begin(), tmp.end());
                cs.slots.reserve(tmp.size());
                cs.contrib.reserve(tmp.size());
                for (auto& st : tmp) {
                    double dl = (double)idx->dl_dense[(size_t)st.first];
                    double tf = (double)st.second;
                    double denom = tf + k1b + kb * dl;
                    cs.slots.push_back(st.first);
                    cs.contrib.push_back(
                        dl > 0.0 && denom != 0.0
                            ? (float)(tf * (k1 + 1.0) / denom)
                            : 0.0f);
                }
                cs.version = idx->version;
                cit = idx->compiled.insert_or_assign(
                    term, std::move(cs)).first;
            } else {
                cit = idx->compiled.end();
            }
        }

        if (cit != idx->compiled.end()) {
            const Compiled& c = cit->second;
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
            continue;
        }

        // legacy slots beyond DENSE_LIMIT: hash-map walk
        for (const auto& kv : pit->second) {
            int64_t slot = kv.first;
            double tf = (double)kv.second;
            auto lit = idx->doc_lengths.find(slot);
            if (lit == idx->doc_lengths.end() || lit->second == 0)
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
    auto it = idx->doc_terms.find(slot);
    if (it != idx->doc_terms.end()) {
        for (const auto& term : it->second) {
            auto pit = idx->postings.find(term);
            if (pit != idx->postings.end()) {
                pit->second.erase(slot);
                if (pit->second.empty()) idx->postings.erase(pit);
            }
            idx->compiled.erase(term);
        }
        idx->doc_terms.erase(it);
        auto lit = idx->doc_lengths.find(slot);
        if (lit != idx->doc_lengths.end()) {
            idx->total_length = std::max<int64_t>(0, idx->total_length - lit->second);
            idx->doc_lengths.erase(lit);
        }
        if (idx->total_docs > 0) idx->total_docs--;
    } else {
        idx->doc_lengths.erase(slot);
    }
    if (slot >= 0 && slot < (int64_t)idx->dl_dense.size())
        idx->dl_dense[(size_t)slot] = 0;
    if (idx->total_docs == 0) idx->total_length = 0;
}

}  // namespace

extern "C" {

void* bm25_create() { return new Index(); }

void bm25_destroy(void* h) { delete (Index*)h; }

void bm25_add_chunk(void* h, int64_t slot, const char* text, int64_t len) {
    std::vector<std::string> tokens;
    tokenize(text, (size_t)len, tokens);
    add_tokens((Index*)h, slot, tokens);
}

// Unicode-correct ingestion path: `toks` is '\x01'-joined pre-tokenized text.
void bm25_add_tokens(void* h, int64_t slot, const char* toks, int64_t len) {
    std::vector<std::string> tokens;
    split_pretokenized(toks, (size_t)len, tokens);
    add_tokens((Index*)h, slot, tokens);
}

void bm25_remove_chunk(void* h, int64_t slot) { remove_slot((Index*)h, slot); }

int32_t bm25_contains(void* h, int64_t slot) {
    return ((Index*)h)->doc_terms.count(slot) ? 1 : 0;
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
// scorer never walks them (their contribution is identically zero).
// Returns the number of terms compiled.
int64_t bm25_compile_all(void* h) {
    Index* idx = (Index*)h;
    if (idx->total_docs == 0) return 0;
    const double k1 = 1.5, b = 0.75;
    const double avg_dl = (double)idx->total_length / (double)idx->total_docs;
    const double n_docs = (double)idx->total_docs;
    const double kb = k1 * b / avg_dl;
    const double k1b = k1 * (1.0 - b);
    int64_t built = 0;
    for (const auto& pkv : idx->postings) {
        double df = (double)pkv.second.size();
        double idf = std::log((n_docs - df + 0.5) / (df + 0.5));
        if (idf <= 0.0 && df >= 1024.0) continue;  // never walked
        auto cit = idx->compiled.find(pkv.first);
        if (cit != idx->compiled.end() &&
            cit->second.version == idx->version)
            continue;
        std::vector<std::pair<int32_t, float>> tmp;
        tmp.reserve(pkv.second.size());
        bool dense_ok = true;
        for (const auto& kv : pkv.second) {
            if (kv.first < 0 || kv.first >= DENSE_LIMIT) {
                dense_ok = false;
                break;
            }
            tmp.emplace_back((int32_t)kv.first, (float)kv.second);
        }
        if (!dense_ok) continue;
        std::sort(tmp.begin(), tmp.end());
        Compiled cs;
        cs.slots.reserve(tmp.size());
        cs.contrib.reserve(tmp.size());
        for (auto& st : tmp) {
            int64_t s = st.first;
            double dl = (s < (int64_t)idx->dl_dense.size())
                            ? (double)idx->dl_dense[(size_t)s]
                            : 0.0;
            double tf = (double)st.second;
            double denom = tf + k1b + kb * dl;
            cs.slots.push_back(st.first);
            cs.contrib.push_back(
                dl > 0.0 && denom != 0.0
                    ? (float)(tf * (k1 + 1.0) / denom)
                    : 0.0f);
        }
        cs.version = idx->version;
        idx->compiled.insert_or_assign(pkv.first, std::move(cs));
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
        auto it = idx->postings.find(t);
        double df = (it == idx->postings.end())
                        ? 0.0
                        : (double)it->second.size();
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
    for (const auto& kv : idx->doc_terms) {
        if (!std::binary_search(valid, valid + nv, kv.first)) {
            doomed.push_back(kv.first);
        }
    }
    for (int64_t slot : doomed) remove_slot(idx, slot);
}

}  // extern "C"
