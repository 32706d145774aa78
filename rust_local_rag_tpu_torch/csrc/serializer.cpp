// Native JSON response serializer of the port: a copy of the JAX package's
// native/serializer.cpp, unchanged below this header. Built with g++ by
// rust_local_rag_tpu_torch/kernels/build.py and reached through the C ABI
// by rust_local_rag_tpu_torch/server/serializer.py, which assembles the
// /search hot lanes' response bodies with it. (The reference serves
// /search from native Rust, axum + serde, src/mcp_server.rs:573-582.)
//
// Model: Python registers one pre-escaped JSON "meta fragment" per
// ChunkStore slot (static fields: text/document/chunk_id/chunk_index/
// page_number/section, escaped once by json.dumps at registration). Per
// request, resp_serialize() assembles `{"results": [...]}` straight from
// the engine's columnar numpy arrays, skipping invalid (-1 slot),
// non-finite, and below-rejection-floor rows (the engine's gate
// semantics for the rerank-off lane).
//
// Concurrency: the registry is guarded by a std::shared_mutex, so one
// handle serves several pipeline threads at once; each caller passes its
// own output buffer.
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <shared_mutex>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Registry {
    // registration takes the unique lock; serialization (the hot path,
    // possibly on several pipeline threads at once) takes the shared lock
    std::shared_mutex mu;
    // dense slot-indexed fragments (ChunkStore slots are dense from 0):
    // one array index beats a 200k-entry hash find by ~3 cache misses per
    // result row. Empty string = unregistered. Slots beyond the dense
    // bound (none in practice) fall back to the map.
    std::vector<std::string> dense;
    std::unordered_map<int64_t, std::string> overflow;
    static constexpr int64_t DENSE_MAX = 1LL << 26;

    const std::string* find(int64_t slot) const {
        if (slot >= 0 && slot < (int64_t)dense.size()) {
            const std::string& s = dense[(size_t)slot];
            return s.empty() ? nullptr : &s;
        }
        auto it = overflow.find(slot);
        return it == overflow.end() ? nullptr : &it->second;
    }

    void put(int64_t slot, const char* frag, int64_t len) {
        if (slot >= 0 && slot < DENSE_MAX) {
            if ((int64_t)dense.size() <= slot)
                dense.resize((size_t)(slot + 1024));
            dense[(size_t)slot].assign(frag, (size_t)len);
        } else {
            overflow[slot] = std::string(frag, (size_t)len);
        }
    }

    void erase(int64_t slot) {
        if (slot >= 0 && slot < (int64_t)dense.size())
            dense[(size_t)slot].clear();
        else
            overflow.erase(slot);
    }

    int64_t count() const {
        int64_t n = (int64_t)overflow.size();
        for (const auto& s : dense)
            if (!s.empty()) n++;
        return n;
    }
};

// Fast score formatting. snprintf("%.9g") costs ~0.5 us per call — at
// 100 results x 4 scores per request it WAS the serializer's entire
// budget. Scores on this path are small (cosines, normalized BM25,
// blends: |v| < 1e5 always in practice), so they format as fixed-point
// with 7 fractional digits (~f32 precision; responses are for humans and
// ranking clients, not bit-exact round-trips), trailing zeros trimmed.
// Anything outside the fast range (or non-finite) falls back to %.9g.
inline int fmt_float(char* out, float v) {
    if (!(v > -1e5f && v < 1e5f)) {
        return std::snprintf(out, 32, "%.9g", (double)v);
    }
    char* p = out;
    float av = v;
    if (v < 0.0f) {
        *p++ = '-';
        av = -v;
    }
    uint64_t iv = (uint64_t)((double)av * 1e7 + 0.5);
    uint64_t ip = iv / 10000000ULL;
    uint64_t fp = iv % 10000000ULL;
    // integer part
    char tmp[8];
    int ni = 0;
    do {
        tmp[ni++] = (char)('0' + ip % 10);
        ip /= 10;
    } while (ip);
    while (ni) *p++ = tmp[--ni];
    if (fp) {
        *p++ = '.';
        char frac[7];
        for (int i = 6; i >= 0; i--) {
            frac[i] = (char)('0' + fp % 10);
            fp /= 10;
        }
        int last = 6;
        while (last > 0 && frac[last] == '0') last--;
        for (int i = 0; i <= last; i++) *p++ = frac[i];
    }
    return (int)(p - out);
}

}  // namespace

extern "C" {

void* resp_create() { return new Registry(); }

void resp_destroy(void* h) { delete (Registry*)h; }

void resp_register(void* h, int64_t slot, const char* frag, int64_t len) {
    Registry* reg = (Registry*)h;
    std::unique_lock<std::shared_mutex> lk(reg->mu);
    reg->put(slot, frag, len);
}

// Bulk registration: `frags` is a '\x00'-free concatenation, offsets[i] /
// offsets[i+1] delimit fragment i for slots[i]. One ctypes crossing for a
// whole index load.
void resp_register_bulk(void* h, const int64_t* slots, const char* frags,
                        const int64_t* offsets, int64_t n) {
    Registry* reg = (Registry*)h;
    std::unique_lock<std::shared_mutex> lk(reg->mu);
    for (int64_t i = 0; i < n; i++) {
        reg->put(slots[i], frags + offsets[i],
                 offsets[i + 1] - offsets[i]);
    }
}

void resp_clear_slot(void* h, int64_t slot) {
    Registry* reg = (Registry*)h;
    std::unique_lock<std::shared_mutex> lk(reg->mu);
    reg->erase(slot);
}

int64_t resp_count(void* h) {
    Registry* reg = (Registry*)h;
    std::shared_lock<std::shared_mutex> lk(reg->mu);
    return reg->count();
}

// Serialize one query's rows. Arrays are parallel, length n. Rows with
// slot < 0, a non-finite score, an embedding score below `floor`
// (when floor > 0), or no registered fragment are skipped.
// Emits: {"results": [{<frag>,"score":S,"embedding_score":E,
//                      "lexical_score":L,"initial_score":S}, ...]}
// (rerank-off lane: initial_score == combined score by construction).
// Returns bytes written, or -1 if out_cap would overflow.
int64_t resp_serialize(void* h, const int32_t* slots, const float* score,
                       const float* emb, const float* lex, int64_t n,
                       float floor_thr, char* out, int64_t out_cap) {
    Registry* reg = (Registry*)h;
    std::shared_lock<std::shared_mutex> lk(reg->mu);
    char* p = out;
    char* end = out + out_cap;
    auto put = [&](const char* s, size_t len) -> bool {
        if (p + len > end) return false;
        std::memcpy(p, s, len);
        p += len;
        return true;
    };
    if (!put("{\"results\": [", 13)) return -1;
    bool first = true;
    for (int64_t i = 0; i < n; i++) {
        int32_t slot = slots[i];
        if (slot < 0 || !std::isfinite(score[i])) continue;
        if (floor_thr > 0.0f && emb[i] < floor_thr) continue;
        const std::string* frag = reg->find((int64_t)slot);
        if (frag == nullptr) continue;
        // worst case per row: fragment + 4 floats (<=32 chars each) + keys
        if (p + frag->size() + 256 > end) return -1;
        if (!first) { *p++ = ','; *p++ = ' '; }
        first = false;
        *p++ = '{';
        std::memcpy(p, frag->data(), frag->size());
        p += frag->size();
        std::memcpy(p, ",\"score\":", 9); p += 9;
        p += fmt_float(p, score[i]);
        std::memcpy(p, ",\"embedding_score\":", 19); p += 19;
        p += fmt_float(p, emb[i]);
        std::memcpy(p, ",\"lexical_score\":", 17); p += 17;
        p += fmt_float(p, lex[i]);
        std::memcpy(p, ",\"initial_score\":", 17); p += 17;
        p += fmt_float(p, score[i]);
        *p++ = '}';
    }
    if (!put("]}", 2)) return -1;
    return (int64_t)(p - out);
}

// Serialize a whole BATCH of queries in one ctypes crossing: arrays are
// row-major [nq, k]; query q's payload is written contiguously into `out`
// and its byte length into out_lens[q]. At 512-query serving batches the
// per-call Python+ctypes overhead (~55 us/query measured) was most of the
// serializer's cost — one crossing amortizes it to nothing.
// Returns total bytes written, or -1 if out_cap would overflow (caller
// doubles the buffer and retries).
int64_t resp_serialize_batch(void* h, const int32_t* slots,
                             const float* score, const float* emb,
                             const float* lex, int64_t nq, int64_t k,
                             float floor_thr, char* out, int64_t out_cap,
                             int64_t* out_lens) {
    Registry* reg = (Registry*)h;
    std::shared_lock<std::shared_mutex> lk(reg->mu);
    char* p = out;
    char* end = out + out_cap;
    for (int64_t q = 0; q < nq; q++) {
        char* q_start = p;
        if (p + 15 > end) return -1;
        std::memcpy(p, "{\"results\": [", 13);
        p += 13;
        bool first = true;
        const int32_t* s_row = slots + q * k;
        const float* v_row = score + q * k;
        const float* e_row = emb + q * k;
        const float* l_row = lex + q * k;
        for (int64_t i = 0; i < k; i++) {
            int32_t slot = s_row[i];
            if (slot < 0 || !std::isfinite(v_row[i])) continue;
            if (floor_thr > 0.0f && e_row[i] < floor_thr) continue;
            const std::string* frag = reg->find((int64_t)slot);
            if (frag == nullptr) continue;
            if (p + frag->size() + 256 > end) return -1;
            if (!first) { *p++ = ','; *p++ = ' '; }
            first = false;
            *p++ = '{';
            std::memcpy(p, frag->data(), frag->size());
            p += frag->size();
            std::memcpy(p, ",\"score\":", 9); p += 9;
            p += fmt_float(p, v_row[i]);
            std::memcpy(p, ",\"embedding_score\":", 19); p += 19;
            p += fmt_float(p, e_row[i]);
            std::memcpy(p, ",\"lexical_score\":", 17); p += 17;
            p += fmt_float(p, l_row[i]);
            std::memcpy(p, ",\"initial_score\":", 17); p += 17;
            p += fmt_float(p, v_row[i]);
            *p++ = '}';
        }
        if (p + 2 > end) return -1;
        *p++ = ']';
        *p++ = '}';
        out_lens[q] = (int64_t)(p - q_start);
    }
    return (int64_t)(p - out);
}

// Judge-gated batch serialization (the shipped quality config: reranker
// blend weight 0, judge yes-probability as a rejection floor). Same layout
// as resp_serialize_batch plus three parallel [nq, k] arrays: `initial`
// (raw combined first-stage score), `rr` (judge yes-probability) and the
// yes/no logprobs. `score` carries the blend-normalized value the object
// lane computes (initial_w * initial / max_initial). Gate semantics mirror
// RagEngine._keep for judged rows: drop when rr < rr_floor (rr_floor > 0)
// OR emb < emb_floor (emb_floor > 0). Rows with slot < 0 or non-finite
// initial are padding and skipped.
int64_t resp_serialize_batch_rr(void* h, const int32_t* slots,
                                const float* score, const float* emb,
                                const float* lex, const float* initial,
                                const float* rr, const float* yes_lp,
                                const float* no_lp, int64_t nq, int64_t k,
                                float emb_floor, float rr_floor, char* out,
                                int64_t out_cap, int64_t* out_lens) {
    Registry* reg = (Registry*)h;
    std::shared_lock<std::shared_mutex> lk(reg->mu);
    char* p = out;
    char* end = out + out_cap;
    for (int64_t q = 0; q < nq; q++) {
        char* q_start = p;
        if (p + 15 > end) return -1;
        std::memcpy(p, "{\"results\": [", 13);
        p += 13;
        bool first = true;
        const int64_t off = q * k;
        for (int64_t i = 0; i < k; i++) {
            int32_t slot = slots[off + i];
            if (slot < 0 || !std::isfinite(initial[off + i])) continue;
            if (rr_floor > 0.0f && rr[off + i] < rr_floor) continue;
            if (emb_floor > 0.0f && emb[off + i] < emb_floor) continue;
            const std::string* frag = reg->find((int64_t)slot);
            if (frag == nullptr) continue;
            // fragment + 7 floats (<=32 chars each) + keys
            if (p + frag->size() + 384 > end) return -1;
            if (!first) { *p++ = ','; *p++ = ' '; }
            first = false;
            *p++ = '{';
            std::memcpy(p, frag->data(), frag->size());
            p += frag->size();
            std::memcpy(p, ",\"score\":", 9); p += 9;
            p += fmt_float(p, score[off + i]);
            std::memcpy(p, ",\"embedding_score\":", 19); p += 19;
            p += fmt_float(p, emb[off + i]);
            std::memcpy(p, ",\"lexical_score\":", 17); p += 17;
            p += fmt_float(p, lex[off + i]);
            std::memcpy(p, ",\"initial_score\":", 17); p += 17;
            p += fmt_float(p, initial[off + i]);
            std::memcpy(p, ",\"reranker_score\":", 18); p += 18;
            p += fmt_float(p, rr[off + i]);
            std::memcpy(p, ",\"yes_logprob\":", 15); p += 15;
            p += fmt_float(p, yes_lp[off + i]);
            std::memcpy(p, ",\"no_logprob\":", 14); p += 14;
            p += fmt_float(p, no_lp[off + i]);
            *p++ = '}';
        }
        if (p + 2 > end) return -1;
        *p++ = ']';
        *p++ = '}';
        out_lens[q] = (int64_t)(p - q_start);
    }
    return (int64_t)(p - out);
}

}  // extern "C"
