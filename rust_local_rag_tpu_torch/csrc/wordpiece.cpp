// Native WordPiece tokenizer for the ASCII fast path: the port's copy of
// the JAX package's native/wordpiece.cpp, unchanged below this header.
// Built with g++ by rust_local_rag_tpu_torch/kernels/build.py and reached
// through rust_local_rag_tpu_torch/models/native_tokenizer.py.
//
// Replicates the serving tokenizer pipeline (assets/tokenizer.json:
// NFD + Lowercase + StripAccents, WhitespaceSplit + Punctuation(Isolated),
// WordPiece(##, max 64 chars/word, [UNK]), "[CLS] $A [SEP]" template, and
// the added token "yes" extracted anywhere in the normalized text) for
// pure-ASCII inputs, where NFD/StripAccents are identity and Lowercase is
// a byte map. Texts containing non-ASCII bytes, control characters, or
// literal special-token strings are routed to the port's pure-Python
// WordPieceTokenizer by the wrapper, so this kernel only ever sees inputs
// on which it is exactly equivalent (tests/test_torch_native_tokenizer.py).
// Encoding reads the tables only, so concurrent wp_encode_batch calls on
// one handle are safe.
//
// It is a single pass over the bytes with two open-addressing piece tables
// and no allocation on the hot path.

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct PieceTable {
  // open addressing, power-of-two capacity; empty slot = idx -1
  std::vector<int32_t> idx;
  std::vector<uint32_t> hashes;
  const std::vector<std::string>* pieces = nullptr;  // backing store
  std::vector<int32_t> ids;
  uint32_t mask = 0;

  static uint32_t hash(const char* s, size_t n) {
    uint32_t h = 2166136261u;  // FNV-1a
    for (size_t i = 0; i < n; ++i) {
      h ^= (uint8_t)s[i];
      h *= 16777619u;
    }
    return h ? h : 1u;
  }

  void build(const std::vector<std::string>& keys,
             const std::vector<int32_t>& vals) {
    size_t cap = 16;
    while (cap < keys.size() * 2) cap <<= 1;
    mask = (uint32_t)(cap - 1);
    idx.assign(cap, -1);
    hashes.assign(cap, 0);
    pieces = &keys;
    ids = vals;
    for (size_t k = 0; k < keys.size(); ++k) {
      uint32_t h = hash(keys[k].data(), keys[k].size());
      uint32_t p = h & mask;
      while (idx[p] != -1) p = (p + 1) & mask;
      idx[p] = (int32_t)k;
      hashes[p] = h;
    }
  }

  int32_t lookup(const char* s, size_t n) const {
    uint32_t h = hash(s, n);
    uint32_t p = h & mask;
    while (true) {
      int32_t k = idx[p];
      if (k == -1) return -1;
      if (hashes[p] == h) {
        const std::string& cand = (*pieces)[k];
        if (cand.size() == n && memcmp(cand.data(), s, n) == 0)
          return ids[k];
      }
      p = (p + 1) & mask;
    }
  }
};

struct WordPiece {
  PieceTable init_table, cont_table;
  std::vector<std::string> init_keys, cont_keys;
  int32_t cls_id, sep_id, unk_id, yes_id;
  int32_t max_word_chars;
  size_t max_init_len = 0, max_cont_len = 0;
};

inline bool is_ws(uint8_t c) {
  return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\v' ||
         c == '\f';
}

inline bool is_punct(uint8_t c) {
  return (c >= 33 && c <= 47) || (c >= 58 && c <= 64) ||
         (c >= 91 && c <= 96) || (c >= 123 && c <= 126);
}

inline uint8_t lower(uint8_t c) {
  return (c >= 'A' && c <= 'Z') ? (uint8_t)(c + 32) : c;
}

struct Emitter {
  int32_t* row;
  int32_t max_len;
  int32_t count = 0;
  inline bool emit(int32_t id) {
    if (count >= max_len) return false;
    row[count++] = id;
    return true;
  }
  inline bool full() const { return count >= max_len; }
};

// Greedy longest-match WordPiece over one normalized word. Emits pieces;
// if any position fails to match, the WHOLE word becomes a single [UNK]
// (HF semantics). Returns false when the row filled up mid-word.
bool word_to_pieces(const WordPiece& wp, const char* w, size_t n,
                    Emitter& em) {
  if ((int32_t)n > wp.max_word_chars) return em.emit(wp.unk_id);
  int32_t scratch[64];
  int n_pieces = 0;
  size_t pos = 0;
  while (pos < n) {
    size_t cap = n - pos;
    size_t lim = pos == 0 ? wp.max_init_len : wp.max_cont_len;
    if (cap > lim) cap = lim;
    int32_t found = -1;
    size_t flen = 0;
    for (size_t len = cap; len >= 1; --len) {
      int32_t id = pos == 0 ? wp.init_table.lookup(w, len)
                            : wp.cont_table.lookup(w + pos, len);
      if (id >= 0) {
        found = id;
        flen = len;
        break;
      }
    }
    if (found < 0) return em.emit(wp.unk_id);  // discard partial pieces
    scratch[n_pieces++] = found;
    pos += flen;
  }
  for (int i = 0; i < n_pieces; ++i)
    if (!em.emit(scratch[i])) return false;
  return true;
}

// Pre-tokenize + wordpiece one added-token-free segment of normalized
// text: whitespace splits, each punctuation byte is its own pre-token,
// alnum runs are words.
void encode_segment(const WordPiece& wp, const char* s, size_t n,
                    Emitter& em) {
  char word[80];  // max_word_chars=64 + headroom; longer words spill to UNK
  size_t i = 0;
  while (i < n && !em.full()) {
    uint8_t c = (uint8_t)s[i];
    if (is_ws(c)) {
      ++i;
      continue;
    }
    if (is_punct(c)) {
      char p = (char)c;
      word_to_pieces(wp, &p, 1, em);
      ++i;
      continue;
    }
    // word run: everything up to the next whitespace/punct byte
    size_t w = 0;
    while (i < n) {
      uint8_t b = (uint8_t)s[i];
      if (is_ws(b) || is_punct(b)) break;
      if (w < sizeof(word)) word[w] = (char)lower(b);
      ++w;
      ++i;
    }
    if (w > sizeof(word)) {
      em.emit(wp.unk_id);  // longer than any piece limit
    } else {
      word_to_pieces(wp, word, w, em);
    }
  }
}

void encode_one(const WordPiece& wp, const char* s, size_t n, int32_t max_len,
                int32_t* row, int32_t* out_len) {
  Emitter em{row, max_len};
  em.emit(wp.cls_id);
  // added-token extraction: case-insensitive "yes" anywhere in the text
  // splits the stream; each side pre-tokenizes independently (matches
  // the HF AddedVocabulary split — "bayesian" -> 'ba','yes','i','##an')
  size_t seg = 0, i = 0;
  if (wp.yes_id >= 0) {
    while (i + 3 <= n && !em.full()) {
      if (lower((uint8_t)s[i]) == 'y' && lower((uint8_t)s[i + 1]) == 'e' &&
          lower((uint8_t)s[i + 2]) == 's') {
        encode_segment(wp, s + seg, i - seg, em);
        em.emit(wp.yes_id);
        i += 3;
        seg = i;
      } else {
        ++i;
      }
    }
  }
  if (!em.full()) encode_segment(wp, s + seg, n - seg, em);
  em.emit(wp.sep_id);
  *out_len = em.count;
}

}  // namespace

extern "C" {

// vocab_blob: n_tokens NUL-terminated UTF-8 strings back to back, in id
// order (ids 0..n_tokens-1). Pieces starting with "##" register as
// continuations (prefix stripped); everything else as initial pieces.
void* wp_create(const char* vocab_blob, int64_t blob_len, int32_t n_tokens,
                int32_t cls_id, int32_t sep_id, int32_t unk_id,
                int32_t yes_id, int32_t max_word_chars) {
  WordPiece* wp = new WordPiece();
  wp->cls_id = cls_id;
  wp->sep_id = sep_id;
  wp->unk_id = unk_id;
  wp->yes_id = yes_id;
  wp->max_word_chars = max_word_chars;
  std::vector<int32_t> init_ids, cont_ids;
  const char* p = vocab_blob;
  const char* end = vocab_blob + blob_len;
  for (int32_t id = 0; id < n_tokens && p < end; ++id) {
    size_t len = strnlen(p, (size_t)(end - p));
    if (len >= 2 && p[0] == '#' && p[1] == '#') {
      wp->cont_keys.emplace_back(p + 2, len - 2);
      cont_ids.push_back(id);
      if (len - 2 > wp->max_cont_len) wp->max_cont_len = len - 2;
    } else {
      wp->init_keys.emplace_back(p, len);
      init_ids.push_back(id);
      if (len > wp->max_init_len) wp->max_init_len = len;
    }
    p += len + 1;
  }
  wp->init_table.build(wp->init_keys, init_ids);
  wp->cont_table.build(wp->cont_keys, cont_ids);
  return wp;
}

void wp_destroy(void* h) { delete (WordPiece*)h; }

// texts: concatenated UTF-8 bytes; offsets[n+1] delimit each text.
// out_ids: [n, max_len] int32 row-major (caller-allocated, any contents —
// rows are written up to out_lens[r], the rest is the caller's padding
// concern). out_lens: [n] int32 token counts (CLS/SEP included,
// truncated at max_len).
void wp_encode_batch(void* h, const char* texts, const int64_t* offsets,
                     int32_t n, int32_t max_len, int32_t* out_ids,
                     int32_t* out_lens) {
  const WordPiece& wp = *(const WordPiece*)h;
  for (int32_t r = 0; r < n; ++r) {
    encode_one(wp, texts + offsets[r], (size_t)(offsets[r + 1] - offsets[r]),
               max_len, out_ids + (int64_t)r * max_len, &out_lens[r]);
  }
}

}  // extern "C"
