// Native PDF text extraction of the port: a copy of the JAX package's
// native/pdftext.cpp, unchanged below this header. Built with g++ (linked
// with -lz, as native/Makefile links it) by
// rust_local_rag_tpu_torch/kernels/build.py and reached through the C ABI
// by rust_local_rag_tpu_torch/ingest/pdf.py, the extractor's first tier.
//
// Native PDF text extraction — C++ implementation of the host-side tier-1
// extractor (the reference ingests PDFs natively too: rag_engine.rs:949-1090
// runs lopdf + a pdftotext fallback). The single-core host made the
// pure-Python extractor (~3.8 ms/document) the longest pole of the pipelined
// full-ingest path once extraction joined the timed loop; this port keeps
// the host stages under the device forward time.
//
// Semantics are a 1:1 mirror of rust_local_rag_tpu/ingest/pdf.py
// _builtin_extract (object scan, page-tree walk, FlateDecode, content-stream
// token interpretation, escape/hex decoding, trailing-blank collapse) — the
// parity test (tests/test_native_pdf.py) asserts byte-identical output so
// chunk boundaries cannot depend on which tier ran. Python keeps the
// fallback chain: native -> pure-Python -> pdftotext.

#include <zlib.h>

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct PdfObj {
    std::string body;
    std::string stream;
    bool has_stream = false;
};

using ObjMap = std::unordered_map<int64_t, PdfObj>;

bool is_digit(unsigned char c) { return c >= '0' && c <= '9'; }
// Python \s on bytes: [ \t\n\r\f\v]; PDF also treats NUL as ws but the
// Python reference uses \s — match \s exactly (no NUL).
bool is_py_ws(unsigned char c) {
    return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\f' ||
           c == '\v';
}
bool is_alpha(unsigned char c) {
    return (c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z');
}
bool is_word(unsigned char c) {  // Python \w for \b after "obj"
    return is_alpha(c) || is_digit(c) || c == '_';
}

// ---- object scan: mirrors _OBJ_RE = (\d+)\s+(\d+)\s+obj\b ----------------

void scan_objects(const std::string& data, ObjMap& objects,
                  std::vector<int64_t>& order) {
    size_t i = 0, n = data.size();
    while (i < n) {
        if (!is_digit(data[i])) { i++; continue; }
        // A match must start at a position where (\d+) begins; finditer
        // scans every offset, so a digit mid-number can start a (shorter)
        // match only if the full pattern follows. Parsing greedily from the
        // leftmost digit of a run is equivalent: if the full pattern fails
        // at this digit, it also fails at later digits of the same run
        // (same ws/obj suffix required), except when the run is followed by
        // ws+digits+ws+obj — handled because we retry from every digit.
        size_t j = i;
        while (j < n && is_digit(data[j])) j++;
        size_t num_end = j;
        size_t k = j;
        while (k < n && is_py_ws(data[k])) k++;
        if (k == j || k >= n || !is_digit(data[k])) { i++; continue; }
        while (k < n && is_digit(data[k])) k++;
        size_t g = k;
        while (g < n && is_py_ws(data[g])) g++;
        if (g == k || g + 3 > n || data.compare(g, 3, "obj") != 0) {
            i++;
            continue;
        }
        if (g + 3 < n && is_word(data[g + 3])) { i++; continue; }  // \b
        int64_t num = 0;
        for (size_t p = i; p < num_end; p++) num = num * 10 + (data[p] - '0');
        size_t start = g + 3;
        size_t end = data.find("endobj", start);
        if (end == std::string::npos) { i = start; continue; }
        std::string body = data.substr(start, end - start);
        PdfObj obj;
        // _STREAM_RE: "stream\r?\n"
        size_t sp = body.find("stream");
        size_t s_start = std::string::npos;
        while (sp != std::string::npos) {
            size_t e = sp + 6;
            if (e < body.size() && body[e] == '\r') e++;
            if (e < body.size() && body[e] == '\n') {
                s_start = e + 1;
                break;
            }
            sp = body.find("stream", sp + 1);
        }
        if (s_start != std::string::npos) {
            size_t s_end = body.rfind("endstream");
            if (s_end != std::string::npos && s_end >= s_start) {
                std::string stream = body.substr(s_start, s_end - s_start);
                if (!stream.empty() && stream.back() == '\n') stream.pop_back();
                if (!stream.empty() && stream.back() == '\r') stream.pop_back();
                obj.stream = std::move(stream);
                obj.has_stream = true;
            }
            body = body.substr(0, sp);
        }
        obj.body = std::move(body);
        if (objects.find(num) == objects.end()) order.push_back(num);
        objects[num] = std::move(obj);  // last definition wins (dict update)
        i = end + 6;
    }
}

// ---- reference lookups: /Key N 0 R and /Key [ N 0 R ... ] ----------------

// skip \s+ ; returns false if none skipped
bool skip_ws1(const std::string& s, size_t& p) {
    size_t q = p;
    while (q < s.size() && is_py_ws(s[q])) q++;
    if (q == p) return false;
    p = q;
    return true;
}

bool parse_int(const std::string& s, size_t& p, int64_t& out) {
    size_t q = p;
    int64_t v = 0;
    while (q < s.size() && is_digit(s[q])) { v = v * 10 + (s[q] - '0'); q++; }
    if (q == p) return false;
    p = q;
    out = v;
    return true;
}

// find "<key>\s+(\d+)\s+\d+\s+R" anywhere in body
bool find_ref(const std::string& body, const std::string& key, int64_t& out) {
    size_t pos = 0;
    while ((pos = body.find(key, pos)) != std::string::npos) {
        size_t p = pos + key.size();
        int64_t num, gen;
        if (skip_ws1(body, p) && parse_int(body, p, num) &&
            skip_ws1(body, p) && parse_int(body, p, gen) &&
            skip_ws1(body, p) && p < body.size() && body[p] == 'R') {
            out = num;
            return true;
        }
        pos++;
    }
    return false;
}

// all (\d+)\s+\d+\s+R inside a span
void find_all_refs(const std::string& s, size_t from, size_t to,
                   std::vector<int64_t>& out) {
    size_t i = from;
    while (i < to) {
        if (!is_digit(s[i])) { i++; continue; }
        size_t p = i;
        int64_t num, gen;
        if (parse_int(s, p, num) && skip_ws1(s, p) && p < to &&
            parse_int(s, p, gen) && skip_ws1(s, p) && p < to && s[p] == 'R') {
            out.push_back(num);
            i = p + 1;
        } else {
            while (i < to && is_digit(s[i])) i++;  // skip this digit run
        }
    }
}

// "<key>\s*\[(.*?)\]" (DOTALL, non-greedy) else single ref
std::vector<int64_t> find_refs_array(const std::string& body,
                                     const std::string& key) {
    std::vector<int64_t> out;
    size_t pos = 0;
    while ((pos = body.find(key, pos)) != std::string::npos) {
        size_t p = pos + key.size();
        while (p < body.size() && is_py_ws(body[p])) p++;
        if (p < body.size() && body[p] == '[') {
            size_t close = body.find(']', p + 1);
            if (close != std::string::npos) {
                find_all_refs(body, p + 1, close, out);
                return out;
            }
        }
        pos++;
    }
    int64_t single;
    if (find_ref(body, key, single)) out.push_back(single);
    return out;
}

// ---- page tree ------------------------------------------------------------

bool contains(const std::string& body, const char* needle) {
    return body.find(needle) != std::string::npos;
}

void walk_pages(const ObjMap& objects, int64_t node, int depth,
                std::vector<int64_t>& out) {
    if (depth > 64) return;
    auto it = objects.find(node);
    if (it == objects.end()) return;
    const std::string& body = it->second.body;
    if (contains(body, "/Page") && !contains(body, "/Pages") &&
        !contains(body, "/Kids")) {
        out.push_back(node);
        return;
    }
    for (int64_t kid : find_refs_array(body, "/Kids"))
        walk_pages(objects, kid, depth + 1, out);
}

std::vector<int64_t> page_order(const ObjMap& objects,
                                const std::vector<int64_t>& scan_order) {
    int64_t root = -1;
    for (int64_t num : scan_order) {
        const std::string& body = objects.at(num).body;
        if (contains(body, "/Type") && contains(body, "/Catalog")) {
            int64_t pages;
            if (find_ref(body, "/Pages", pages)) root = pages;
            break;
        }
    }
    std::vector<int64_t> out;
    if (root >= 0) walk_pages(objects, root, 0, out);
    if (out.empty()) {
        for (int64_t num : scan_order) {
            const std::string& body = objects.at(num).body;
            if (contains(body, "/Contents") && contains(body, "/Type") &&
                contains(body, "/Page"))
                out.push_back(num);
        }
    }
    return out;
}

// ---- stream decode --------------------------------------------------------

bool inflate_all(const std::string& in, std::string& out) {
    z_stream zs;
    std::memset(&zs, 0, sizeof(zs));
    if (inflateInit(&zs) != Z_OK) return false;
    zs.next_in = (Bytef*)in.data();
    zs.avail_in = (uInt)in.size();
    char buf[1 << 15];
    int ret;
    do {
        zs.next_out = (Bytef*)buf;
        zs.avail_out = sizeof(buf);
        ret = inflate(&zs, Z_NO_FLUSH);
        if (ret != Z_OK && ret != Z_STREAM_END) {
            inflateEnd(&zs);
            return false;
        }
        out.append(buf, sizeof(buf) - zs.avail_out);
    } while (ret != Z_STREAM_END && zs.avail_in > 0);
    inflateEnd(&zs);
    return ret == Z_STREAM_END;
}

std::string object_stream(const ObjMap& objects, int64_t num) {
    auto it = objects.find(num);
    if (it == objects.end() || !it->second.has_stream) return "";
    const PdfObj& obj = it->second;
    if (contains(obj.body, "/FlateDecode")) {
        std::string out;
        if (inflate_all(obj.stream, out)) return out;
        // some writers pad the stream; retry truncated to /Length
        size_t lp = obj.body.find("/Length");
        if (lp != std::string::npos) {
            size_t p = lp + 7;
            if (skip_ws1(obj.body, p)) {
                int64_t len;
                if (parse_int(obj.body, p, len) &&
                    len <= (int64_t)obj.stream.size()) {
                    out.clear();
                    if (inflate_all(obj.stream.substr(0, (size_t)len), out))
                        return out;
                }
            }
        }
        return "";
    }
    return obj.stream;
}

// ---- text decoding --------------------------------------------------------

void append_cp(std::string& out, uint32_t cp) {  // codepoint -> UTF-8
    if (cp < 0x80) {
        out += (char)cp;
    } else if (cp < 0x800) {
        out += (char)(0xC0 | (cp >> 6));
        out += (char)(0x80 | (cp & 0x3F));
    } else if (cp < 0x10000) {
        out += (char)(0xE0 | (cp >> 12));
        out += (char)(0x80 | ((cp >> 6) & 0x3F));
        out += (char)(0x80 | (cp & 0x3F));
    } else {
        out += (char)(0xF0 | (cp >> 18));
        out += (char)(0x80 | ((cp >> 12) & 0x3F));
        out += (char)(0x80 | ((cp >> 6) & 0x3F));
        out += (char)(0x80 | (cp & 0x3F));
    }
}

// literal string token (without outer parens) -> UTF-8 (latin-1 semantics)
std::string decode_literal(const std::string& inner) {
    std::string out;
    size_t i = 0, n = inner.size();
    while (i < n) {
        unsigned char c = inner[i];
        if (c == '\\' && i + 1 < n) {
            unsigned char nx = inner[i + 1];
            switch (nx) {
                case 'n': out += '\n'; i += 2; continue;
                case 'r': out += '\r'; i += 2; continue;
                case 't': out += '\t'; i += 2; continue;
                case 'b': out += '\b'; i += 2; continue;
                case 'f': out += '\f'; i += 2; continue;
                case '(': out += '('; i += 2; continue;
                case ')': out += ')'; i += 2; continue;
                case '\\': out += '\\'; i += 2; continue;
                default: break;
            }
            if (is_digit(nx)) {  // octal, up to 3 digits (any 0-9 digit,
                size_t j = i + 1; //  matching the Python isdigit() check)
                uint32_t v = 0;
                int cnt = 0;
                while (j < n && cnt < 3 && is_digit(inner[j])) {
                    v = v * 8 + (inner[j] - '0');
                    j++;
                    cnt++;
                }
                append_cp(out, v & 0xFF);
                i = j;
                continue;
            }
            i++;  // lone backslash before other char: drop the backslash
            continue;
        }
        append_cp(out, c);  // latin-1: byte value == codepoint
        i++;
    }
    return out;
}

int hexval(unsigned char c) {
    if (c >= '0' && c <= '9') return c - '0';
    if (c >= 'a' && c <= 'f') return c - 'a' + 10;
    if (c >= 'A' && c <= 'F') return c - 'A' + 10;
    return -1;
}

// UTF-16BE bytes -> UTF-8; returns false on invalid (unpaired surrogate /
// odd tail) when strict; emits U+FFFD when !strict (Python "replace")
bool utf16be_to_utf8(const unsigned char* p, size_t n, std::string& out,
                     bool strict) {
    size_t i = 0;
    while (i + 1 < n) {
        uint32_t u = (p[i] << 8) | p[i + 1];
        i += 2;
        if (u >= 0xD800 && u <= 0xDBFF) {
            if (i + 1 < n) {
                uint32_t lo = (p[i] << 8) | p[i + 1];
                if (lo >= 0xDC00 && lo <= 0xDFFF) {
                    i += 2;
                    append_cp(out,
                              0x10000 + ((u - 0xD800) << 10) + (lo - 0xDC00));
                    continue;
                }
            }
            if (strict) return false;
            append_cp(out, 0xFFFD);
        } else if (u >= 0xDC00 && u <= 0xDFFF) {
            if (strict) return false;
            append_cp(out, 0xFFFD);
        } else {
            append_cp(out, u);
        }
    }
    if (i < n) {  // odd trailing byte
        if (strict) return false;
        append_cp(out, 0xFFFD);
    }
    return true;
}

// hex string token (without <>) -> UTF-8 (mirrors _decode_hex)
std::string decode_hex(const std::string& inner) {
    std::string raw;
    int hi = -1;
    for (unsigned char c : inner) {
        if (is_py_ws(c)) continue;
        int v = hexval(c);
        if (v < 0) continue;  // tokenizer guarantees hex/ws only
        if (hi < 0) {
            hi = v;
        } else {
            raw += (char)((hi << 4) | v);
            hi = -1;
        }
    }
    if (hi >= 0) raw += (char)(hi << 4);  // odd length: pad "0"
    const unsigned char* p = (const unsigned char*)raw.data();
    size_t n = raw.size();
    std::string out;
    if (n >= 2 && p[0] == 0xFE && p[1] == 0xFF) {
        utf16be_to_utf8(p + 2, n - 2, out, false);
        return out;
    }
    if (n >= 2 && p[0] == 0) {
        out.clear();
        if (utf16be_to_utf8(p, n, out, true)) return out;
    }
    out.clear();
    for (size_t i = 0; i < n; i++) append_cp(out, p[i]);  // latin-1
    return out;
}

// ---- content-stream interpretation (mirrors _content_text) ---------------

struct Item {
    enum Kind { STR, NUM, NAME, ARRAY } kind;
    std::string s;          // STR payload (decoded UTF-8)
    double num = 0.0;       // NUM payload
    std::vector<Item> arr;  // ARRAY payload
};

bool op_char(unsigned char c) {
    return is_alpha(c) || c == '\'' || c == '"' || c == '*';
}

std::string content_text(const std::string& content) {
    std::string parts;
    std::vector<Item> stack;
    std::vector<Item> in_array;
    bool array_mode = false;
    size_t i = 0, n = content.size();

    auto push = [&](Item&& it) {
        (array_mode ? in_array : stack).push_back(std::move(it));
    };

    while (i < n) {
        unsigned char c = content[i];
        if (c == '(') {
            // literal string: \((?:\\.|[^\\()])*\)
            size_t j = i + 1;
            bool ok = false;
            while (j < n) {
                unsigned char d = content[j];
                if (d == '\\') {
                    if (j + 1 >= n) break;  // dangling escape: no match
                    j += 2;
                } else if (d == ')') {
                    ok = true;
                    break;
                } else if (d == '(') {
                    break;  // unescaped '(' not matched by the class
                } else {
                    j++;
                }
            }
            if (ok) {
                Item it;
                it.kind = Item::STR;
                it.s = decode_literal(content.substr(i + 1, j - i - 1));
                push(std::move(it));
                i = j + 1;
            } else {
                i++;  // no token matches at '(' — finditer skips the byte
            }
        } else if (c == '<') {
            size_t j = i + 1;
            while (j < n && (hexval(content[j]) >= 0 || is_py_ws(content[j])))
                j++;
            if (j < n && content[j] == '>') {
                Item it;
                it.kind = Item::STR;
                it.s = decode_hex(content.substr(i + 1, j - i - 1));
                push(std::move(it));
                i = j + 1;
            } else {
                i++;  // "<<" dictionary etc: skip
            }
        } else if (c == '[') {
            array_mode = true;
            in_array.clear();
            i++;
        } else if (c == ']') {
            array_mode = false;
            Item it;
            it.kind = Item::ARRAY;
            it.arr = std::move(in_array);
            in_array.clear();
            stack.push_back(std::move(it));
            i++;
        } else if (op_char(c)) {
            size_t j = i;
            while (j < n && op_char(content[j])) j++;
            std::string op = content.substr(i, j - i);
            if (op == "Tj" || op == "'") {
                if (!stack.empty() && stack.back().kind == Item::STR)
                    parts += stack.back().s;
                if (op == "'") parts += '\n';
            } else if (op == "\"") {
                if (!stack.empty() && stack.back().kind == Item::STR)
                    parts += stack.back().s;
                parts += '\n';
            } else if (op == "TJ") {
                if (!stack.empty() && stack.back().kind == Item::ARRAY) {
                    for (const Item& el : stack.back().arr) {
                        if (el.kind == Item::STR)
                            parts += el.s;
                        else if (el.kind == Item::NUM && el.num < -180.0)
                            parts += ' ';  // large kern gap == space
                    }
                }
            } else if (op == "Td" || op == "TD" || op == "T*" || op == "ET") {
                parts += '\n';
            }
            stack.clear();
            i = j;
        } else if (is_digit(c) || c == '+' || c == '-' || c == '.') {
            // number: [-+]?[0-9]*\.?[0-9]+ — the final [0-9]+ forces at
            // least one digit and forbids a trailing dot ("12." -> "12")
            size_t j = i;
            if (content[j] == '+' || content[j] == '-') j++;
            size_t a0 = j;
            while (j < n && is_digit(content[j])) j++;
            size_t a1 = j;
            size_t flen = 0;
            if (j < n && content[j] == '.') {
                size_t k = j + 1;
                while (k < n && is_digit(content[k])) k++;
                flen = k - (j + 1);
                if (flen > 0) j = k;
            }
            if (flen == 0) j = a1;  // dot without fraction: not consumed
            if (a1 > a0 || flen > 0) {
                Item it;
                it.kind = Item::NUM;
                it.num = std::strtod(content.substr(i, j - i).c_str(), nullptr);
                push(std::move(it));
                i = j;
            } else {
                i++;  // bare +/-/.: no token
            }
        } else if (c == '/') {
            size_t j = i + 1;
            while (j < n) {
                unsigned char d = content[j];
                if (is_py_ws(d) || d == '[' || d == ']' || d == '(' ||
                    d == ')' || d == '<' || d == '>' || d == '/')
                    break;
                j++;
            }
            Item it;
            it.kind = Item::NAME;
            it.s = content.substr(i, j - i);
            push(std::move(it));
            i = j;
        } else {
            i++;
        }
    }
    // re.sub(r"[ \t]+\n", "\n"): drop spaces/tabs directly before newlines
    std::string out;
    out.reserve(parts.size());
    for (size_t p = 0; p < parts.size(); p++) {
        char ch = parts[p];
        if (ch == '\n') {
            size_t e = out.size();
            while (e > 0 && (out[e - 1] == ' ' || out[e - 1] == '\t')) e--;
            out.resize(e);
        }
        out += ch;
    }
    return out;
}

// str.strip() emptiness over the UTF-8 output: ASCII whitespace plus the
// two latin-1 Unicode whitespaces (NEL U+0085, NBSP U+00A0) that literal
// strings can produce via latin-1 decoding.
bool all_ws(const std::string& s) {
    size_t i = 0, n = s.size();
    while (i < n) {
        unsigned char c = s[i];
        if (is_py_ws(c) || c == 0x1C || c == 0x1D || c == 0x1E || c == 0x1F) {
            i++;
            continue;
        }
        if (c == 0xC2 && i + 1 < n &&
            ((unsigned char)s[i + 1] == 0x85 ||
             (unsigned char)s[i + 1] == 0xA0)) {
            i += 2;
            continue;
        }
        return false;
    }
    return true;
}

}  // namespace

extern "C" {

// Returns 0 on success (caller frees *out with pdf_free_text); 1 = no
// objects, 2 = no pages, 3 = empty text. Mirrors the PdfExtractionError
// conditions of the Python tier-1 extractor so the wrapper can fall back.
int pdf_extract_text(const uint8_t* data, int64_t len, char** out,
                     int64_t* out_len) {
    std::string pdf((const char*)data, (size_t)len);
    ObjMap objects;
    std::vector<int64_t> scan_order;
    scan_objects(pdf, objects, scan_order);
    if (objects.empty()) return 1;
    std::vector<int64_t> pages = page_order(objects, scan_order);
    if (pages.empty()) return 2;

    std::string text;
    bool first = true;
    for (int64_t pid : pages) {
        if (!first) text += '\f';
        first = false;
        std::string content;
        for (int64_t ref : find_refs_array(objects.at(pid).body, "/Contents"))
            content += object_stream(objects, ref);
        text += content_text(content);
    }
    if (all_ws(text)) return 3;
    *out = (char*)std::malloc(text.size());
    if (*out == nullptr) return 4;
    std::memcpy(*out, text.data(), text.size());
    *out_len = (int64_t)text.size();
    return 0;
}

void pdf_free_text(char* p) { std::free(p); }

}  // extern "C"
