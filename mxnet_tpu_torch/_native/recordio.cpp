// Native recordio container engine: a copy of the JAX package's
// mxnet_tpu/_native/recordio.cpp (reference roles:
// src/io/iter_image_recordio_2.cc record scanning + dmlc-core recordio
// split reading).
//
// The hot path of a recordio-backed input pipeline is scanning the
// container: magic/flag/length framing, 4-byte padding, multi-part
// record reassembly. That work is branchy byte-level C++ in the
// reference and stays C++ here; Python (ctypes) orchestrates.
//
// Two changes from the copy's source: rio_next tells the end of the
// file (kEof) from an empty record (length 0), which the source
// returned as the end of the file; and the index scan, which no caller
// uses, is left out.
//
// Format (dmlc-core recordio + MXNet):
//   uint32 magic = 0xced7230a
//   uint32 lrec: upper 3 bits cflag (0 whole, 1 first, 2 middle, 3 last),
//                lower 29 bits payload length
//   payload, zero-padded to a multiple of 4 bytes
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0xced7230a;
constexpr uint64_t kEof = UINT64_MAX - 1;

struct Reader {
    FILE* f = nullptr;
    std::vector<uint8_t> buf;
};

inline uint32_t dec_flag(uint32_t x) { return (x >> 29u) & 7u; }
inline uint32_t dec_len(uint32_t x) { return x & ((1u << 29u) - 1u); }

}  // namespace

extern "C" {

void* rio_open(const char* path) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return nullptr;
    auto* r = new Reader();
    r->f = f;
    return r;
}

void rio_close(void* h) {
    if (!h) return;
    auto* r = static_cast<Reader*>(h);
    if (r->f) std::fclose(r->f);
    delete r;
}

void rio_seek(void* h, uint64_t pos) {
    auto* r = static_cast<Reader*>(h);
    std::fseek(r->f, static_cast<long>(pos), SEEK_SET);
}

uint64_t rio_tell(void* h) {
    auto* r = static_cast<Reader*>(h);
    return static_cast<uint64_t>(std::ftell(r->f));
}

// Read the next logical record (reassembling multi-part records).
// Returns its length (0 for an empty record), kEof at the end of the
// file, or UINT64_MAX on corruption.
// The payload pointer is valid until the next rio_* call on this handle.
uint64_t rio_next(void* h, const uint8_t** out) {
    auto* r = static_cast<Reader*>(h);
    r->buf.clear();
    while (true) {
        uint32_t magic = 0, lrec = 0;
        if (std::fread(&magic, 4, 1, r->f) != 1)
            return r->buf.empty() ? kEof : UINT64_MAX;  // EOF
        if (magic != kMagic) return UINT64_MAX;
        if (std::fread(&lrec, 4, 1, r->f) != 1) return UINT64_MAX;
        const uint32_t flag = dec_flag(lrec);
        const uint32_t len = dec_len(lrec);
        const size_t off = r->buf.size();
        r->buf.resize(off + len);
        if (len && std::fread(r->buf.data() + off, 1, len, r->f) != len)
            return UINT64_MAX;
        const uint32_t pad = (4u - (len & 3u)) & 3u;
        if (pad) std::fseek(r->f, pad, SEEK_CUR);
        if (flag == 0 || flag == 3) break;  // whole record or last part
    }
    *out = r->buf.data();
    return r->buf.size();
}

// Writer ---------------------------------------------------------------

void* rio_create(const char* path) {
    FILE* f = std::fopen(path, "wb");
    if (!f) return nullptr;
    auto* r = new Reader();
    r->f = f;
    return r;
}

// Write one logical record (splitting is not needed for len < 2^29).
// Returns the record's start offset, or UINT64_MAX on error.
uint64_t rio_write(void* h, const uint8_t* data, uint64_t len) {
    auto* r = static_cast<Reader*>(h);
    const uint64_t start = static_cast<uint64_t>(std::ftell(r->f));
    const uint32_t kMax = (1u << 29u) - 1u;
    uint64_t off = 0;
    uint32_t part = 0;
    do {
        const uint64_t remain = len - off;
        const uint32_t n = remain > kMax ? kMax : static_cast<uint32_t>(remain);
        uint32_t flag;
        if (part == 0 && n == remain) flag = 0;
        else if (part == 0) flag = 1;
        else if (n == remain) flag = 3;
        else flag = 2;
        const uint32_t lrec = (flag << 29u) | n;
        if (std::fwrite(&kMagic, 4, 1, r->f) != 1) return UINT64_MAX;
        if (std::fwrite(&lrec, 4, 1, r->f) != 1) return UINT64_MAX;
        if (n && std::fwrite(data + off, 1, n, r->f) != n) return UINT64_MAX;
        const uint32_t pad = (4u - (n & 3u)) & 3u;
        const uint32_t zero = 0;
        if (pad && std::fwrite(&zero, 1, pad, r->f) != pad) return UINT64_MAX;
        off += n;
        ++part;
    } while (off < len);
    return start;
}

void rio_flush(void* h) {
    auto* r = static_cast<Reader*>(h);
    std::fflush(r->f);
}

}  // extern "C"
