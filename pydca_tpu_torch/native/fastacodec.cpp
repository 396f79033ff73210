// Native FASTA codec: parse + encode + dedup in one pass.
//
// The port's copy of pydca_tpu/native/fastacodec.cpp (the port imports
// nothing of the JAX package), built with g++ at first use into the
// kernel build cache (pydca_tpu_torch/ops/_build.py).
//
// The host-side ingestion path of pydca_tpu.  Replaces the reference's two
// separate readers (Biopython in Python, plus a second C++ reader inside the
// plmDCA backend, pydca/plmdca/plmdca_numerics.cpp:685-767) with ONE native
// codec shared by every engine: wrapped-line FASTA -> upper-case ->
// 0-based integer states (gap = q-1, non-standard -> gap) -> order-preserving
// dedup on the encoded rows (the Python reference dedups on the encoded form,
// pydca/fasta_reader/fasta_reader.py:143-153).
//
// C ABI (driven from Python via ctypes, see fastacodec.py):
//   fasta_encode(path, table[256], dedup, &data, &n, &l, &ids, &ids_len)
//     data : malloc'd int8 row-major (n x l) matrix of states
//     ids  : malloc'd '\n'-joined header lines of the kept records
//   returns 0 on success, negative error codes otherwise.
//   fasta_free(ptr) frees either buffer.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_set>
#include <vector>

namespace {

struct RowHash {
    size_t operator()(const std::string& s) const {
        // FNV-1a over the encoded row bytes
        size_t h = 1469598103934665603ull;
        for (unsigned char c : s) {
            h ^= c;
            h *= 1099511628211ull;
        }
        return h;
    }
};

}  // namespace

extern "C" {

// Error codes
//  -1 cannot open file, -2 no sequences, -3 unequal lengths,
//  -4 sequence data before first header, -5 allocation failure
int fasta_encode(const char* path, const int8_t* encode_table, int dedup,
                 int8_t** out_data, int32_t* out_n, int32_t* out_l,
                 char** out_ids, int64_t* out_ids_len) {
    FILE* fh = std::fopen(path, "rb");
    if (!fh) return -1;
    std::fseek(fh, 0, SEEK_END);
    long size = std::ftell(fh);
    std::fseek(fh, 0, SEEK_SET);
    std::string buf;
    buf.resize(static_cast<size_t>(size));
    if (size > 0 && std::fread(&buf[0], 1, static_cast<size_t>(size), fh) !=
                        static_cast<size_t>(size)) {
        std::fclose(fh);
        return -1;
    }
    std::fclose(fh);

    std::vector<std::string> ids;
    std::vector<std::string> rows;  // encoded rows
    std::unordered_set<std::string, RowHash> seen;

    std::string cur_id;
    std::string cur_row;
    bool have_record = false;
    int64_t expected_len = -1;
    int rc = 0;

    auto flush = [&]() -> int {
        if (!have_record) return 0;
        if (!cur_row.empty()) {
            if (expected_len < 0) {
                expected_len = static_cast<int64_t>(cur_row.size());
            } else if (static_cast<int64_t>(cur_row.size()) != expected_len) {
                return -3;
            }
            if (!dedup || seen.insert(cur_row).second) {
                ids.push_back(cur_id);
                rows.push_back(cur_row);
            }
        }
        cur_id.clear();
        cur_row.clear();
        return 0;
    };

    size_t pos = 0;
    const size_t len = buf.size();
    while (pos < len && rc == 0) {
        size_t eol = buf.find('\n', pos);
        if (eol == std::string::npos) eol = len;
        size_t b = pos, e = eol;
        // trim whitespace
        while (b < e && (buf[b] == ' ' || buf[b] == '\t' || buf[b] == '\r')) ++b;
        while (e > b &&
               (buf[e - 1] == ' ' || buf[e - 1] == '\t' || buf[e - 1] == '\r'))
            --e;
        if (b < e) {
            if (buf[b] == '>') {
                rc = flush();
                cur_id.assign(buf, b + 1, e - b - 1);
                // strip leading whitespace of id
                size_t k = 0;
                while (k < cur_id.size() &&
                       (cur_id[k] == ' ' || cur_id[k] == '\t'))
                    ++k;
                cur_id.erase(0, k);
                have_record = true;
            } else if (buf[b] == ';') {
                // old-style comment: skip
            } else {
                if (!have_record) {
                    rc = -4;
                    break;
                }
                size_t off = cur_row.size();
                cur_row.resize(off + (e - b));
                for (size_t k = b; k < e; ++k) {
                    cur_row[off + (k - b)] = static_cast<char>(
                        encode_table[static_cast<unsigned char>(buf[k])]);
                }
            }
        }
        pos = eol + 1;
    }
    if (rc == 0) rc = flush();
    if (rc != 0) return rc;
    if (rows.empty()) return -2;

    const int32_t n = static_cast<int32_t>(rows.size());
    const int32_t l = static_cast<int32_t>(expected_len);
    int8_t* data =
        static_cast<int8_t*>(std::malloc(static_cast<size_t>(n) * l));
    if (!data) return -5;
    for (int32_t i = 0; i < n; ++i) {
        std::memcpy(data + static_cast<size_t>(i) * l, rows[i].data(), l);
    }
    std::string ids_blob;
    for (size_t i = 0; i < ids.size(); ++i) {
        if (i) ids_blob += '\n';
        ids_blob += ids[i];
    }
    char* ids_out = static_cast<char*>(std::malloc(ids_blob.size() + 1));
    if (!ids_out) {
        std::free(data);
        return -5;
    }
    std::memcpy(ids_out, ids_blob.data(), ids_blob.size());
    ids_out[ids_blob.size()] = '\0';

    *out_data = data;
    *out_n = n;
    *out_l = l;
    *out_ids = ids_out;
    *out_ids_len = static_cast<int64_t>(ids_blob.size());
    return 0;
}

void fasta_free(void* ptr) { std::free(ptr); }

}  // extern "C"
