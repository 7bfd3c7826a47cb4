// Native bulk row/key codec — the hot host-side path of the bulk loader
// (reference parity: pkg/lightning local backend's kv encoding loop, which
// is Go there; here the per-row work is C++ so Python only orchestrates).
//
// Formats must match tidb_tpu/kv/rowcodec.py (row value v1) and
// tidb_tpu/utils/codec.py + tidb_tpu/kv/tablecodec.py (memcomparable record
// keys) byte-for-byte; tests assert equality against the Python encoders.
//
// C ABI only (ctypes-friendly): no exceptions across the boundary, plain
// pointers + int64 sizes.

#include <cstdint>
#include <cstring>

namespace {

constexpr uint8_t kRowVersion = 1;
constexpr uint64_t kSignMask = 0x8000000000000000ULL;

// column kinds (mirror: FieldType → physical slot class)
constexpr int32_t kFixedInt = 0;   // int64 little-endian slot
constexpr int32_t kFixedFloat = 1; // double little-endian slot
constexpr int32_t kString = 2;     // varlen: u32 len + bytes

inline void put_u64_be(uint8_t* p, uint64_t v) {
  for (int i = 7; i >= 0; --i) {
    p[i] = static_cast<uint8_t>(v & 0xFF);
    v >>= 8;
  }
}

inline void put_u64_le(uint8_t* p, uint64_t v) {
  std::memcpy(p, &v, 8);
}

inline void put_u32_le(uint8_t* p, uint32_t v) {
  std::memcpy(p, &v, 4);
}

}  // namespace

extern "C" {

// Compute per-row encoded sizes and fill row_starts (n+1 entries, exclusive
// prefix sums). Returns the total buffer size needed.
//
//   kinds[c]        : kFixedInt / kFixedFloat / kString
//   nulls[c]        : uint8[n] (1 = NULL) or nullptr when column has no NULLs
//   str_offsets[c]  : int64[n+1] into the column's byte blob (string cols
//                     only; other cols pass nullptr)
int64_t tpu_encode_rows_size(int64_t n, int32_t ncols, const int32_t* kinds,
                             const uint8_t* const* nulls,
                             const int64_t* const* str_offsets,
                             int64_t* row_starts) {
  int32_t bitmap_len = (ncols + 7) / 8;
  int32_t n_fixed = 0;
  for (int32_t c = 0; c < ncols; ++c)
    if (kinds[c] != kString) ++n_fixed;
  int64_t fixed_size = 1 + bitmap_len + 8LL * n_fixed;
  int64_t off = 0;
  for (int64_t r = 0; r < n; ++r) {
    row_starts[r] = off;
    int64_t sz = fixed_size;
    for (int32_t c = 0; c < ncols; ++c) {
      if (kinds[c] != kString) continue;
      sz += 4;
      if (!(nulls[c] && nulls[c][r])) {
        sz += str_offsets[c][r + 1] - str_offsets[c][r];
      }
    }
    off += sz;
  }
  row_starts[n] = off;
  return off;
}

// Encode n rows into rows_buf (sized by tpu_encode_rows_size) and n record
// keys into keys_buf (19 bytes each: 't' + be(table_id^sign) + "_r" +
// be(handle^sign)).
//
//   data[c] : int64[n] / double[n] for fixed kinds; concatenated UTF-8 blob
//             for kString (indexed by str_offsets[c])
void tpu_encode_rows(int64_t n, int32_t ncols, const int32_t* kinds,
                     const void* const* data, const uint8_t* const* nulls,
                     const int64_t* const* str_offsets,
                     const int64_t* row_starts, uint8_t* rows_buf,
                     int64_t table_id, const int64_t* handles,
                     uint8_t* keys_buf) {
  int32_t bitmap_len = (ncols + 7) / 8;

  // key prefix shared by all rows: 't' + be(table_id ^ sign) + "_r"
  uint8_t prefix[11];
  prefix[0] = 't';
  put_u64_be(prefix + 1, static_cast<uint64_t>(table_id) ^ kSignMask);
  prefix[9] = '_';
  prefix[10] = 'r';

  for (int64_t r = 0; r < n; ++r) {
    uint8_t* out = rows_buf + row_starts[r];
    out[0] = kRowVersion;
    uint8_t* bitmap = out + 1;
    std::memset(bitmap, 0, bitmap_len);
    uint8_t* fixed = out + 1 + bitmap_len;
    uint8_t* var = nullptr;  // computed after fixed section
    int32_t n_fixed = 0;
    for (int32_t c = 0; c < ncols; ++c)
      if (kinds[c] != kString) ++n_fixed;
    var = fixed + 8LL * n_fixed;

    int32_t fslot = 0;
    for (int32_t c = 0; c < ncols; ++c) {
      bool is_null = nulls[c] && nulls[c][r];
      if (is_null) bitmap[c >> 3] |= static_cast<uint8_t>(1u << (c & 7));
      if (kinds[c] == kString) continue;
      uint8_t* slot = fixed + 8LL * fslot++;
      if (is_null) {
        std::memset(slot, 0, 8);
      } else if (kinds[c] == kFixedFloat) {
        std::memcpy(slot, static_cast<const double*>(data[c]) + r, 8);
      } else {
        put_u64_le(slot, static_cast<uint64_t>(
                             static_cast<const int64_t*>(data[c])[r]));
      }
    }
    for (int32_t c = 0; c < ncols; ++c) {
      if (kinds[c] != kString) continue;
      bool is_null = nulls[c] && nulls[c][r];
      if (is_null) {
        put_u32_le(var, 0);
        var += 4;
      } else {
        int64_t s = str_offsets[c][r];
        int64_t e = str_offsets[c][r + 1];
        put_u32_le(var, static_cast<uint32_t>(e - s));
        var += 4;
        std::memcpy(var, static_cast<const uint8_t*>(data[c]) + s, e - s);
        var += e - s;
      }
    }

    uint8_t* key = keys_buf + 19LL * r;
    std::memcpy(key, prefix, 11);
    put_u64_be(key + 11, static_cast<uint64_t>(handles[r]) ^ kSignMask);
  }
}

// Bulk-decode fixed columns out of packed row values (the colcache build
// loop): for each requested column, scatter its 8-byte slot into an int64
// output and its NULL bit into a uint8 validity array.
//
//   starts    : int64[n] offsets of each row in buf
//   cols      : the requested column positions
//   fixed_off : byte offset of each requested column's slot within a row
//   out[c]    : int64[n]; valid[c] : uint8[n]
void tpu_decode_fixed(int64_t n, const uint8_t* buf, const int64_t* starts,
                      int32_t ncols_req, const int32_t* cols,
                      const int32_t* fixed_off, int64_t* const* out,
                      uint8_t* const* valid) {
  for (int64_t r = 0; r < n; ++r) {
    const uint8_t* row = buf + starts[r];
    const uint8_t* bitmap = row + 1;
    for (int32_t i = 0; i < ncols_req; ++i) {
      int32_t c = cols[i];
      bool is_null = (bitmap[c >> 3] >> (c & 7)) & 1;
      valid[i][r] = is_null ? 0 : 1;
      int64_t v;
      std::memcpy(&v, row + fixed_off[i], 8);
      out[i][r] = is_null ? 0 : v;
    }
  }
}

}  // extern "C"
