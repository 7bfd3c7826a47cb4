// K1: exact grouped COUNT and SUM over (value, weight) lanes into B buckets.
//
// Replaces tidb_tpu/ops/pallas_groupby.py:_build_call (the Pallas kernel
// launched by pl.pallas_call at :64 and called through grouped_sums at :79).
// The TPU kernel splits each value into 8-bit limbs and accumulates a one-hot
// f32 matrix product, because the MXU has no exact integer accumulate. This
// kernel keeps the contract (every count and sum exact in int64, dead rows at
// seg < 0 or seg >= B ignored, a row adds to a lane only where its weight is
// set) and accumulates with integer atomics in shared memory instead.
//
// Bound: memory. The kernel must read seg for every row and, for every live
// row, each distinct weight column and each non-constant value slot. At the
// 160-bucket band query (4,194,304 rows, 3.0 M live, three weight columns,
// two int32 value slots) that is about 50 MB, 15 us at the H100's 3.35 TB/s.
//
// What the design does about each cost of a per-block int64 table indexed
// s * L + l with two 64-bit shared atomics per lane and row:
//   (a) Lane-major tables. Cell c of bucket s sits at (c * B + s) * R + copy,
//       so the rows of one cell spread over the banks by bucket.
//   (b) One count cell per distinct weight column (lanes that share a weight
//       tensor share it), and none of a constant lane's values is read
//       (lo == hi: its sum is count * lo at the flush). Lanes sharing their
//       (value, weight) tensors share one value slot.
//   (c) 32-bit cells. A value slot is biased by its proven lower bound and
//       cut into 16-bit pieces, one u32 cell each. A block takes at most
//       K1_ROWS_PER_BLOCK = 65,536 rows (the launcher sizes the grid so) and
//       65,536 * (2^16 - 1) < 2^32, so no cell wraps. Four pieces cover any
//       64-bit offset, so the sums are exact modulo 2^64 like int64 adds.
//   (d) R = 4 lane-striped copies of the table (fewer where 4 do not fit in
//       half the SM's shared memory): thread t adds to copy t % R, so at most
//       8 lanes of a warp meet on one address when every row falls in one
//       bucket. Of 1, 4, 8 and 32 copies and warp pre-aggregation, 4 copies
//       measured fastest both on the band query and with every row in one
//       bucket: more copies cost more to zero and fold than they save.
//   (e) Each thread takes 4 consecutive rows per step: one 16-byte seg load,
//       one 4-byte weight load per weight column, 16-byte value loads. seg is
//       loaded a step ahead, and a step issues the weight words of its first
//       K1_WB columns and the values of its first K1_VB4 int32 slots before
//       its first add, so it waits on memory about once, not once per lane.
//       int32 and int64 slots run in separate loops; lanes are not branched
//       on per row.
//   (f) A persistent grid: as many 512-thread blocks as are resident; block
//       b takes steps b, b + grid, ... of 2,048 rows, so a dead tail of
//       padding rows is spread over all blocks. At the end a block folds its
//       copies, recombines each (bucket, lane) into int64 and adds it to the
//       output with one global atomic; a block that saw no live row skips
//       the flush.
// Integer adds commute, so the result is bit-exact and deterministic.
//
// Two macros serve the stress build only (one table copy, the fewest
// blocks, so a block's whole share of rows lands in one set of cells):
// K1_REPLICAS and K1_GRID. The library the port loads takes their defaults.

#include <cuda_runtime.h>

#ifndef K1_REPLICAS
#define K1_REPLICAS 4  // table copies (a power of two), fewer where they do not fit
#endif
#ifndef K1_GRID
#define K1_GRID 0  // blocks asked for: 0 = as many as are resident
#endif

#define K1_THREADS 512
#define K1_ROWS 4  // rows per thread per step (one 16-byte seg load)
#define K1_WB 4    // weight columns whose words a step loads before its adds
#define K1_VB4 4   // int32 slots whose values a step loads before its adds
#define K1_VB8 2   // int64 slots loaded together, a batch at a time
#define K1_MAX_W 32  // weight columns, value slots and lanes per launch
#define K1_MAX_V 32
#define K1_MAX_L 32
#define K1_ROWS_PER_BLOCK 65536LL  // 65,536 * (2^16 - 1) < 2^32
#define K1_PIECE_BITS 16
#define K1_SMEM_MAX (227 * 1024)

struct K1Plan {
    const int* seg;
    long long n;      // rows
    int B, nw, nv4, nv8, L, out_stride, ncells, R;
    const unsigned char* w[K1_MAX_W];  // distinct weight columns: cells [0, nw)
    const void* v[K1_MAX_V];           // value slots: int32 ones first, then int64
    long long vlo[K1_MAX_V];           // the slot's bias (proven lower bound)
    int vw[K1_MAX_V];                  // the slot's weight column
    int vp[K1_MAX_V];                  // its 16-bit pieces
    int vc[K1_MAX_V];                  // its first cell
    int lcol[K1_MAX_L];                // per lane: output column,
    int lw[K1_MAX_L];                  // weight column,
    int lv[K1_MAX_L];                  // value slot or -1 (constant lane),
    long long llo[K1_MAX_L];           // and the constant lane's value
};

__device__ __forceinline__ int k1_pos(const K1Plan& p, int cell, int s) { return cell * p.B + s; }

// The word holding position x's total after the fold: copy x % R, so that
// consecutive positions fall on consecutive banks.
__device__ __forceinline__ int k1_total(const K1Plan& p, int x) { return x * p.R + (x & (p.R - 1)); }

__device__ __forceinline__ void k1_add(unsigned* tab, const K1Plan& p, int cell, int s, bool has, unsigned val,
                                       int lane) {
    if (has) atomicAdd(&tab[k1_pos(p, cell, s) * p.R + (lane & (p.R - 1))], val);
}

// Rows r..r+3 of seg, or -1 (dead) from row n on.
__device__ __forceinline__ void k1_load_seg(const int* seg, long long r, long long n, int (&s)[K1_ROWS]) {
    if (r >= n) {
#pragma unroll
        for (int j = 0; j < K1_ROWS; ++j) s[j] = -1;
        return;
    }
    const int4 x = __ldg(reinterpret_cast<const int4*>(seg + r));
    s[0] = x.x, s[1] = x.y, s[2] = x.z, s[3] = x.w;
}

// The weight bytes of the step's rows, as one word.
__device__ __forceinline__ unsigned k1_wword(const unsigned char* w, long long r) {
    return __ldg(reinterpret_cast<const unsigned*>(w + r));
}

// Bit j set where row j's weight byte is nonzero.
__device__ __forceinline__ unsigned k1_bits(unsigned x) {
    return (x & 0xffu ? 1u : 0u) | (x & 0xff00u ? 2u : 0u) | (x & 0xff0000u ? 4u : 0u) | (x & 0xff000000u ? 8u : 0u);
}

__device__ __forceinline__ void k1_load_v4(const void* v, long long r, int (&x)[K1_ROWS]) {
    const int4 a = __ldg(reinterpret_cast<const int4*>(static_cast<const int*>(v) + r));
    x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
}

__device__ __forceinline__ void k1_load_v8(const void* v, long long r, long long (&x)[K1_ROWS]) {
    const long long* p = static_cast<const long long*>(v) + r;
    const longlong2 a = __ldg(reinterpret_cast<const longlong2*>(p));
    const longlong2 b = __ldg(reinterpret_cast<const longlong2*>(p + 2));
    x[0] = a.x, x[1] = a.y, x[2] = b.x, x[3] = b.y;
}

// The weight word of slot k's column: from the words already loaded for the
// first K1_WB columns, else loaded now.
__device__ __forceinline__ unsigned k1_slot_word(const K1Plan& p, int k, const unsigned (&ww)[K1_WB], unsigned live,
                                                 long long r) {
    const int c = p.vw[k];
    unsigned word = 0;
#pragma unroll
    for (int t = 0; t < K1_WB; ++t)
        if (c == t) word = ww[t];
    if (c >= K1_WB && live) word = k1_wword(p.w[c], r);
    return word;
}

template <typename V>
__device__ __forceinline__ void k1_add_slot(unsigned* tab, const K1Plan& p, int k, const int (&s)[K1_ROWS],
                                            unsigned bits, const V (&x)[K1_ROWS], int lane) {
    if (!bits) return;
    const unsigned long long lo = static_cast<unsigned long long>(p.vlo[k]);
#pragma unroll
    for (int j = 0; j < K1_ROWS; ++j) {
        const unsigned long long u = static_cast<unsigned long long>(static_cast<long long>(x[j])) - lo;
        const bool has = (bits >> j) & 1u;
        for (int q = 0; q < p.vp[k]; ++q) {
            const unsigned piece = static_cast<unsigned>(u >> (K1_PIECE_BITS * q)) & 0xffffu;
            k1_add(tab, p, p.vc[k] + q, s[j], has && piece, piece, lane);
        }
    }
}

__global__ void __launch_bounds__(K1_THREADS, 2)
    k1_grouped_sums(const K1Plan p, unsigned long long* __restrict__ counts, unsigned long long* __restrict__ sums) {
    extern __shared__ __align__(16) unsigned char k1_smem[];
    unsigned* tab = reinterpret_cast<unsigned*>(k1_smem);
    const int npos = p.ncells * p.B;
    {
        uint4* t4 = reinterpret_cast<uint4*>(k1_smem);
        const int n16 = static_cast<int>((static_cast<size_t>(npos) * p.R * sizeof(unsigned) + 15) / 16);
        for (int i = threadIdx.x; i < n16; i += K1_THREADS) t4[i] = make_uint4(0u, 0u, 0u, 0u);
    }
    __syncthreads();

    const int lane = threadIdx.x & 31;
    // block b takes steps b, b + grid, ...: live and dead rows spread evenly
    // over the blocks. A warp covers 32 * K1_ROWS consecutive rows of a step,
    // so the trip count is the same for all its lanes. seg is loaded a step
    // ahead, and every weight word and value vector of a step is loaded
    // before its first add.
    const long long step = static_cast<long long>(K1_THREADS) * K1_ROWS;
    const long long nsteps = (p.n + step - 1) / step;
    const long long hop = static_cast<long long>(gridDim.x) * step;
    bool seen = false;
    int next[K1_ROWS];
    k1_load_seg(p.seg, blockIdx.x * step + threadIdx.x * K1_ROWS, p.n, next);
    for (long long i = blockIdx.x; i < nsteps; i += gridDim.x) {
        const long long r = i * step + threadIdx.x * K1_ROWS;
        int s[K1_ROWS];
        unsigned live = 0;
#pragma unroll
        for (int j = 0; j < K1_ROWS; ++j) {
            s[j] = next[j];
            live |= (static_cast<unsigned>(s[j]) < static_cast<unsigned>(p.B) ? 1u : 0u) << j;
        }
        k1_load_seg(p.seg, r + hop, p.n, next);
        if (!live) continue;
        seen |= live != 0;

        unsigned ww[K1_WB];
#pragma unroll
        for (int t = 0; t < K1_WB; ++t) ww[t] = live && t < p.nw ? k1_wword(p.w[t], r) : 0u;
        int x4[K1_VB4][K1_ROWS];
#pragma unroll
        for (int k = 0; k < K1_VB4; ++k) {
            if (live && k < p.nv4) {
                k1_load_v4(p.v[k], r, x4[k]);
            } else {
#pragma unroll
                for (int j = 0; j < K1_ROWS; ++j) x4[k][j] = 0;
            }
        }

#pragma unroll
        for (int t = 0; t < K1_WB; ++t) {
            if (t < p.nw) {
                const unsigned bits = live & k1_bits(ww[t]);
#pragma unroll
                for (int j = 0; j < K1_ROWS; ++j) k1_add(tab, p, t, s[j], (bits >> j) & 1u, 1u, lane);
            }
        }
        for (int c = K1_WB; c < p.nw; ++c) {
            const unsigned bits = live ? live & k1_bits(k1_wword(p.w[c], r)) : 0u;
#pragma unroll
            for (int j = 0; j < K1_ROWS; ++j) k1_add(tab, p, c, s[j], (bits >> j) & 1u, 1u, lane);
        }
#pragma unroll
        for (int k = 0; k < K1_VB4; ++k)
            if (k < p.nv4) k1_add_slot(tab, p, k, s, live & k1_bits(k1_slot_word(p, k, ww, live, r)), x4[k], lane);
        for (int k = K1_VB4; k < p.nv4; ++k) {
            const unsigned bits = live & k1_bits(k1_slot_word(p, k, ww, live, r));
            int x[K1_ROWS] = {};
            if (bits) k1_load_v4(p.v[k], r, x);
            k1_add_slot(tab, p, k, s, bits, x, lane);
        }
        for (int k0 = p.nv4; k0 < p.nv4 + p.nv8; k0 += K1_VB8) {
            long long x8[K1_VB8][K1_ROWS];
#pragma unroll
            for (int t = 0; t < K1_VB8; ++t) {
                if (live && k0 + t < p.nv4 + p.nv8) {
                    k1_load_v8(p.v[k0 + t], r, x8[t]);
                } else {
#pragma unroll
                    for (int j = 0; j < K1_ROWS; ++j) x8[t][j] = 0;
                }
            }
#pragma unroll
            for (int t = 0; t < K1_VB8; ++t)
                if (k0 + t < p.nv4 + p.nv8)
                    k1_add_slot(tab, p, k0 + t, s, live & k1_bits(k1_slot_word(p, k0 + t, ww, live, r)), x8[t], lane);
        }
    }
    if (!__syncthreads_or(seen)) return;

    // fold the R copies of each position into copy x % R; each thread reads
    // and writes only its own positions, staggered so a warp's reads spread
    // over the banks. A block's total stays below 2^32 (see (c)).
    if (p.R > 1) {
        for (int x = threadIdx.x; x < npos; x += K1_THREADS) {
            unsigned t = 0;
            for (int q = 0; q < p.R; ++q) t += tab[x * p.R + ((q + lane) & (p.R - 1))];
            tab[k1_total(p, x)] = t;
        }
        __syncthreads();
    }
    for (int i = threadIdx.x; i < p.L * p.B; i += K1_THREADS) {
        const int l = i / p.B, b = i - l * p.B;
        const unsigned long long cnt = tab[k1_total(p, k1_pos(p, p.lw[l], b))];
        if (!cnt) continue;  // no weighted row: the sum is zero too
        const int k = p.lv[l];
        unsigned long long sum;
        if (k < 0) {
            sum = cnt * static_cast<unsigned long long>(p.llo[l]);
        } else {
            sum = cnt * static_cast<unsigned long long>(p.vlo[k]);
            for (int q = 0; q < p.vp[k]; ++q)
                sum += static_cast<unsigned long long>(tab[k1_total(p, k1_pos(p, p.vc[k] + q, b))]) << (K1_PIECE_BITS * q);
        }
        const long long o = static_cast<long long>(b) * p.out_stride + p.lcol[l];
        atomicAdd(&counts[o], cnt);
        atomicAdd(&sums[o], sum);
    }
}

static int k1_sms(int dev) {
    static int cache[64];
    if (dev < 0 || dev >= 64) return 0;
    if (cache[dev] <= 0) {
        int v = 0;
        if (cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
        cache[dev] = v;
    }
    return cache[dev];
}

// Plain C entry point, loaded with ctypes. `d` is the launch descriptor the
// wrapper (tidb_tpu_torch/ops/grouped_sums.py) packs as int64s:
//   seg, n, B, out_stride, L, nw, nv4, nv8,
//   nw weight pointers,
//   nv4 + nv8 slots (values, lo, weight column, pieces), int32 slots first,
//   L lanes (output column, weight column, slot or -1, constant value).
// `out` is the (2, B, out_stride) int64 output: counts, then sums; with
// zero_out set it is zeroed on the stream first. Returns the cudaError_t of
// the launch (0 = launched).
extern "C" int tt_k1_grouped_sums(const long long* d, unsigned long long* out, int zero_out, void* stream_) {
    cudaStream_t stream = static_cast<cudaStream_t>(stream_);
    K1Plan p;
    p.seg = reinterpret_cast<const int*>(d[0]);
    p.n = d[1];
    p.B = static_cast<int>(d[2]);
    p.out_stride = static_cast<int>(d[3]);
    p.L = static_cast<int>(d[4]);
    p.nw = static_cast<int>(d[5]);
    p.nv4 = static_cast<int>(d[6]);
    p.nv8 = static_cast<int>(d[7]);
    const int nv = p.nv4 + p.nv8;
    if (p.n <= 0 || p.n % 4 || p.B <= 0 || p.L <= 0 || p.L > K1_MAX_L || p.out_stride < p.L || p.nw <= 0 ||
        p.nw > K1_MAX_W || p.nv4 < 0 || p.nv8 < 0 || nv > K1_MAX_V)
        return static_cast<int>(cudaErrorInvalidValue);
    const long long* q = d + 8;
    for (int c = 0; c < p.nw; ++c) p.w[c] = reinterpret_cast<const unsigned char*>(q[c]);
    q += p.nw;
    int cells = p.nw;
    for (int k = 0; k < nv; ++k, q += 4) {
        p.v[k] = reinterpret_cast<const void*>(q[0]);
        p.vlo[k] = q[1];
        p.vw[k] = static_cast<int>(q[2]);
        p.vp[k] = static_cast<int>(q[3]);
        p.vc[k] = cells;
        if (p.vw[k] < 0 || p.vw[k] >= p.nw || q[3] < 1 || q[3] > 4) return static_cast<int>(cudaErrorInvalidValue);
        cells += p.vp[k];
    }
    for (int l = 0; l < p.L; ++l, q += 4) {
        p.lcol[l] = static_cast<int>(q[0]);
        p.lw[l] = static_cast<int>(q[1]);
        p.lv[l] = static_cast<int>(q[2]);
        p.llo[l] = q[3];
        if (p.lcol[l] < 0 || p.lcol[l] >= p.out_stride || p.lw[l] < 0 || p.lw[l] >= p.nw || p.lv[l] < -1 ||
            p.lv[l] >= nv)
            return static_cast<int>(cudaErrorInvalidValue);
    }
    p.ncells = cells;

    const size_t table = static_cast<size_t>(cells) * p.B * sizeof(unsigned);
    int R = K1_REPLICAS;
    while (R > 1 && table * R > K1_SMEM_MAX / 2) R >>= 1;
    p.R = R;
    const size_t smem = (table * R + 15) & ~static_cast<size_t>(15);
    if (smem > K1_SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);

    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    static bool attr_set[64];
    if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
    if (!attr_set[dev]) {
        e = cudaFuncSetAttribute(k1_grouped_sums, cudaFuncAttributeMaxDynamicSharedMemorySize, K1_SMEM_MAX);
        if (e != cudaSuccess) return static_cast<int>(e);
        attr_set[dev] = true;
    }
    long long grid = K1_GRID;
    if (grid <= 0) {
        // the occupancy query costs host time; the last answer per device
        // is kept with the shared-memory size it was asked for
        static size_t occ_smem[64];
        static int occ_bps[64];
        if (occ_bps[dev] <= 0 || occ_smem[dev] != smem) {
            int bps = 0;
            e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&bps, k1_grouped_sums, K1_THREADS, smem);
            if (e != cudaSuccess) return static_cast<int>(e);
            occ_smem[dev] = smem;
            occ_bps[dev] = bps;
        }
        grid = static_cast<long long>(k1_sms(dev)) * occ_bps[dev];
        if (grid <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
    }
    // no more blocks than steps, and never so few that a block takes more
    // than K1_ROWS_PER_BLOCK rows
    const long long step = static_cast<long long>(K1_THREADS) * K1_ROWS;
    const long long nsteps = (p.n + step - 1) / step;
    const long long per_block = K1_ROWS_PER_BLOCK / step;
    grid = grid < nsteps ? grid : nsteps;
    grid = grid > (nsteps + per_block - 1) / per_block ? grid : (nsteps + per_block - 1) / per_block;

    if (zero_out) {
        e = cudaMemsetAsync(out, 0, 2 * static_cast<size_t>(p.B) * p.out_stride * sizeof(unsigned long long), stream);
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    k1_grouped_sums<<<static_cast<unsigned>(grid), K1_THREADS, smem, stream>>>(
        p, out, out + static_cast<size_t>(p.B) * p.out_stride);
    return static_cast<int>(cudaGetLastError());
}
