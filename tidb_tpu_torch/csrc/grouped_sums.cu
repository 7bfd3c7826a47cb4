// K1: exact grouped COUNT and SUM over L (value, weight) lanes into B buckets.
//
// Replaces tidb_tpu/ops/pallas_groupby.py:_build_call (the Pallas kernel
// launched by pl.pallas_call at :64 and called through grouped_sums at :79).
// The TPU kernel splits each value into 8-bit limbs and accumulates a one-hot
// f32 matrix product, because the MXU has no exact int64 accumulate. Hopper
// has 64-bit integer atomics in shared memory, so this kernel keeps the
// contract (every count and sum exact in int64, dead rows ignored) and drops
// the limb layout:
//
//   * a grid-stride loop over rows;
//   * each block owns a private B x L table of int64 counts and sums in
//     dynamic shared memory (16 bytes per cell: 8 KB per lane at B = 512);
//   * a live row adds 1 and its value to its bucket's cells with 64-bit
//     shared atomicAdd (as unsigned long long: two's-complement wrap is the
//     same modular sum the reference's int64 recombination gives);
//   * at the end the block flushes each non-empty cell to the global output
//     with one global atomicAdd.
// Integer atomics commute, so the result is bit-exact and deterministic.
//
// Rows with seg < 0 or seg >= B are dead; a row adds to lane l only where
// its weight w[l] is nonzero. Value lanes are int32 or int64 (the engine
// keeps binder-proven narrow lanes in int32).
//
// Bound: memory. The kernel must read n * (4 + sum over lanes of
// (value bytes + 1)) bytes; at the 160-bucket band query (n = 4,194,304,
// L = 4 lanes: two int64, two int32) that is 134 MB, about 40 us at the
// H100's 3.35 TB/s. Shared-atomic contention on hot buckets is the expected
// limit of this simple design; making it fast is later work.

#include <cuda_runtime.h>

#define GS_MAX_LANES 16
#define GS_THREADS 256

struct GsLanes {
    const void* vals[GS_MAX_LANES];
    const unsigned char* w[GS_MAX_LANES];
    int val_bytes[GS_MAX_LANES];  // 4 (int32 lane) or 8 (int64 lane)
};

__global__ void __launch_bounds__(GS_THREADS) grouped_sums_kernel(
    const int* __restrict__ seg, GsLanes lanes, int L, long long n, int B, int out_stride,
    unsigned long long* __restrict__ counts, unsigned long long* __restrict__ sums) {
    extern __shared__ unsigned long long smem[];
    unsigned long long* s_cnt = smem;
    unsigned long long* s_sum = smem + B * L;
    for (int i = threadIdx.x; i < 2 * B * L; i += blockDim.x) smem[i] = 0ULL;
    __syncthreads();

    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < n; r += stride) {
        const int s = seg[r];
        if (s < 0 || s >= B) continue;
        for (int l = 0; l < L; ++l) {
            if (lanes.w[l][r]) {
                const long long v = lanes.val_bytes[l] == 8
                                        ? static_cast<const long long*>(lanes.vals[l])[r]
                                        : (long long)static_cast<const int*>(lanes.vals[l])[r];
                atomicAdd(&s_cnt[s * L + l], 1ULL);
                atomicAdd(&s_sum[s * L + l], (unsigned long long)v);
            }
        }
    }
    __syncthreads();

    for (int i = threadIdx.x; i < B * L; i += blockDim.x) {
        const unsigned long long c = s_cnt[i];
        if (c) {  // an empty cell has a zero sum too: only weighted rows add
            const int b = i / L, l = i % L;
            atomicAdd(&counts[(long long)b * out_stride + l], c);
            atomicAdd(&sums[(long long)b * out_stride + l], s_sum[i]);
        }
    }
}

// Plain C entry point, loaded with ctypes. counts/sums point at column l0 of
// zeroed (B, out_stride) int64 outputs; vals/w/val_bytes hold L <= 16 lanes.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int tt_grouped_sums(const int* seg, const void* const* vals, const unsigned char* const* w,
                               const int* val_bytes, int L, long long n, int B, int out_stride,
                               unsigned long long* counts, unsigned long long* sums, int grid,
                               void* stream) {
    if (L <= 0 || L > GS_MAX_LANES || B <= 0 || grid <= 0) return (int)cudaErrorInvalidValue;
    GsLanes lanes;
    for (int l = 0; l < GS_MAX_LANES; ++l) {
        lanes.vals[l] = l < L ? vals[l] : nullptr;
        lanes.w[l] = l < L ? w[l] : nullptr;
        lanes.val_bytes[l] = l < L ? val_bytes[l] : 8;
        if (l < L && val_bytes[l] != 4 && val_bytes[l] != 8) return (int)cudaErrorInvalidValue;
    }
    const size_t smem = 2 * (size_t)B * L * sizeof(unsigned long long);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(grouped_sums_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    grouped_sums_kernel<<<grid, GS_THREADS, smem, (cudaStream_t)stream>>>(seg, lanes, L, n, B, out_stride,
                                                                         counts, sums);
    return (int)cudaGetLastError();
}
