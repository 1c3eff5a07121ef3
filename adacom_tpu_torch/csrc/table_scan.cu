// Fused compressed table scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel adacom_tpu/ops/pallas_scan.py::
// _build_table_scan. Over a stack of same-width packed segments, one pass
// bit-unpacks every row, masks rows past each segment's end (and NULL rows
// through an optional validity plane), applies an inclusive code-space
// range predicate, and reduces the matching codes to a sum, count, min and
// max per (segment, block).
//
// Bound: bytes. Each packed word is read from HBM exactly once and turned
// into at most 32 rows of register work, so the kernel is limited by the
// packed bytes against HBM bandwidth. Design for that: one thread per lane;
// a thread reads its `W` words at stride `n_lanes`, so neighbouring threads
// read neighbouring addresses (coalesced); the 32 row extractions are
// unrolled with the width as a template parameter, so every shift and word
// index is a constant; the predicate always runs (an open range is
// [0, 0xFFFFFFFF]), which keeps one code path.
//
// Layouts (all little-endian 32-bit, int32 bit-views of uint32 on the
// torch side):
//   words  (n_seg, W, n_lanes)   packed planes, ops/bitpack.py layout
//   scal   (n_seg, 4)            [count, lo_code, hi_code, lanes] per segment
//   valid  (n_seg, n_lanes)      width-1 validity plane (bit r = row r), or
//                                null when every row is valid
//   out    (n_seg, gridDim.y, 4) int64 partials [code_sum, count, min, max]
// Row r of lane l in segment s counts iff l < lanes[s] and
// r * lanes[s] + l < count[s] (the JAX kernel's row-validity rule).
// An empty value range arrives as count = 0 (the caller's saturation).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xFFFFFFFFu;

template <int W>
__global__ void __launch_bounds__(kThreads)
table_scan_kernel(const uint32_t* __restrict__ words,
                  const uint32_t* __restrict__ scal,
                  const uint32_t* __restrict__ valid,
                  long long* __restrict__ out,
                  int n_lanes) {
    const int s = blockIdx.x;
    const uint32_t count = scal[4 * s + 0];
    const uint32_t lo = scal[4 * s + 1];
    const uint32_t span = scal[4 * s + 2] - lo;  // unsigned: may wrap
    const int64_t lanes = scal[4 * s + 3];
    const uint32_t mask = (uint32_t)((1ull << W) - 1ull);

    const uint32_t* seg = words + (size_t)s * W * n_lanes;
    const uint32_t* vseg = valid ? valid + (size_t)s * n_lanes : nullptr;

    unsigned long long sum = 0;
    uint32_t cnt = 0, mn = kFull, mx = 0;

    for (int l = blockIdx.y * kThreads + threadIdx.x; l < n_lanes;
         l += gridDim.y * kThreads) {
        if (l >= lanes) continue;
        uint32_t w[W];
#pragma unroll
        for (int k = 0; k < W; ++k) w[k] = __ldg(seg + (size_t)k * n_lanes + l);
        const uint32_t vbits = vseg ? __ldg(vseg + l) : kFull;
#pragma unroll
        for (int r = 0; r < 32; ++r) {
            const int p = r * W;
            const int k = p >> 5, off = p & 31;
            uint32_t code = w[k] >> off;
            if (off + W > 32) code |= w[k + 1] << (32 - off);
            code &= mask;
            const bool keep = (int64_t)r * lanes + l < (int64_t)count &&
                              ((vbits >> r) & 1u) && (code - lo) <= span;
            if (keep) {
                sum += code;
                cnt += 1;
                mn = min(mn, code);
                mx = max(mx, code);
            }
        }
    }

    // warp reduce, then block reduce through shared memory
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
        sum += __shfl_down_sync(kFull, sum, d);
        cnt += __shfl_down_sync(kFull, cnt, d);
        mn = min(mn, __shfl_down_sync(kFull, mn, d));
        mx = max(mx, __shfl_down_sync(kFull, mx, d));
    }
    __shared__ unsigned long long s_sum[kWarps];
    __shared__ uint32_t s_cnt[kWarps], s_mn[kWarps], s_mx[kWarps];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (lane == 0) {
        s_sum[warp] = sum;
        s_cnt[warp] = cnt;
        s_mn[warp] = mn;
        s_mx[warp] = mx;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        for (int i = 1; i < kWarps; ++i) {
            sum += s_sum[i];
            cnt += s_cnt[i];
            mn = min(mn, s_mn[i]);
            mx = max(mx, s_mx[i]);
        }
        long long* o = out + ((size_t)s * gridDim.y + blockIdx.y) * 4;
        o[0] = (long long)sum;
        o[1] = (long long)cnt;
        o[2] = (long long)mn;
        o[3] = (long long)mx;
    }
}

}  // namespace

extern "C" {

// Threads per block; the wrapper sizes grid.y from it.
int adacom_table_scan_threads() { return kThreads; }

// Launches the scan on `stream`; returns cudaGetLastError() (0 = launched).
// grid = (n_seg, blocks_y); out holds n_seg * blocks_y * 4 int64.
int adacom_table_scan(const void* words, const void* scal, const void* valid,
                      void* out, int n_seg, int width, int n_lanes,
                      int blocks_y, void* stream) {
    if (n_seg < 1 || n_lanes < 1 || blocks_y < 1)
        return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)n_seg, (unsigned)blocks_y);
    const cudaStream_t st = (cudaStream_t)stream;
    const uint32_t* w = (const uint32_t*)words;
    const uint32_t* sc = (const uint32_t*)scal;
    const uint32_t* v = (const uint32_t*)valid;
    long long* o = (long long*)out;
    switch (width) {
#define ADACOM_SCAN_CASE(W) \
    case W: table_scan_kernel<W><<<grid, kThreads, 0, st>>>(w, sc, v, o, n_lanes); break;
        ADACOM_SCAN_CASE(1) ADACOM_SCAN_CASE(2) ADACOM_SCAN_CASE(3)
        ADACOM_SCAN_CASE(4) ADACOM_SCAN_CASE(5) ADACOM_SCAN_CASE(6)
        ADACOM_SCAN_CASE(7) ADACOM_SCAN_CASE(8) ADACOM_SCAN_CASE(9)
        ADACOM_SCAN_CASE(10) ADACOM_SCAN_CASE(11) ADACOM_SCAN_CASE(12)
        ADACOM_SCAN_CASE(13) ADACOM_SCAN_CASE(14) ADACOM_SCAN_CASE(15)
        ADACOM_SCAN_CASE(16) ADACOM_SCAN_CASE(17) ADACOM_SCAN_CASE(18)
        ADACOM_SCAN_CASE(19) ADACOM_SCAN_CASE(20) ADACOM_SCAN_CASE(21)
        ADACOM_SCAN_CASE(22) ADACOM_SCAN_CASE(23) ADACOM_SCAN_CASE(24)
        ADACOM_SCAN_CASE(25) ADACOM_SCAN_CASE(26) ADACOM_SCAN_CASE(27)
        ADACOM_SCAN_CASE(28) ADACOM_SCAN_CASE(29) ADACOM_SCAN_CASE(30)
        ADACOM_SCAN_CASE(31) ADACOM_SCAN_CASE(32)
#undef ADACOM_SCAN_CASE
        default:
            return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
