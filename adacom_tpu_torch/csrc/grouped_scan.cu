// Fused grouped compressed scan for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of adacom_tpu/ops/pallas_scan.py:
// _build_multi_grouped_scan (B3) and _build_grouped_scan (B2). B2 is the
// special case of one group plane, one value plane whose minimum the
// wrapper leaves out of the scalar table, and the monomial (v,).
//
// Over a stack of segments that share their plane widths, one pass
// bit-unpacks every group plane and value plane of every row, masks rows
// past each segment's end, applies a conjunction of code-space range
// predicates, forms the mixed-radix group id, and adds each monomial (a
// product of up to three values) and a count into per-group accumulators.
//
// Bound: the accumulation, not the bytes. Each row costs one shared-memory
// atomicAdd per output (monomials + count), against about 60 packed bits
// of HBM traffic for TPC-H Q1, so the kernel is bound by shared-memory
// atomics long before HBM bandwidth. Design for a simple, right first
// kernel: one thread per lane, a grid of (segment, lane block), each plane
// read through a 64-bit bit reader that loads every packed word exactly
// once (coalesced across the lanes of a warp) at any runtime width, and
// per-(group, output) u64 accumulators in shared memory, one private copy
// per warp, merged at block end into one partial per (segment, block).
//
// Layouts (little-endian 32-bit words, int32 bit-views on the torch side):
//   plane   (n_seg, w, n_lanes)  packed words, ops/bitpack.py layout
//   scal    (n_seg, 32)          uint32 [count, lanes, gmin[6], vmin[8],
//                                (lo, hi)[8]] per segment
//   out     (n_seg, gridDim.y, n_groups, n_mono + 1) int64 partials
// Row r of lane l in segment s counts iff l < lanes[s],
// r * lanes[s] + l < count[s], every predicate holds, and the group id
// sum_j (gcode_j + gmin_j) * stride_j (mod 2^32) is below n_groups. A
// value is code + vmin and a monomial the product of its values, all mod
// 2^32 like the Pallas kernel. A range empty for a segment arrives as
// count = 0 (the caller's saturation).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGP = 6;    // group planes
constexpr int kMaxVP = 8;    // value planes
constexpr int kMaxPlanes = kMaxGP + kMaxVP;
constexpr int kMaxMonos = 32;
constexpr int kMaxGroups = 16;
constexpr int kScalCols = 32;
constexpr int kScCount = 0, kScLanes = 1, kScGmin = 2, kScVmin = 8,
              kScPred = 16;

struct Desc {
    const uint32_t* words[kMaxPlanes];  // group planes, then value planes
    int width[kMaxPlanes];              // 0 = constant plane (code 0)
    uint32_t stride[kMaxGP];
    signed char mono[kMaxMonos][3];     // value-plane indices, -1 pads
    signed char pred[kMaxVP];           // value-plane index of predicate q
    int n_gp, n_vp, n_mono, n_pred, n_groups, n_lanes;
};

// Sequential reader of one lane's codes: row r's code is bits
// [r*w, r*w + w) of the lane's words, so rows in order consume the words
// in order, each loaded once.
struct BitReader {
    const uint32_t* p;
    unsigned long long buf;
    int nbits;

    __device__ __forceinline__ uint32_t next(int w, int n_lanes) {
        if (nbits < w) {
            buf |= (unsigned long long)__ldg(p) << nbits;
            p += n_lanes;
            nbits += 32;
        }
        const uint32_t code =
            (uint32_t)buf & (uint32_t)((1ull << w) - 1ull);
        buf >>= w;
        nbits -= w;
        return code;
    }
};

__global__ void __launch_bounds__(kThreads)
grouped_scan_kernel(const Desc d, const uint32_t* __restrict__ scal,
                    long long* __restrict__ out) {
    extern __shared__ unsigned long long s_acc[];  // [warp][group][output]
    __shared__ uint32_t s_val[kMaxVP][kThreads];

    const int s = blockIdx.x;
    const int tid = threadIdx.x;
    const int n_out = d.n_mono + 1;
    const int per_warp = d.n_groups * n_out;
    for (int i = tid; i < kWarps * per_warp; i += kThreads) s_acc[i] = 0ull;
    __syncthreads();

    const uint32_t* sc = scal + (size_t)s * kScalCols;
    const int64_t count = sc[kScCount];
    const int64_t lanes = sc[kScLanes];
    uint32_t gmin[kMaxGP], vmin[kMaxVP], plo[kMaxVP], pspan[kMaxVP];
#pragma unroll
    for (int j = 0; j < kMaxGP; ++j) gmin[j] = sc[kScGmin + j];
#pragma unroll
    for (int p = 0; p < kMaxVP; ++p) vmin[p] = sc[kScVmin + p];
#pragma unroll
    for (int q = 0; q < kMaxVP; ++q) {
        // the predicate tests code - lo; values carry + vmin, so shift lo
        const uint32_t lo = sc[kScPred + 2 * q];
        pspan[q] = sc[kScPred + 2 * q + 1] - lo;
        plo[q] = q < d.n_pred ? lo + sc[kScVmin + d.pred[q]] : 0u;
    }
    unsigned long long* acc = s_acc + (tid >> 5) * per_warp;

    for (int l = blockIdx.y * kThreads + tid; l < d.n_lanes;
         l += gridDim.y * kThreads) {
        BitReader br[kMaxPlanes];
#pragma unroll
        for (int i = 0; i < kMaxPlanes; ++i) {
            br[i].p = d.words[i] == nullptr ? nullptr
                : d.words[i] + (size_t)s * d.width[i] * d.n_lanes + l;
            br[i].buf = 0ull;
            br[i].nbits = 0;
        }
        for (int r = 0; r < 32; ++r) {
            bool keep = l < lanes && (int64_t)r * lanes + l < count;
            uint32_t grp = 0u;
#pragma unroll
            for (int j = 0; j < kMaxGP; ++j) {
                if (j < d.n_gp) {
                    const uint32_t code = d.width[j]
                        ? br[j].next(d.width[j], d.n_lanes) : 0u;
                    grp += (code + gmin[j]) * d.stride[j];
                }
            }
#pragma unroll
            for (int p = 0; p < kMaxVP; ++p) {
                if (p < d.n_vp) {
                    const int i = kMaxGP + p;
                    const uint32_t code = d.width[i]
                        ? br[i].next(d.width[i], d.n_lanes) : 0u;
                    s_val[p][tid] = code + vmin[p];
                }
            }
#pragma unroll
            for (int q = 0; q < kMaxVP; ++q) {
                if (q < d.n_pred)
                    keep = keep && (s_val[d.pred[q]][tid] - plo[q]) <= pspan[q];
            }
            if (keep && grp < (uint32_t)d.n_groups) {
                unsigned long long* a = acc + grp * n_out;
                for (int m = 0; m < d.n_mono; ++m) {
                    uint32_t term = s_val[d.mono[m][0]][tid];
                    if (d.mono[m][1] >= 0) term *= s_val[d.mono[m][1]][tid];
                    if (d.mono[m][2] >= 0) term *= s_val[d.mono[m][2]][tid];
                    atomicAdd(a + m, (unsigned long long)term);
                }
                atomicAdd(a + d.n_mono, 1ull);
            }
        }
    }

    __syncthreads();
    long long* o = out + ((size_t)s * gridDim.y + blockIdx.y) * per_warp;
    for (int i = tid; i < per_warp; i += kThreads) {
        unsigned long long sum = 0ull;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) sum += s_acc[w * per_warp + i];
        o[i] = (long long)sum;
    }
}

}  // namespace

extern "C" {

// Threads per block; the wrapper sizes grid.y from it.
int adacom_grouped_scan_threads() { return kThreads; }

// Launches the grouped scan on `stream`; returns cudaGetLastError()
// (0 = launched). Host arrays: planes[14] (device pointers, null for a
// width-0 or absent plane; group slots 0..5, value slots 6..13),
// widths[14], strides[6], monos[n_mono * 3] (-1 pads), preds[n_pred].
// grid = (n_seg, blocks_y); out holds n_seg * blocks_y * n_groups *
// (n_mono + 1) int64.
int adacom_multi_grouped_scan(const void* const* planes, const int* widths,
                              const unsigned* strides, const int* monos,
                              const int* preds, int n_gp, int n_vp,
                              int n_mono, int n_pred, int n_groups,
                              const void* scal, void* out, int n_seg,
                              int n_lanes, int blocks_y, void* stream) {
    if (n_gp < 0 || n_gp > kMaxGP || n_vp < 0 || n_vp > kMaxVP ||
        n_mono < 0 || n_mono > kMaxMonos || n_pred < 0 || n_pred > kMaxVP ||
        n_groups < 1 || n_groups > kMaxGroups || n_seg < 1 || n_lanes < 1 ||
        blocks_y < 1 || blocks_y > 65535)
        return (int)cudaErrorInvalidValue;
    Desc d = {};
    for (int i = 0; i < kMaxPlanes; ++i) {
        const bool used = i < kMaxGP ? i < n_gp : i - kMaxGP < n_vp;
        if (widths[i] < 0 || widths[i] > 32 ||
            (used && widths[i] > 0 && planes[i] == nullptr))
            return (int)cudaErrorInvalidValue;
        d.width[i] = used && planes[i] != nullptr ? widths[i] : 0;
        d.words[i] = d.width[i] ? (const uint32_t*)planes[i] : nullptr;
    }
    for (int j = 0; j < kMaxGP; ++j) d.stride[j] = j < n_gp ? strides[j] : 0u;
    for (int m = 0; m < n_mono; ++m) {
        for (int k = 0; k < 3; ++k) {
            const int p = monos[3 * m + k];
            if (p < -1 || p >= n_vp || (k == 0 && p < 0))
                return (int)cudaErrorInvalidValue;
            d.mono[m][k] = (signed char)p;
        }
    }
    for (int q = 0; q < n_pred; ++q) {
        if (preds[q] < 0 || preds[q] >= n_vp) return (int)cudaErrorInvalidValue;
        d.pred[q] = (signed char)preds[q];
    }
    d.n_gp = n_gp;
    d.n_vp = n_vp;
    d.n_mono = n_mono;
    d.n_pred = n_pred;
    d.n_groups = n_groups;
    d.n_lanes = n_lanes;
    const size_t shmem =
        (size_t)kWarps * n_groups * (n_mono + 1) * sizeof(unsigned long long);
    const dim3 grid((unsigned)n_seg, (unsigned)blocks_y);
    grouped_scan_kernel<<<grid, kThreads, shmem, (cudaStream_t)stream>>>(
        d, (const uint32_t*)scal, (long long*)out);
    return (int)cudaGetLastError();
}

}  // extern "C"
