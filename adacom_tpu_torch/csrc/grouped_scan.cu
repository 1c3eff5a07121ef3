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
// Bound. The work is about 60 packed bits of HBM traffic a row at TPC-H Q1
// against ~100 integer instructions and one add per output (monomials +
// count), so on this card the instructions and shared-memory accesses per
// row bound it, not the bytes. The design, and what each part is for:
// - Accumulation without contention. A shape whose per-group outputs fit
//   (n_groups * n_out * kThreads * 8 B <= kPrivateBytes) gives every thread
//   private u64 slots in dynamic shared memory, laid out [slot][thread] so a
//   warp's 8-byte accesses never share a bank, updated with a plain +=.
//   Larger shapes (up to 16 groups x 33 outputs) aggregate each warp's row:
//   __match_any_sync forms the peer sets of kept group ids, each set sums a
//   term with two __reduce_add_sync over 16-bit halves (exact: 32 * 0xFFFF
//   < 2^21), and lane 0 adds the total into the warp's copy. The wrapper
//   picks the mode from the shape before the launch.
// - Many rows a thread, few merges. The grid is persistent: as many blocks
//   as fit on the card, each walking a contiguous run of (segment, 128-lane
//   tile) pieces. The block merges its copies (a warp-shuffle tree) and adds
//   them into the per-segment output with global u64 atomics only when its
//   segment changes, about twice a block, not once per 32 rows.
// - Few instructions and registers a row. The kernel is instantiated for
//   2, 4, 8 and 14 bit readers (planes of width > 0; width-0 planes fold
//   into per-segment constants; reader slots past the shape's are inert, so
//   the row loop has no per-plane branch). Each plane's first predicate is
//   tested on its codes as they are decoded, and a row's values go to
//   shared memory only once the row is kept (Q6 keeps ~2%). Up to 4 readers
//   __launch_bounds__ asks for 8 blocks of 128 threads per SM (<= 64
//   registers); 8 and 14 readers get up to 128, since their shapes (Q1's 42
//   slots a thread) already hold the SM to 4 blocks by shared memory, and a
//   64-register cap there made the row loop slower, not the SM fuller.
// - Loads in flight. Each reader holds the word it decodes and, already
//   loaded, the next one; crossing into that word issues the load of the
//   one after, so a plane's load has a row or more of work to hide behind
//   and all planes' loads are in flight together. Shared memory split: all
//   of it goes to accumulators (plus 5 KB of per-thread value rows), since
//   accumulator bytes set the occupancy at Q1's shape; staging tiles through
//   shared memory would cost blocks per SM for latency that the register
//   prefetch and the other resident warps already hide (a plane's width
//   barely moves the time: the rows, not the words, cost).
// What bounds it after the change: at Q1's and B2's shapes, the kept
// rows' accumulation (value rows, monomial products and the u64
// read-modify-write of each output's slot) at 16-28 warps per SM; at Q6's,
// the decode's integer instructions.
//
// Layouts (little-endian 32-bit words, int32 bit-views on the torch side):
//   plane   (n_seg, w, lanes_k) packed words, ops/bitpack.py layout; a
//                               stack narrower than n_lanes reads as code 0
//   scal    (n_seg, 32)         uint32 [count, lanes, gmin[6], vmin[8],
//                               (lo, hi)[8]] per segment
//   out     (n_seg, n_groups, n_mono + 1) int64, zeroed by the caller
// Row r of lane l in segment s counts iff l < lanes[s],
// r * lanes[s] + l < count[s], every predicate holds, and the group id
// sum_j (gcode_j + gmin_j) * stride_j (mod 2^32) is below n_groups. A
// value is code + vmin and a monomial the product of its values, all mod
// 2^32 like the Pallas kernel. A range empty for a segment arrives as
// count = 0 (the caller's saturation).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGP = 6;    // group planes
constexpr int kMaxVP = 8;    // value planes
constexpr int kMaxReaders = kMaxGP + kMaxVP;
constexpr int kMaxMonos = 32;
constexpr int kMaxGroups = 16;
constexpr int kPrivateBytes = 48 * 1024;  // private slots of one block
constexpr int kScalCols = 32;
constexpr int kScCount = 0, kScLanes = 1, kScGmin = 2, kScVmin = 8,
              kScPred = 16;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kOnes = kMaxVP;       // value row holding 1 (absent factor)
constexpr int kSink = kMaxVP + 1;   // value row group readers write to
constexpr int kValRows = kMaxVP + 2;

struct Desc {
    // readers: planes of width > 0, group planes first, then value planes;
    // slots past n_read are inert (width 0: code 0, no loads, no effect)
    const uint32_t* words[kMaxReaders];
    int width[kMaxReaders];
    uint32_t mask[kMaxReaders];
    int lanes[kMaxReaders];       // lanes of the reader's stack (word stride)
    uint32_t mul[kMaxReaders];    // group reader: its plane's stride; else 0
    int vdst[kMaxReaders];        // value reader: its plane; else kSink
    int vmin_col[kMaxReaders];    // scal column of the value minimum, or -1
    int ipred[kMaxReaders];       // predicate tested on the reader's codes, -1
    uint32_t stride[kMaxGP];      // every group plane, width 0 included
    uint32_t mono[kMaxMonos];     // value rows p0 | p1 << 8 | p2 << 16
    int pred[kMaxVP];             // value plane of predicate q
    int xpred[kMaxVP];            // predicates tested on values (the rest)
    uint32_t const_vp;            // bit p: value plane p has width 0
    int n_read, n_gp, n_vp, n_mono, n_xpred, n_groups, n_out;
    int n_lanes, tiles, n_pieces;
};

// Adds the block's accumulators into segment row `o` and zeroes them.
template <bool kPrivate>
__device__ void flush(unsigned long long* acc, unsigned long long* o,
                      int n_slots) {
    __syncthreads();
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    if (kPrivate) {
        for (int i = warp; i < n_slots; i += kWarps) {
            unsigned long long* a = acc + (size_t)i * kThreads;
            unsigned long long v = 0ull;
#pragma unroll
            for (int t = 0; t < kThreads; t += 32) {
                v += a[t + lane];
                a[t + lane] = 0ull;
            }
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
                v += __shfl_down_sync(kFull, v, off);
            if (lane == 0 && v) atomicAdd(o + i, v);
        }
    } else {
        for (int i = tid; i < n_slots; i += kThreads) {
            unsigned long long v = 0ull;
#pragma unroll
            for (int w = 0; w < kWarps; ++w) {
                v += acc[w * n_slots + i];
                acc[w * n_slots + i] = 0ull;
            }
            if (v) atomicAdd(o + i, v);
        }
    }
    __syncthreads();
}

template <int kReaders, bool kPrivate>
__global__ void __launch_bounds__(kThreads, kReaders <= 4 ? 8 : 4)
grouped_scan_kernel(const Desc d, const uint32_t* __restrict__ scal,
                    unsigned long long* __restrict__ out) {
    // private: [slot][thread]; warp mode: [warp][slot]; slot = g * n_out + m
    extern __shared__ unsigned long long s_acc[];
    __shared__ uint32_t s_val[kValRows][kThreads];  // a kept row's values
    __shared__ uint32_t s_xlo[kMaxVP], s_xspan[kMaxVP];

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int n_slots = d.n_groups * d.n_out;
    const int n_acc = kPrivate ? n_slots * kThreads : n_slots * kWarps;
    for (int i = tid; i < n_acc; i += kThreads) s_acc[i] = 0ull;
    s_val[kOnes][tid] = 1u;

    const int p0 = (int)((long long)blockIdx.x * d.n_pieces / gridDim.x);
    const int p1 = (int)((long long)(blockIdx.x + 1) * d.n_pieces / gridDim.x);
    int cur = -1, rend = 0;
    uint32_t count = 0u, lanes = 0u, gbase = 0u;
    // per reader and segment: the predicate's code-space lo and span (an
    // open one for a reader without), and the value minimum
    uint32_t plo[kReaders], pspan[kReaders], vadd[kReaders];
    for (int p = p0; p < p1; ++p) {
        const int s = p / d.tiles;
        const int tile0 = (p - s * d.tiles) * kThreads;
        if (s != cur) {  // block-uniform: a new segment's constants
            if (cur >= 0)
                flush<kPrivate>(s_acc, out + (size_t)cur * n_slots, n_slots);
            const uint32_t* sc = scal + (size_t)s * kScalCols;
            count = sc[kScCount];
            lanes = sc[kScLanes];
            rend = lanes == 0u || count == 0u ? 0
                : (int)min(32u, (count - 1u) / lanes + 1u);
            gbase = 0u;
            for (int j = 0; j < d.n_gp; ++j) gbase += sc[kScGmin + j] * d.stride[j];
#pragma unroll
            for (int k = 0; k < kReaders; ++k) {
                const int q = d.ipred[k];
                plo[k] = q < 0 ? 0u : sc[kScPred + 2 * q];
                pspan[k] = q < 0 ? kFull : sc[kScPred + 2 * q + 1] - plo[k];
                vadd[k] = d.vmin_col[k] < 0 ? 0u : sc[d.vmin_col[k]];
            }
            if (tid < d.n_xpred) {
                // a value-space test: the value carries + vmin, so shift lo
                const int q = d.xpred[tid];
                const uint32_t lo = sc[kScPred + 2 * q];
                s_xspan[tid] = sc[kScPred + 2 * q + 1] - lo;
                s_xlo[tid] = lo + sc[kScVmin + d.pred[q]];
            }
            for (int q = 0; q < d.n_vp; ++q)
                if ((d.const_vp >> q) & 1u) s_val[q][tid] = sc[kScVmin + q];
            __syncthreads();
            cur = s;
        }
        if (rend == 0 || (uint32_t)tile0 >= lanes) continue;  // no live lane

        const int l = tile0 + tid;
        const bool lv = (uint32_t)l < lanes && l < d.n_lanes;
        // rows r of this lane with r * lanes + l < count
        const int nrows = lv && count > (uint32_t)l
            ? (int)min(32u, (count - 1u - (uint32_t)l) / lanes + 1u) : 0;
        uint32_t lo[kReaders], hi[kReaders], pos[kReaders];  // words, bit
#pragma unroll
        for (int k = 0; k < kReaders; ++k) {
            lo[k] = hi[k] = pos[k] = 0u;
            if (d.width[k] > 0 && lv && l < d.lanes[k]) {
                const uint32_t* w = d.words[k]
                    + (size_t)s * d.width[k] * d.lanes[k] + l;
                lo[k] = __ldg(w);
                if (d.width[k] > 1) hi[k] = __ldg(w + d.lanes[k]);
            }
        }
        for (int r = 0; r < rend; ++r) {
            uint32_t grp = gbase;
            bool keep = r < nrows;
            uint32_t code[kReaders];
#pragma unroll
            for (int k = 0; k < kReaders; ++k) {
                const int w = d.width[k];
                code[k] = __funnelshift_r(lo[k], hi[k], pos[k]) & d.mask[k];
                grp += code[k] * d.mul[k];
                keep = keep & (code[k] - plo[k] <= pspan[k]);
                pos[k] += w;
                if (pos[k] >= 32u) {  // the next row starts in the next word
                    pos[k] -= 32u;
                    lo[k] = hi[k];
                    const int j = (int)(((uint32_t)(r + 1) * w) >> 5) + 1;
                    hi[k] = j < w && lv && l < d.lanes[k]
                        ? __ldg(d.words[k]
                                + ((size_t)s * w + j) * d.lanes[k] + l)
                        : 0u;
                }
            }
            keep = keep && grp < (uint32_t)d.n_groups;
            if (keep) {
#pragma unroll
                for (int k = 0; k < kReaders; ++k)
                    s_val[d.vdst[k]][tid] = code[k] + vadd[k];
                for (int i = 0; i < d.n_xpred; ++i)
                    keep = keep && s_val[d.pred[d.xpred[i]]][tid] - s_xlo[i]
                                       <= s_xspan[i];
            }
            if (kPrivate) {
                if (keep) {
                    unsigned long long* a =
                        s_acc + (size_t)grp * d.n_out * kThreads + tid;
                    for (int m = 0; m < d.n_mono; ++m) {
                        const uint32_t pk = d.mono[m];
                        a[m * kThreads] += s_val[pk & 0xFFu][tid]
                            * s_val[(pk >> 8) & 0xFFu][tid]
                            * s_val[pk >> 16][tid];
                    }
                    a[d.n_mono * kThreads] += 1ull;
                }
            } else {
                const unsigned peers =
                    __match_any_sync(kFull, keep ? grp : kFull);
                unsigned live = __ballot_sync(kFull, keep);
                while (live) {  // one peer set (one group) at a time
                    const int leader = __ffs(live) - 1;
                    const unsigned set = __shfl_sync(kFull, peers, leader);
                    const uint32_t g = __shfl_sync(kFull, grp, leader);
                    live &= ~set;
                    const bool mine = (set >> lane) & 1u;
                    unsigned long long* a =
                        s_acc + warp * n_slots + g * d.n_out;
                    for (int m = 0; m < d.n_mono; ++m) {
                        const uint32_t pk = d.mono[m];
                        const uint32_t t = mine
                            ? s_val[pk & 0xFFu][tid]
                                * s_val[(pk >> 8) & 0xFFu][tid]
                                * s_val[pk >> 16][tid]
                            : 0u;
                        const unsigned lo16 = __reduce_add_sync(kFull, t & 0xFFFFu);
                        const unsigned hi16 = __reduce_add_sync(kFull, t >> 16);
                        if (lane == 0)
                            a[m] += lo16 + ((unsigned long long)hi16 << 16);
                    }
                    if (lane == 0) a[d.n_mono] += (unsigned long long)__popc(set);
                }
            }
        }
    }
    if (cur >= 0) flush<kPrivate>(s_acc, out + (size_t)cur * n_slots, n_slots);
}

using Kernel = void (*)(Desc, const uint32_t*, unsigned long long*);

template <int R>
Kernel pick_mode(int priv) {
    return priv ? grouped_scan_kernel<R, true> : grouped_scan_kernel<R, false>;
}

Kernel pick(int readers_cap, int priv) {
    switch (readers_cap) {
        case 2: return pick_mode<2>(priv);
        case 4: return pick_mode<4>(priv);
        case 8: return pick_mode<8>(priv);
        case 14: return pick_mode<14>(priv);
        default: return nullptr;
    }
}

size_t acc_bytes(int priv, int n_groups, int n_out) {
    return (size_t)n_groups * n_out * (priv ? kThreads : kWarps)
        * sizeof(unsigned long long);
}

}  // namespace

extern "C" {

// Threads per block; the wrapper sizes the tiles from it.
int adacom_grouped_scan_threads() { return kThreads; }

// Blocks of the (readers_cap, priv) instantiation that fit on one SM for a
// shape of n_groups x n_out accumulators; a negative CUDA error on failure.
int adacom_grouped_scan_blocks_per_sm(int readers_cap, int priv, int n_groups,
                                      int n_out) {
    const Kernel k = pick(readers_cap, priv);
    if (k == nullptr || n_groups < 1 || n_out < 1)
        return -(int)cudaErrorInvalidValue;
    const size_t shmem = acc_bytes(priv, n_groups, n_out);
    cudaError_t e = cudaFuncSetAttribute(
        (const void*)k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    int blocks = 0;
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, (const void*)k, kThreads, shmem);
    return e == cudaSuccess ? blocks : -(int)e;
}

// Launches the grouped scan on `stream`; returns the launch's CUDA error
// (0 = launched). Host arrays: planes[14] (device pointers, null for a
// width-0 or absent plane; group slots 0..5, value slots 6..13),
// widths[14], plane_lanes[14] (each stack's lane count, <= n_lanes),
// strides[6], monos[n_mono * 3] (-1 pads), preds[n_pred]. readers_cap (2,
// 4, 8 or 14) and priv (1: private slots, 0: warp aggregation) pick the
// instantiation; n_blocks persistent blocks share the n_seg *
// ceil(n_lanes / threads) pieces. out holds n_seg * n_groups * (n_mono + 1)
// int64, zeroed.
int adacom_multi_grouped_scan(const void* const* planes, const int* widths,
                              const int* plane_lanes, const unsigned* strides,
                              const int* monos, const int* preds, int n_gp,
                              int n_vp, int n_mono, int n_pred, int n_groups,
                              const void* scal, void* out, int n_seg,
                              int n_lanes, int readers_cap, int priv,
                              int n_blocks, void* stream) {
    const Kernel k = pick(readers_cap, priv);
    const long long tiles = ((long long)n_lanes + kThreads - 1) / kThreads;
    const long long n_pieces = (long long)n_seg * tiles;
    if (k == nullptr || n_gp < 0 || n_gp > kMaxGP || n_vp < 0 ||
        n_vp > kMaxVP || n_mono < 0 || n_mono > kMaxMonos || n_pred < 0 ||
        n_pred > kMaxVP || n_groups < 1 || n_groups > kMaxGroups ||
        n_seg < 1 || n_lanes < 1 || n_pieces > 0x7FFFFFFFll ||
        n_blocks < 1 || n_blocks > n_pieces ||
        (priv && acc_bytes(1, n_groups, n_mono + 1) > (size_t)kPrivateBytes))
        return (int)cudaErrorInvalidValue;
    Desc d = {};
    for (int i = 0; i < kMaxReaders; ++i) {
        d.vdst[i] = kSink;
        d.vmin_col[i] = -1;
        d.ipred[i] = -1;
    }
    int reader_of[kMaxVP];  // value plane -> its reader, -1 for width 0
    for (int i = 0; i < kMaxReaders; ++i) {
        const bool group = i < kMaxGP;
        const bool used = group ? i < n_gp : i - kMaxGP < n_vp;
        if (widths[i] < 0 || widths[i] > 32 ||
            (used && widths[i] > 0 &&
             (planes[i] == nullptr || plane_lanes[i] < 1 ||
              plane_lanes[i] > n_lanes)))
            return (int)cudaErrorInvalidValue;
        if (!group) reader_of[i - kMaxGP] = -1;
        if (!used) continue;
        if (widths[i] == 0) {
            if (!group) d.const_vp |= 1u << (i - kMaxGP);
            continue;
        }
        const int r = d.n_read++;
        if (r >= readers_cap) return (int)cudaErrorInvalidValue;
        d.words[r] = (const uint32_t*)planes[i];
        d.width[r] = widths[i];
        d.mask[r] = 0xFFFFFFFFu >> (32 - widths[i]);
        d.lanes[r] = plane_lanes[i];
        if (group) {
            d.mul[r] = strides[i];
        } else {
            d.vdst[r] = i - kMaxGP;
            d.vmin_col[r] = kScVmin + i - kMaxGP;
            reader_of[i - kMaxGP] = r;
        }
    }
    for (int j = 0; j < n_gp; ++j) d.stride[j] = strides[j];
    for (int m = 0; m < n_mono; ++m) {
        uint32_t pk = 0u;
        for (int t = 0; t < 3; ++t) {
            const int p = monos[3 * m + t];
            if (p < -1 || p >= n_vp || (t == 0 && p < 0))
                return (int)cudaErrorInvalidValue;
            pk |= (uint32_t)(p < 0 ? kOnes : p) << (8 * t);
        }
        d.mono[m] = pk;
    }
    // a plane's first predicate is tested on its reader's codes; the
    // rest (and those on width-0 planes) on the kept row's values
    for (int q = 0; q < n_pred; ++q) {
        const int p = preds[q];
        if (p < 0 || p >= n_vp) return (int)cudaErrorInvalidValue;
        d.pred[q] = p;
        const int r = reader_of[p];
        if (r >= 0 && d.ipred[r] < 0) d.ipred[r] = q;
        else d.xpred[d.n_xpred++] = q;
    }
    d.n_gp = n_gp;
    d.n_vp = n_vp;
    d.n_mono = n_mono;
    d.n_groups = n_groups;
    d.n_out = n_mono + 1;
    d.n_lanes = n_lanes;
    d.tiles = (int)tiles;
    d.n_pieces = (int)n_pieces;
    const size_t shmem = acc_bytes(priv, n_groups, n_mono + 1);
    cudaError_t e = cudaFuncSetAttribute(
        (const void*)k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (e != cudaSuccess) return (int)e;
    const uint32_t* sc = (const uint32_t*)scal;
    unsigned long long* o = (unsigned long long*)out;
    void* args[] = {&d, &sc, &o};
    e = cudaLaunchKernel((const void*)k, dim3((unsigned)n_blocks),
                         dim3(kThreads), args, shmem, (cudaStream_t)stream);
    return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

}  // extern "C"
