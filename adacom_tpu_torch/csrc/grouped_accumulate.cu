// Grouped accumulate: one chunk of a dense GROUP BY added into the scan's
// running accumulators, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package's grouped partials are XLA's
// scatter (adacom_tpu/ops/agg.py grouped_partial). In the port the same step
// in PyTorch ops (ops/agg.py grouped_partial, the plain version) sends every
// row the filter rejects to a spare slot and scatters it all the same, one
// index_add_ / scatter_reduce_ per spec, into a new accumulator per chunk
// that is then merged into the running one. Where the filter keeps 1 row in
// 28 nearly every atomic lands on that one spare address, at the rate of
// atomics on one L2 address (about 1.15 ns each on an H100).
//
// Here one launch adds a chunk's kept rows of every spec (count, sum, sumsq,
// min, max over int64 or float64 accumulators) into the running
// accumulators in place.
//
// Bound: bytes. Every row reads its mask byte; a kept row reads its group
// id (8 B) and one 8-byte value per non-count spec, and the memory moves
// them in 32-byte sectors; a rejected row issues no other memory operation.
// So a chunk needs its n mask bytes plus 32 B an array for every sector of
// four rows that holds a kept one: at 1 row in 28 kept, 13.5% of the
// sectors, about 1 + 1.1 x (1 + value specs) bytes a row.
//
// Design for that: a warp takes 512 rows at once, each lane 16 with one
// 16-byte load of their mask bytes (a coalesced 512-byte run), and loads
// its next 512 before it works on these. The lanes then pack the kept rows'
// offsets into a per-warp list in shared memory (a prefix sum of their
// counts across the warp), and the whole warp works through the list, one
// kept row a lane and two a lane in flight: the kept rows' group ids and
// values are loaded by all 32 lanes at once, side by side where rows are
// dense, instead of one lane walking its own kept rows one round trip after
// another while the others wait.
//
// The one hot address: no rejected row touches memory, so the filter makes
// no address hot. Real groups can still be few (a small domain), where rows
// of one group would queue on one global address. When domain x specs x 8 B
// fits 40 KB (with the 8 KB of the warps' lists, the 48 KB a block gets
// without an opt-in, leaving four blocks of 256 threads on an SM), each
// block keeps private accumulators in shared memory and flushes its
// non-neutral slots with one global atomic each; the grid then has at most
// one block per `slots` rows, so the flush issues no more global atomics
// than the chunk has rows. Otherwise (the benchmark's 100,000 supplier
// groups: 800 KB a spec, resident in the 50 MB L2) kept rows go to global
// atomics directly.
//
// Atomics: native 64-bit atomicAdd (two's complement, so exact and
// order-free for int64), atomicMin / atomicMax on long long, atomicAdd on
// double (float sums differ from the plain version by the order of
// addition); float min and max by a compare-and-swap loop in which a NaN
// sticks, as torch's scatter_reduce amin / amax on the CPU.
//
// Layouts: gid (n,) int64 dense group ids in [0, domain) (an id outside is
// skipped); mask (n,) bool, 16-byte aligned; per spec an (n,) value array of
// the accumulator's type read at i * vstride (vstride 0: a constant), none
// for a count; per spec a (domain,) accumulator.

#include <atomic>
#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSpecs = 32;
constexpr int kSmemBytes = 40 * 1024;  // accumulators of the shared regime
constexpr int kRowsPerLoad = 16;        // rows of a lane's mask load
constexpr int kWarpRows = 32 * kRowsPerLoad;
constexpr int kBatch = 2;               // kept rows a lane has in flight

// op = kind * 2 + type; kind 0 count, 1 sum, 2 sumsq, 3 min, 4 max; type 0
// int64, 1 float64 (a count is int64)
enum : int {
    kCount = 0,
    kSumI = 2, kSumF = 3,
    kSumsqI = 4, kSumsqF = 5,
    kMinI = 6, kMinF = 7,
    kMaxI = 8, kMaxF = 9,
};

struct Spec {
    const void* values;
    void* acc;
    long long vstride;
    int op;
};

struct Specs {
    Spec s[kMaxSpecs];
    int n;
};

// The slot's neutral value as bits: what the accumulator starts from.
__device__ __forceinline__ unsigned long long neutral(int op) {
    switch (op) {
        case kMinI: return (unsigned long long)INT64_MAX;
        case kMaxI: return (unsigned long long)INT64_MIN;
        case kMinF: return (unsigned long long)__double_as_longlong(DBL_MAX);
        case kMaxF: return (unsigned long long)__double_as_longlong(-DBL_MAX);
        default: return 0ull;
    }
}

// min (lower) or max of a double slot; a NaN already there stays, a NaN
// value replaces what is there
template <bool kLower>
__device__ __forceinline__ void atomic_extreme(double* slot, double v) {
    unsigned long long* p = (unsigned long long*)slot;
    unsigned long long old = *(volatile unsigned long long*)p;
    while (true) {
        const double cur = __longlong_as_double((long long)old);
        if (cur != cur) return;  // NaN
        if (v == v && (kLower ? !(v < cur) : !(v > cur))) return;
        const unsigned long long seen =
            atomicCAS(p, old, (unsigned long long)__double_as_longlong(v));
        if (seen == old) return;
        old = seen;
    }
}

// Adds value bits v (the row's value, or 1 for a count) into slot by op.
__device__ __forceinline__ void apply(int op, unsigned long long* slot,
                                      unsigned long long v) {
    switch (op) {
        case kCount:
        case kSumI:
            atomicAdd(slot, v);
            break;
        case kSumsqI:
            atomicAdd(slot, v * v);  // mod 2^64, as int64 wraps
            break;
        case kMinI:
            atomicMin((long long*)slot, (long long)v);
            break;
        case kMaxI:
            atomicMax((long long*)slot, (long long)v);
            break;
        case kSumF:
            atomicAdd((double*)slot, __longlong_as_double((long long)v));
            break;
        case kSumsqF: {
            const double d = __longlong_as_double((long long)v);
            atomicAdd((double*)slot, d * d);
            break;
        }
        case kMinF:
            atomic_extreme<true>((double*)slot,
                                 __longlong_as_double((long long)v));
            break;
        case kMaxF:
            atomic_extreme<false>((double*)slot,
                                  __longlong_as_double((long long)v));
            break;
    }
}

// The mask bytes of lane vector t (rows 16t .. 16t+15) as four words with
// 1 in each kept row's byte; bytes past n read as rejected.
__device__ __forceinline__ uint4 mask_vector(const uint8_t* __restrict__ mask,
                                             long long n, long long t) {
    unsigned w[4] = {0u, 0u, 0u, 0u};
    if ((t + 1) * kRowsPerLoad <= n) {
        const uint4 m = __ldg((const uint4*)mask + t);
        w[0] = m.x, w[1] = m.y, w[2] = m.z, w[3] = m.w;
    } else {
        for (long long i = t * kRowsPerLoad; i < n; ++i) {
            const int r = (int)(i - t * kRowsPerLoad);
            w[r >> 2] |= (unsigned)mask[i] << ((r & 3) * 8);
        }
    }
    return make_uint4(__vcmpne4(w[0], 0u) & 0x01010101u,
                      __vcmpne4(w[1], 0u) & 0x01010101u,
                      __vcmpne4(w[2], 0u) & 0x01010101u,
                      __vcmpne4(w[3], 0u) & 0x01010101u);
}

// Entries j0 + 32q (q < kBatch, below total; j0 is the lane's first) of a
// warp's list of kept rows: every spec's value of each into its slot. The
// group ids are loaded together, then each spec's values together.
template <bool kShared>
__device__ __forceinline__ void add_kept(const long long* __restrict__ gid,
                                         long long base,
                                         const unsigned short* list, int j0,
                                         int total, long long domain,
                                         const Specs& specs,
                                         unsigned long long* smem) {
    long long row[kBatch], g[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
        const int j = j0 + 32 * q;
        row[q] = j < total ? base + list[j] : -1;
        g[q] = row[q] >= 0 ? __ldg(gid + row[q]) : -1;
    }
    for (int s = 0; s < specs.n; ++s) {
        const Spec& sp = specs.s[s];
        unsigned long long* acc =
            kShared ? smem + (long long)s * domain : (unsigned long long*)sp.acc;
        unsigned long long v[kBatch];
#pragma unroll
        for (int q = 0; q < kBatch; ++q)
            v[q] = sp.op == kCount ? 1ull
                   : row[q] >= 0
                       ? (unsigned long long)__ldg((const long long*)sp.values +
                                                   row[q] * sp.vstride)
                       : 0ull;
#pragma unroll
        for (int q = 0; q < kBatch; ++q)
            // an empty entry (-1) and an id outside the domain fail this
            if ((unsigned long long)g[q] < (unsigned long long)domain)
                apply(sp.op, acc + g[q], v[q]);
    }
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
accumulate_kernel(const long long* __restrict__ gid,
                  const uint8_t* __restrict__ mask, long long n,
                  long long domain, const Specs specs) {
    extern __shared__ unsigned long long smem[];  // the shared regime's slots
    __shared__ unsigned short lists[kThreads / 32][kWarpRows];
    if (kShared) {
        for (long long k = threadIdx.x; k < (long long)specs.n * domain;
             k += kThreads)
            smem[k] = neutral(specs.s[k / domain].op);
        __syncthreads();
    }
    const int lane = threadIdx.x & 31;
    unsigned short* list = lists[threadIdx.x >> 5];
    // warp w takes lane vectors 32w .. 32w+31; the loop is warp-uniform
    const long long n_vec = (n + kRowsPerLoad - 1) / kRowsPerLoad;
    const long long warps = (long long)gridDim.x * (kThreads / 32);
    long long w = (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
    uint4 next = mask_vector(mask, n, w * 32 + lane);
    for (; w * 32 < n_vec; w += warps) {
        const uint4 m = next;
        next = mask_vector(mask, n, (w + warps) * 32 + lane);
        const int count = __popc(m.x) + __popc(m.y) + __popc(m.z) + __popc(m.w);
        int end = count;  // inclusive prefix sum of the lanes' counts
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int y = __shfl_up_sync(0xFFFFFFFFu, end, d);
            if (lane >= d) end += y;
        }
        const int total = __shfl_sync(0xFFFFFFFFu, end, 31);
        if (total == 0) continue;
        int at = end - count;
        const unsigned words[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
        for (int q = 0; q < 4; ++q)
            for (unsigned bits = words[q]; bits; bits &= bits - 1)
                list[at++] = (unsigned short)(lane * kRowsPerLoad + q * 4 +
                                              ((__ffs(bits) - 1) >> 3));
        __syncwarp();
        for (int j0 = lane; j0 - lane < total; j0 += 32 * kBatch)
            add_kept<kShared>(gid, w * kWarpRows, list, j0, total, domain,
                              specs, smem);
        __syncwarp();  // the list is read before it is written again
    }
    if (kShared) {
        __syncthreads();
        for (long long k = threadIdx.x; k < (long long)specs.n * domain;
             k += kThreads) {
            const Spec& sp = specs.s[k / domain];
            const unsigned long long v = smem[k];
            if (v == neutral(sp.op)) continue;
            unsigned long long* slot =
                (unsigned long long*)sp.acc + k % domain;
            // a block's count, sum and sumsq are partial sums: add them
            apply(sp.op == kSumsqI ? kSumI : sp.op == kSumsqF ? kSumF
                                                                : sp.op,
                  slot, v);
        }
    }
}

// Blocks for a launch: `want`, at most as many as are resident on the card
// at once. The SM count (per device) and the blocks an SM holds (per regime
// and shared-memory size) are asked once each and kept.
constexpr int kMaxDevices = 64;
std::atomic<int> sm_counts[kMaxDevices];
std::atomic<int> global_per_sm;
std::atomic<int> shared_per_sm[kSmemBytes / 8 + 1];

int blocks_for(bool shared, int smem_bytes, long long want) {
    int dev = 0;
    cudaGetDevice(&dev);
    std::atomic<int>* sms_kept = dev < kMaxDevices ? &sm_counts[dev] : nullptr;
    int sms = sms_kept ? sms_kept->load(std::memory_order_relaxed) : 0;
    if (sms == 0) {
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (sms < 1) sms = 1;
        if (sms_kept) sms_kept->store(sms, std::memory_order_relaxed);
    }
    std::atomic<int>& kept = shared ? shared_per_sm[smem_bytes / 8]
                                    : global_per_sm;
    int per_sm = kept.load(std::memory_order_relaxed);
    if (per_sm == 0) {
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm,
            shared ? (const void*)accumulate_kernel<true>
                   : (const void*)accumulate_kernel<false>,
            kThreads, smem_bytes);
        if (per_sm < 1) per_sm = 1;
        kept.store(per_sm, std::memory_order_relaxed);
    }
    const long long most = (long long)sms * per_sm;
    return (int)(want < 1 ? 1 : want < most ? want : most);
}

}  // namespace

extern "C" {

// Threads per block, the most specs one launch takes, and the shared memory
// (bytes) under which the shared-memory regime may run.
int adacom_accumulate_threads() { return kThreads; }
int adacom_accumulate_max_specs() { return kMaxSpecs; }
int adacom_accumulate_smem_bytes() { return kSmemBytes; }

// Adds the n rows of a chunk whose mask byte is nonzero into n_specs
// (domain,) accumulators, on `stream`; returns cudaGetLastError() (0 =
// launched). ops[s] = kind * 2 + type as above; values[s] (null for a count)
// read at i * vstrides[s]; shared: private accumulators in shared memory
// (needs n_specs * domain * 8 <= adacom_accumulate_smem_bytes()).
int adacom_grouped_accumulate(const void* gid, const void* mask, long long n,
                              long long domain, int n_specs, const int* ops,
                              const void* const* values,
                              const long long* vstrides, void* const* accs,
                              int shared, void* stream) {
    if (gid == nullptr || mask == nullptr || n < 1 || domain < 1 ||
        n_specs < 1 || n_specs > kMaxSpecs || ((uintptr_t)mask & 15) != 0)
        return (int)cudaErrorInvalidValue;
    Specs specs;
    specs.n = n_specs;
    for (int s = 0; s < n_specs; ++s) {
        const int op = ops[s];
        if (op < kCount || op > kMaxF || op == 1 || accs[s] == nullptr ||
            (op != kCount && values[s] == nullptr) || vstrides[s] < 0)
            return (int)cudaErrorInvalidValue;
        specs.s[s] = Spec{values[s], accs[s], vstrides[s], op};
    }
    const cudaStream_t st = (cudaStream_t)stream;
    const long long vecs = (n + kRowsPerLoad - 1) / kRowsPerLoad;
    if (shared) {
        const long long slots = (long long)n_specs * domain;
        if (slots * 8 > kSmemBytes) return (int)cudaErrorInvalidValue;
        const int smem = (int)(slots * 8);
        const long long want = n / slots < (vecs + kThreads - 1) / kThreads
                                   ? n / slots
                                   : (vecs + kThreads - 1) / kThreads;
        const int grid = blocks_for(true, smem, want);
        accumulate_kernel<true><<<grid, kThreads, smem, st>>>(
            (const long long*)gid, (const uint8_t*)mask, n, domain, specs);
    } else {
        const int grid =
            blocks_for(false, 0, (vecs + kThreads - 1) / kThreads);
        accumulate_kernel<false><<<grid, kThreads, 0, st>>>(
            (const long long*)gid, (const uint8_t*)mask, n, domain, specs);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
