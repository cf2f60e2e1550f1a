// Deterministic slot-order scatter-add of a flat sparse stream (Hopper, sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/stream_decode.py::stream_scatter_add
// (body _kernel): the server decode of every sparse round, one flat
// (int32 index, f32 value) stream scatter-added into a dense f32[size].
// Entries outside [0, size) (the -1 padding among them) are dropped and
// duplicate indices accumulate.
//
// Contract: every output position folds its contributions in stream-slot
// order, starting from +0.0 -- ((0 + v1) + v2) + ... -- because that is what
// the port's reference (the JAX package's scatter on the CPU, and the plain
// version in kernels/ref.py) computes, and f32 addition is not associative:
// [1, 2^-24, -1] at one index gives 0.0 in that order and 2^-24 in another.
// The TPU kernel's one-hot MXU contraction does not promise slot order; the
// port's contract is the CPU reference's order. Hence no float atomics
// anywhere: two runs on the same input are bit-identical. Integer atomics
// only add the two ends of a run into its table entry (pass 1), a sum that
// does not depend on their order.
//
// Zero contributions are skipped, exactly. In round-to-nearest, x + y is
// -0.0 only when x and y are both -0.0 (a + (-a) and +0 + -0 give +0.0).
// The fold starts at +0.0, so by induction no accumulator ever holds -0.0.
// For any acc that is not -0.0, acc + (+0.0) and acc + (-0.0) are acc bit
// for bit (+-inf too; NaN stays NaN). So dropping every +-0.0 entry leaves
// every output bit as it was, and a position that only zeros reach reads
// +0.0 from the initial value. This empties the tree decode's dump slot
// (core/streams.py::_scatter_range sends the slots outside a group's range
// to one position with +0.0) and the gated zeros of the main path, without
// the kernel knowing about either.
//
// Design: the output is cut into tiles of 2^shift positions (256..4096,
// chosen so that a buffer of 52k positions still gives one tile per SM and a
// large one tiles of 4096), and the stream into chunks of kChunk slots. Two
// passes, launched back to back on one stream, no host sync between them:
//   1. split (one CTA per chunk): the chunk's kept entries (in range, value
//      not +-0.0) are compacted in slot order (warp ballots) and stably
//      sorted by tile (a radix sort in shared memory: each warp ranks a
//      contiguous segment 32 items at a time with __match_any_sync, and the
//      destinations are an exclusive prefix over (digit, warp)). The sorted
//      chunk goes to its own slice of the scratch as (local position, value)
//      pairs, and table[chunk][tile] records where each tile's run starts
//      and how long it is (shared-memory integer atomics add the two run
//      ends; every tile's entry is written, 0 for an absent tile);
//   2. fold (one CTA per tile): the tile's bucket is its runs of chunks 0,
//      1, 2, ... in order, so it holds the tile's entries in slot order. The
//      CTA scans its column of the table (the run lengths) and gathers the
//      bucket kStage entries at a time; it stably sorts each batch by local
//      position, so that a position's entries are adjacent in slot order, and
//      the first thread of each run folds the run into acc[p], carried across
//      the batches in order. acc lives in shared memory (tiles of up to 4096
//      positions; in the CTA's slice of the output beyond that, only for
//      outputs of more than 8192 tiles) and the tile is written once.
// A count pass, a scan and a bucket copy are fused into the split: a tile's
// bucket is addressed through the table rather than copied into one
// contiguous range, which saves two launches and a copy of the stream.
// A CTA's work grows with its bucket / threads plus the largest multiplicity
// of one position, whose run one thread folds: bit-exactness needs that.
//
// Bound on this card: bytes -- each stream entry read once (8 bytes) and
// each output written once (4): 8 * n + 4 * size. The design reads the
// stream once, writes and reads the kept entries once more (8 bytes each)
// and the table (n / kChunk * tiles ints), mostly in L2. What still bounds
// it: launch latency and the barriers of the two passes at small sizes
// (mnist's 156,800 positions), and the serial owner of a position that many
// non-zero entries reach (none on the main path once zeros are skipped).

#include <cstdint>
#include <cuda_runtime.h>

#include "smem_attr.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 8;                    // slots per thread in a chunk
constexpr int kChunkBits = 11;
constexpr int kChunk = 1 << kChunkBits;    // 2048 slots per chunk (split)
static_assert(kChunk == kThreads * kPer, "a chunk is kPer slots a thread");
constexpr int kStageBits = 10;
constexpr int kStage = 1 << kStageBits;    // bucket entries a fold batch
constexpr int kWin = 512;                  // chunks whose runs a fold scans
constexpr int kRunBits = 13;               // table entry: start << 13 | length
constexpr int kRadixBits = 7;
constexpr int kRadix = 1 << kRadixBits;
constexpr int kHist = kRadix * kWarps;     // per-warp digit counters
constexpr int kMinShift = 8;               // tiles of 256 positions at least
constexpr int kAccShift = 12;              // tiles of 4096 accumulate in smem
constexpr long long kMaxTiles = 8192;      // the split's per-tile row in smem
constexpr int kSMs = 132;                  // H100 SXM
constexpr unsigned kFull = 0xffffffffu;

struct Plan {
    int shift;             // tile = 2^shift positions
    int n_tiles;
    int tile_bits;         // bits of a tile id
    long long n_chunks;
    long long sorted_off;  // bytes: the table, then the sorted chunks
    long long bytes;
};

Plan make_plan(long long n, long long size) {
    Plan p;
    p.shift = kMinShift;
    while (p.shift < kAccShift &&
           ((size - 1) >> (p.shift + 1)) + 1 >= 2 * kSMs)
        ++p.shift;
    while (((size - 1) >> p.shift) + 1 > kMaxTiles) ++p.shift;
    p.n_tiles = (int)(((size - 1) >> p.shift) + 1);
    p.tile_bits = 1;
    while ((1 << p.tile_bits) < p.n_tiles) ++p.tile_bits;
    p.n_chunks = (n + kChunk - 1) / kChunk;
    p.sorted_off = (4 * p.n_chunks * p.n_tiles + 15) / 16 * 16;
    p.bytes = p.sorted_off + 8 * p.n_chunks * kChunk;
    return p;
}

// Exclusive prefix sum over a[0..len) in shared memory, in place; returns the
// total. Every thread of the block calls it; it ends with a barrier.
__device__ int block_exclusive_scan(int* a, int len, int* tmp) {
    constexpr int kScanPer = 4;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    int carry = 0;
    for (int base = 0; base < len; base += kThreads * kScanPer) {
        const int i0 = base + threadIdx.x * kScanPer;
        int v[kScanPer];
        int s = 0;
#pragma unroll
        for (int e = 0; e < kScanPer; ++e) {
            v[e] = i0 + e < len ? a[i0 + e] : 0;
            s += v[e];
        }
        int x = s;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int y = __shfl_up_sync(kFull, x, o);
            if (lane >= o) x += y;
        }
        if (lane == 31) tmp[warp] = x;
        __syncthreads();
        if (warp == 0) {
            int w = lane < kWarps ? tmp[lane] : 0;
#pragma unroll
            for (int o = 1; o < kWarps; o <<= 1) {
                const int y = __shfl_up_sync(kFull, w, o);
                if (lane >= o) w += y;
            }
            if (lane < kWarps) tmp[lane] = w;
        }
        __syncthreads();
        int run = carry + (warp > 0 ? tmp[warp - 1] : 0) + x - s;
#pragma unroll
        for (int e = 0; e < kScanPer; ++e) {
            if (i0 + e < len) a[i0 + e] = run;
            run += v[e];
        }
        carry += tmp[kWarps - 1];
        __syncthreads();
    }
    return carry;
}

// One stable counting pass of src[0..m) (m <= kCap) into dst by the digit
// (word >> shift) & (kRadix - 1). Warp w ranks a contiguous segment of the
// items, 32 at a time in order: __match_any_sync finds the lanes with the
// same digit, the lowest of them advances the warp's counter. The destination
// is the exclusive prefix over (digit, warp) plus the rank, so equal digits
// keep their order. Ends with a barrier.
template <int kCap>
__device__ void sort_pass(const uint32_t* src, uint32_t* dst, int m, int shift,
                          int* hist, int* tmp) {
    constexpr int kGroups = kCap / kWarps / 32;   // 32-item groups a warp
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const unsigned lt = (1u << lane) - 1u;
    for (int i = threadIdx.x; i < kHist; i += kThreads) hist[i] = 0;
    __syncthreads();
    const int seg = ((m + kWarps - 1) / kWarps + 31) & ~31;
    const int lo = warp * seg;
    int rank[kGroups];
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
        rank[g] = 0;
        if (g * 32 < seg && lo + g * 32 < m) {          // warp-uniform
            const int i = lo + g * 32 + lane;
            const bool valid = i < m;
            const int d = valid ? (int)((src[i] >> shift) & (kRadix - 1))
                                : kRadix;
            const unsigned peers = __match_any_sync(kFull, d);
            const int before = valid ? hist[d * kWarps + warp] : 0;
            rank[g] = before + __popc(peers & lt);
            __syncwarp();
            if (valid && (peers & lt) == 0u)
                hist[d * kWarps + warp] = before + __popc(peers);
            __syncwarp();
        }
    }
    __syncthreads();
    block_exclusive_scan(hist, kHist, tmp);
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
        const int i = lo + g * 32 + lane;
        if (g * 32 < seg && i < m) {
            const uint32_t w = src[i];
            const int d = (int)((w >> shift) & (kRadix - 1));
            dst[hist[d * kWarps + warp] + rank[g]] = w;
        }
    }
    __syncthreads();
}

// Stable sort of a[0..m) by bits [lo_bit, hi_bit) of each word (the bits
// above hi_bit are zero); returns the buffer that holds the result.
template <int kCap>
__device__ uint32_t* block_sort(uint32_t* a, uint32_t* b, int m, int lo_bit,
                                int hi_bit, int* hist, int* tmp) {
    for (int s = lo_bit; s < hi_bit; s += kRadixBits) {
        sort_pass<kCap>(a, b, m, s, hist, tmp);
        uint32_t* t = a;
        a = b;
        b = t;
    }
    return a;
}

// pass 1: one chunk's kept entries sorted by tile, in slot order within a
// tile, into sorted[chunk]; table[chunk][tile] = run start << 13 | length
__global__ void __launch_bounds__(kThreads)
stream_scatter_add_split_kernel(const int32_t* __restrict__ idx,
                                const float* __restrict__ vals, long long n,
                                long long size, int shift, int n_tiles,
                                int tile_bits, int* __restrict__ table,
                                int2* __restrict__ sorted) {
    extern __shared__ int smem[];
    int* row = smem;                                     // [n_tiles]
    uint32_t* a = reinterpret_cast<uint32_t*>(row + n_tiles);  // [kChunk]
    uint32_t* b = a + kChunk;                            // [kChunk]
    int* hist = reinterpret_cast<int*>(b + kChunk);      // [kHist]
    __shared__ int wcount[kPer][kWarps];
    __shared__ int tmp[kWarps];
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const unsigned lt = (1u << lane) - 1u;
    for (int t = tid; t < n_tiles; t += kThreads) row[t] = 0;

    // compact the kept entries (in range, value not +-0.0) in slot order:
    // slot e * kThreads + tid of the chunk
    const long long base = (long long)blockIdx.x * kChunk;
    int tl[kPer];
    int within[kPer];
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
        const long long g = base + e * kThreads + tid;
        tl[e] = -1;
        if (g < n) {
            const int ix = __ldg(idx + g);
            const unsigned vb = __float_as_uint(__ldg(vals + g));
            if (ix >= 0 && ix < size && (vb << 1) != 0u) tl[e] = ix >> shift;
        }
        const unsigned ballot = __ballot_sync(kFull, tl[e] >= 0);
        within[e] = __popc(ballot & lt);
        if (lane == 0) wcount[e][warp] = __popc(ballot);
    }
    __syncthreads();
    int m = 0;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
        int before = 0, tot = 0;
        for (int w = 0; w < kWarps; ++w) {
            const int c = wcount[e][w];
            before += w < warp ? c : 0;
            tot += c;
        }
        if (tl[e] >= 0)
            a[m + before + within[e]] = ((uint32_t)tl[e] << kChunkBits) |
                                        (uint32_t)(e * kThreads + tid);
        m += tot;
    }
    __syncthreads();

    const uint32_t* s = block_sort<kChunk>(a, b, m, kChunkBits,
                                           kChunkBits + tile_bits, hist, tmp);
    int2* out = sorted + base;
    for (int j = tid; j < m; j += kThreads) {
        const uint32_t w = s[j];
        const int t = (int)(w >> kChunkBits);
        // start * 2^13 + (end - start) == start * (2^13 - 1) + end
        if (j == 0 || (int)(s[j - 1] >> kChunkBits) != t)
            atomicAdd(row + t, j * ((1 << kRunBits) - 1));
        if (j == m - 1 || (int)(s[j + 1] >> kChunkBits) != t)
            atomicAdd(row + t, j + 1);
        const long long g = base + (w & (kChunk - 1));
        out[j] = make_int2(__ldg(idx + g) - (t << shift),
                           __float_as_int(__ldg(vals + g)));
    }
    __syncthreads();
    int* trow = table + (long long)blockIdx.x * n_tiles;
    for (int t = tid; t < n_tiles; t += kThreads) trow[t] = row[t];
}

// pass 2: one CTA per tile folds its bucket (its run of every chunk, chunks in
// order) in slot order and writes the tile once; five CTAs an SM (48
// registers a thread) hold VGG16's 576 tiles in one wave
__global__ void __launch_bounds__(kThreads, 5)
stream_scatter_add_fold_kernel(const int* __restrict__ table,
                               const int2* __restrict__ sorted,
                               long long n_chunks, int n_tiles, int shift,
                               float* __restrict__ out, long long size) {
    extern __shared__ int smem[];
    uint32_t* a = reinterpret_cast<uint32_t*>(smem);     // [kStage]
    uint32_t* b = a + kStage;                            // [kStage]
    float* sval = reinterpret_cast<float*>(b + kStage);  // [kStage]
    int* hist = reinterpret_cast<int*>(sval + kStage);   // [kHist]
    int* cpre = hist + kHist;                            // [kWin]
    int* cst = cpre + kWin;                              // [kWin]
    float* sacc = reinterpret_cast<float*>(cst + kWin);  // [2^shift], small
    __shared__ int tmp[kWarps];
    const int tid = threadIdx.x;
    const int tile = blockIdx.x;

    const long long t0 = (long long)tile << shift;
    const long long rem = size - t0;
    const int tile_len = rem < (1LL << shift) ? (int)rem : (1 << shift);
    float* acc = shift <= kAccShift ? sacc : out + t0;
    for (int i = tid; i < tile_len; i += kThreads) acc[i] = 0.0f;

    for (long long cw = 0; cw < n_chunks; cw += kWin) {
        const int nw = n_chunks - cw < kWin ? (int)(n_chunks - cw) : kWin;
        for (int i = tid; i < nw; i += kThreads) {
            const int v = __ldg(table + (cw + i) * n_tiles + tile);
            cpre[i] = v & ((1 << kRunBits) - 1);
            cst[i] = v >> kRunBits;
        }
        __syncthreads();
        const int total = block_exclusive_scan(cpre, nw, tmp);
        for (int sb = 0; sb < total; sb += kStage) {
            const int m = total - sb < kStage ? total - sb : kStage;
            for (int j = tid; j < m; j += kThreads) {
                // the chunk holding bucket entry sb + j: the last with
                // cpre <= sb + j
                const int jj = sb + j;
                int lo = 0, hi = nw;
                while (hi - lo > 1) {
                    const int mid = (lo + hi) >> 1;
                    if (cpre[mid] <= jj) lo = mid; else hi = mid;
                }
                const int2 e = __ldg(sorted + (cw + lo) * kChunk + cst[lo] +
                                     (jj - cpre[lo]));
                a[j] = ((uint32_t)e.x << kStageBits) | (uint32_t)j;
                sval[j] = __int_as_float(e.y);
            }
            __syncthreads();
            const uint32_t* s = block_sort<kStage>(
                a, b, m, kStageBits, kStageBits + shift, hist, tmp);
            // the first thread of a run folds it, in slot order, into acc[p]
            for (int j = tid; j < m; j += kThreads) {
                const uint32_t p = s[j] >> kStageBits;
                if (j > 0 && (s[j - 1] >> kStageBits) == p) continue;
                float x = acc[p];
                for (int k = j; k < m && (s[k] >> kStageBits) == p; ++k)
                    x = __fadd_rn(x, sval[s[k] & (kStage - 1)]);
                acc[p] = x;
            }
            __syncthreads();
        }
    }
    __syncthreads();
    if (shift <= kAccShift)
        for (int i = tid; i < tile_len; i += kThreads) out[t0 + i] = sacc[i];
}

constexpr int kSplitSmemMax = 4 * kMaxTiles + 8 * kChunk + 4 * kHist;
constexpr int kFoldSmem = 12 * kStage + 4 * kHist + 8 * kWin;

}  // namespace

// Scratch bytes of one call: the run table (n_chunks x n_tiles int32) and the
// sorted chunks (kChunk (position, value) pairs each).
extern "C" long long stream_scatter_add_workspace_bytes(long long n,
                                                        long long size) {
    return size > 0 ? make_plan(n, size).bytes : 0;
}

// Two launches on `stream`, no sync; `workspace` holds at least
// stream_scatter_add_workspace_bytes(n, size) bytes. Returns
// cudaGetLastError() after the passes (cudaErrorInvalidValue for too small a
// workspace).
extern "C" int stream_scatter_add_launch(const void* idx, const void* vals,
                                         long long n, void* out,
                                         long long size, void* workspace,
                                         long long workspace_bytes,
                                         void* stream) {
    if (size <= 0) return 0;
    const Plan p = make_plan(n, size);
    if (workspace_bytes < p.bytes) return (int)cudaErrorInvalidValue;
    // above 48 KB of shared memory only on request, once per device
    static bool configured[kMaxDevices] = {};
    const cudaError_t err = set_smem_once(
        configured, stream_scatter_add_split_kernel, kSplitSmemMax);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t s = (cudaStream_t)stream;
    int* table = (int*)workspace;
    int2* sorted = (int2*)((char*)workspace + p.sorted_off);
    if (p.n_chunks > 0)
        stream_scatter_add_split_kernel<<<(unsigned)p.n_chunks, kThreads,
                                          4 * p.n_tiles + 8 * kChunk +
                                              4 * kHist,
                                          s>>>(
            (const int32_t*)idx, (const float*)vals, n, size, p.shift,
            p.n_tiles, p.tile_bits, table, sorted);
    const int acc_bytes = p.shift <= kAccShift ? 4 << p.shift : 0;
    stream_scatter_add_fold_kernel<<<p.n_tiles, kThreads,
                                     kFoldSmem + acc_bytes, s>>>(
        table, sorted, p.n_chunks, p.n_tiles, p.shift, (float*)out, size);
    return (int)cudaGetLastError();
}
