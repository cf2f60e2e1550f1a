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
// port's contract is the CPU reference's order. Hence no float atomicAdd,
// in global or in shared memory: two runs on the same input are
// bit-identical.
//
// Design (simple and correct first):
//   * a CTA owns a tile of `tile` (<= kMaxTile) output positions,
//     accumulated in shared memory; position p of the tile belongs to thread
//     p % kThreads, and only that thread ever adds to it, so its fold order
//     is the order in which it sees the entries;
//   * the CTA walks the whole stream in chunks of kChunk entries, in order.
//     Each thread loads kPer entries (strided by kThreads, so the loads
//     coalesce), the block compacts the in-tile entries into shared memory in
//     slot order (warp ballots + a prefix over warps), and every thread then
//     walks the compacted list, applying the entries it owns;
//   * the tile is written to global memory once.
// The stream is re-read once per tile (grid = tiles, the TPU kernel's
// tiles x chunks), from L2 when it fits there. The launcher sizes the tile so
// that a small buffer still spreads over every SM (one tile per SM, at least
// 256 positions) and a large one re-reads the stream as few times as the
// shared memory allows (kMaxTile). Bound on this card: bytes --
// the least traffic is 8 bytes per stream entry plus 4 per output; this
// design moves 8 * n * n_tiles stream bytes through L2 instead, which is
// what a later redesign (bucketing the stream by tile first) removes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 8;                    // entries per thread per chunk
constexpr int kChunk = kThreads * kPer;    // 2048 entries staged per step
constexpr int kMaxTile = 4096;             // output positions per CTA, at most
constexpr int kSMs = 132;                  // H100 SXM

__global__ void __launch_bounds__(kThreads)
stream_scatter_add_kernel(const int32_t* __restrict__ idx,
                          const float* __restrict__ vals, long long n,
                          float* __restrict__ out, long long size, int tile) {
    __shared__ float acc[kMaxTile];
    __shared__ int lpos[kChunk];
    __shared__ float lval[kChunk];
    __shared__ int wcount[kPer][kWarps];

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const unsigned lanemask_lt = (1u << lane) - 1u;
    const long long t0 = (long long)blockIdx.x * tile;
    const long long rem = size - t0;
    const int tile_len = rem < tile ? (int)rem : tile;

    for (int i = tid; i < tile_len; i += kThreads) acc[i] = 0.0f;

    for (long long base = 0; base < n; base += kChunk) {
        int rel[kPer];
        int within[kPer];
#pragma unroll
        for (int e = 0; e < kPer; ++e) {
            const long long g = base + (long long)e * kThreads + tid;
            const int ix = g < n ? __ldg(idx + g) : -1;
            const long long r = (long long)ix - t0;
            rel[e] = (ix >= 0 && r >= 0 && r < tile_len) ? (int)r : -1;
        }
#pragma unroll
        for (int e = 0; e < kPer; ++e) {
            const unsigned ballot = __ballot_sync(0xffffffffu, rel[e] >= 0);
            within[e] = __popc(ballot & lanemask_lt);
            if (lane == 0) wcount[e][warp] = __popc(ballot);
        }
        __syncthreads();
        // slot order is (e, tid): chunk entry base + e * kThreads + tid
        int total = 0;  // in-tile entries of earlier sub-rows, then the chunk
#pragma unroll
        for (int e = 0; e < kPer; ++e) {
            int before = 0;  // in-tile entries of lower warps in sub-row e
            int tot_e = 0;
            for (int w = 0; w < kWarps; ++w) {
                const int c = wcount[e][w];
                before += w < warp ? c : 0;
                tot_e += c;
            }
            if (rel[e] >= 0) {
                const int slot = total + before + within[e];
                lpos[slot] = rel[e];
                lval[slot] = __ldg(vals + base + (long long)e * kThreads + tid);
            }
            total += tot_e;
        }
        __syncthreads();
        for (int j = 0; j < total; ++j) {
            const int p = lpos[j];
            if ((p & (kThreads - 1)) == tid) acc[p] += lval[j];
        }
        __syncthreads();
    }

    for (int i = tid; i < tile_len; i += kThreads) out[t0 + i] = acc[i];
}

}  // namespace

extern "C" int stream_scatter_add_launch(const void* idx, const void* vals,
                                         long long n, void* out,
                                         long long size, void* stream) {
    if (size <= 0) return 0;
    long long tile = (size + kSMs - 1) / kSMs;
    tile = (tile + kThreads - 1) / kThreads * kThreads;
    if (tile > kMaxTile) tile = kMaxTile;
    const long long tiles = (size + tile - 1) / tile;
    stream_scatter_add_kernel<<<(unsigned)tiles, kThreads, 0,
                                (cudaStream_t)stream>>>(
        (const int32_t*)idx, (const float*)vals, n, (float*)out, size,
        (int)tile);
    return (int)cudaGetLastError();
}
