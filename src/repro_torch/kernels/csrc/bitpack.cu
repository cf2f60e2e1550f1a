// Fixed-width bit packing of the stream wire for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels src/repro/kernels/pack.py::bitpack_rows
// and ::bitunpack_rows (bodies _pack_kernel/_unpack_kernel, which run
// kernels/ref.py::_pack_chunk/_unpack_chunk). The TPU version works in
// 32-slot chunks because a chunk of w-bit fields fills exactly w words, so
// its (row tile, chunk group) grid needs no cross-step state. That chunking
// is its tiling, not the format: chunk c starts at bit 32*w*c and slot i at
// bit i*w inside it, so field s of a row lies at bits [s*w, s*w + w) of the
// row's word array -- one contiguous bit stream, least significant bit
// first. Both kernels here are written from that.
//
//   pack:   one thread per output word j of a row. It ORs in the fields
//           s in [floor(32j/w), floor((32j+31)/w)] with s < k, each shifted
//           into place (a field that began in the word before contributes
//           its high bits). Slots past k are zero bits.
//   unpack: one thread per field s. It reads word floor(s*w/32), and the
//           next word only when the field straddles the boundary, then
//           masks to w bits.
//
// No atomics, no shared state between threads: both are deterministic.
// Traps: a shift by 32 is undefined in C++ (the straddle branch only runs
// with 0 < off, and the shifts stay in 1..31); for w = 32 the mask is
// 0xFFFFFFFF, never (1u << 32) - 1; s*w is computed in 64 bits. Each field
// is masked to w bits before it is placed, so a field with stray high bits
// cannot corrupt its neighbours (the plain version in kernels/ref.py takes
// the low w bits the same way).
//
// Bound on this card: bytes. At the main path's shape (5 rows, k = 7,880,
// w = 18) a call moves about 0.25 MB, well under a microsecond at
// 3.35 TB/s, so the launch dominates. The design keeps the loads and stores
// of neighbouring threads on neighbouring addresses; pack re-reads each
// input field at most twice (once per word it touches), from L1.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t field_mask(int w) {
    return w >= 32 ? 0xFFFFFFFFu : ((1u << w) - 1u);
}

__global__ void bitpack_rows_kernel(const uint32_t* __restrict__ u,
                                    long long R, long long k, int w,
                                    uint32_t* __restrict__ out, long long W) {
    const long long total = R * W;
    const uint32_t mask = field_mask(w);
    for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         g < total; g += (long long)gridDim.x * blockDim.x) {
        const long long r = g / W;
        const long long j = g - r * W;
        const long long bit0 = 32LL * j;              // first bit of word j
        const uint32_t* row = u + r * k;
        long long s = bit0 / w;
        long long s_end = (bit0 + 31) / w;            // last field touching j
        if (s_end > k - 1) s_end = k - 1;
        uint32_t word = 0u;
        for (; s <= s_end; ++s) {
            const uint32_t f = __ldg(row + s) & mask;
            const long long start = s * (long long)w;
            if (start >= bit0) {
                word |= f << (int)(start - bit0);     // shift in 0..31
            } else {
                word |= f >> (int)(bit0 - start);     // shift in 1..w-1
            }
        }
        out[g] = word;
    }
}

__global__ void bitunpack_rows_kernel(const uint32_t* __restrict__ words,
                                      long long R, long long W, long long k,
                                      int w, uint32_t* __restrict__ out) {
    const long long total = R * k;
    const uint32_t mask = field_mask(w);
    for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         g < total; g += (long long)gridDim.x * blockDim.x) {
        const long long r = g / k;
        const long long s = g - r * k;
        const uint32_t* row = words + r * W;
        const long long start = s * (long long)w;
        const long long j = start >> 5;
        const int off = (int)(start & 31);
        uint32_t v = __ldg(row + j) >> off;
        if (off + w > 32) {                           // straddles: off > 0
            v |= __ldg(row + j + 1) << (32 - off);
        }
        out[g] = v & mask;
    }
}

long long grid_for(long long total, int threads) {
    long long blocks = (total + threads - 1) / threads;
    if (blocks > 132LL * 64) blocks = 132LL * 64;     // grid-stride beyond
    return blocks;
}

}  // namespace

// u: uint32[R, k] fields -> out: uint32[R, W], W = ceil(k * w / 32).
extern "C" int bitpack_rows_launch(const void* u, long long R, long long k,
                                   int w, void* out, long long W,
                                   void* stream) {
    if (w < 1 || w > 32) return (int)cudaErrorInvalidValue;
    if (R * W <= 0) return 0;
    const int threads = 256;
    bitpack_rows_kernel<<<(unsigned)grid_for(R * W, threads), threads, 0,
                          (cudaStream_t)stream>>>(
        (const uint32_t*)u, R, k, w, (uint32_t*)out, W);
    return (int)cudaGetLastError();
}

// words: uint32[R, W] -> out: uint32[R, k] fields, each < 2^w.
extern "C" int bitunpack_rows_launch(const void* words, long long R,
                                     long long W, long long k, int w,
                                     void* out, void* stream) {
    if (w < 1 || w > 32) return (int)cudaErrorInvalidValue;
    if (R * k <= 0) return 0;
    const int threads = 256;
    bitunpack_rows_kernel<<<(unsigned)grid_for(R * k, threads), threads, 0,
                            (cudaStream_t)stream>>>(
        (const uint32_t*)words, R, W, k, w, (uint32_t*)out);
    return (int)cudaGetLastError();
}
