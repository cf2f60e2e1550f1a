// Counter-based sparse pair-mask streams for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/mask_prng.py::pair_mask_streams
// (body _pair_stream_kernel): one TPU grid step per pair filled that pair's
// nb * k_mask slots from a murmur-avalanched counter stream. Here one thread
// computes one (pair, counter) slot, so the grid covers n_pairs * L slots
// with no per-pair padding.
//
//   idx = mix32(mix32(seed ^ IDX_SALT) + c) % m
//   val = sign * (p + q * (mix32(mix32(seed ^ VAL_SALT) + c) >> 8) / 2^24)
//
// with flat counter c = block * k_mask + slot. Native uint32_t arithmetic
// wraps exactly like the reference's uint32 lanes. The value uses only the
// top 24 bits, so u is exact in f32. The multiply and the add are issued as
// __fmul_rn / __fadd_rn: nvcc may not contract them into an FMA, so the two
// roundings match the reference for any p, q. With the default p = -1, q = 2
// every intermediate is exact anyway (q * u is a power-of-two scaling and
// p + q * u lies on the 2^-23 grid inside (-1, 1)), so FMA contraction could
// not change a bit there either.
//
// Bound on this card: bytes. Each slot writes 8 bytes (int32 + f32) and does
// about 25 integer operations; the output write dominates. The design keeps
// both stores coalesced (neighbouring threads write neighbouring slots) and
// reads each pair's seed and sign from L1.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kIdxSalt = 0x9E3779B9u;
constexpr uint32_t kValSalt = 0x85EBCA6Bu;

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
    x ^= x >> 16;
    x *= 0x7FEB352Du;
    x ^= x >> 15;
    x *= 0x846CA68Bu;
    x ^= x >> 16;
    return x;
}

__global__ void pair_mask_streams_kernel(const uint32_t* __restrict__ seeds,
                                         const float* __restrict__ signs,
                                         long long n_pairs, long long L,
                                         uint32_t m, float p, float q,
                                         int32_t* __restrict__ idx_out,
                                         float* __restrict__ val_out) {
    const long long total = n_pairs * L;
    for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         g < total; g += (long long)gridDim.x * blockDim.x) {
        const long long pair = g / L;
        const uint32_t c = (uint32_t)(g - pair * L);
        const uint32_t seed = __ldg(seeds + pair);
        const float sign = __ldg(signs + pair);
        const uint32_t base_i = mix32(seed ^ kIdxSalt);
        const uint32_t base_v = mix32(seed ^ kValSalt);
        idx_out[g] = (int32_t)(mix32(base_i + c) % m);
        const float u = (float)(mix32(base_v + c) >> 8) * (1.0f / 16777216.0f);
        val_out[g] = __fmul_rn(sign, __fadd_rn(p, __fmul_rn(q, u)));
    }
}

}  // namespace

extern "C" int pair_mask_streams_launch(const void* seeds, const void* signs,
                                        long long n_pairs, long long L,
                                        unsigned int m, float p, float q,
                                        void* idx_out, void* val_out,
                                        void* stream) {
    const long long total = n_pairs * L;
    if (total <= 0) return 0;
    const int threads = 256;
    long long blocks = (total + threads - 1) / threads;
    if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride beyond this
    pair_mask_streams_kernel<<<(unsigned)blocks, threads, 0,
                               (cudaStream_t)stream>>>(
        (const uint32_t*)seeds, (const float*)signs, n_pairs, L, m, p, q,
        (int32_t*)idx_out, (float*)val_out);
    return (int)cudaGetLastError();
}
