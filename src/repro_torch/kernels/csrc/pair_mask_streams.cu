// Counter-based pair masks for Hopper (sm_90a): the sparse pair-mask streams
// and the dense mask-and-apply pass, which share the murmur finalizer mix32.
//
// ---- pair_mask_streams
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
//
// ---- mask_prng_apply
// Replaces the Pallas TPU kernel src/repro/kernels/mask_prng.py::
// mask_prng_apply (body _kernel): for every element i of g,
//
//   u    = p + q * f32(mix32(i ^ seed)) / 2^32
//   mask = (u < sigma ? u : +0.0) * sign
//   out  = cast_to_g(f32(g) + mask)
//
// All 32 bits are drawn (not the 24-bit grid above), so the uint32 -> f32
// conversion rounds: __uint2float_rn, to nearest even, as XLA's convert
// (0xFFFFFFFF becomes 2^32, so u = p + q exactly). The reference's jitted
// entry contracts p + q * u into one fused multiply-add, rounded once, in
// the vectorized loop XLA compiles (its scalar loops round twice); the
// kernel writes __fmaf_rn(q, u, p) so the result does not depend on nvcc's
// --fmad. The mask keeps the signed zero off the support when sign = -1.
// One thread an element, native uint32 arithmetic.
//
// Bound on this card: bytes. It reads g and writes out and mask: 12 bytes an
// element in f32, against about 20 integer and 4 float operations.

#include <cstdint>
#include <cuda_bf16.h>
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

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
    return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16_rn(x);
}

template <typename TG>
__global__ void mask_prng_apply_kernel(const TG* __restrict__ g, long long n,
                                       uint32_t seed, float p, float q,
                                       float sigma, float sign,
                                       TG* __restrict__ out,
                                       float* __restrict__ mask_out) {
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n; i += (long long)gridDim.x * blockDim.x) {
        const uint32_t x = mix32((uint32_t)i ^ seed);
        // / 2^32 is a power-of-two scaling: exact as a multiply
        const float u = __fmaf_rn(
            q, __fmul_rn(__uint2float_rn(x), 2.3283064365386963e-10f), p);
        const float mask = __fmul_rn(u < sigma ? u : 0.0f, sign);
        mask_out[i] = mask;
        store(out + i, __fadd_rn(to_f32(g[i]), mask));
    }
}

}  // namespace

// g_dtype: 0 = float32, 1 = bfloat16 (out has g's dtype; the mask is f32).
extern "C" int mask_prng_apply_launch(const void* g, long long n,
                                      unsigned int seed, float p, float q,
                                      float sigma, float sign, int g_dtype,
                                      void* out, void* mask_out,
                                      void* stream) {
    if (n <= 0) return 0;
    if (g_dtype != 0 && g_dtype != 1) return (int)cudaErrorInvalidValue;
    const int threads = 256;
    long long blocks = (n + threads - 1) / threads;
    if (blocks > 132LL * 32) blocks = 132LL * 32;  // grid-stride beyond this
    cudaStream_t s = (cudaStream_t)stream;
    if (g_dtype == 0)
        mask_prng_apply_kernel<float><<<(unsigned)blocks, threads, 0, s>>>(
            (const float*)g, n, seed, p, q, sigma, sign, (float*)out,
            (float*)mask_out);
    else
        mask_prng_apply_kernel<__nv_bfloat16>
            <<<(unsigned)blocks, threads, 0, s>>>(
                (const __nv_bfloat16*)g, n, seed, p, q, sigma, sign,
                (__nv_bfloat16*)out, (float*)mask_out);
    return (int)cudaGetLastError();
}

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
