// Fused THGS threshold split for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/thgs_sparsify.py::
// thgs_sparsify (body _kernel): one pass over (g, residual) tiles of
// [block_rows, 128] lanes that writes (sparse, new residual):
//
//   acc    = f32(g) + f32(r)
//   sparse = |acc| > delta ? acc : +0.0
//   resid  = acc - sparse
//
// each cast back to its input's dtype (g's for sparse, r's for resid). The
// residual follows the Pallas kernel, not the reference's jnp oracle
// (where(keep, 0, acc)): a kept +-inf accumulator gives NaN, as there. The
// add and the subtract are written as __fadd_rn / __fsub_rn and the bf16
// casts as __float2bfloat16_rn, so no compiler contraction or rounding mode
// changes a bit. delta is an f32 read from device memory when the caller
// passes a pointer (a threshold computed on the card needs no host sync),
// else the f32 value passed by the launcher.
//
// Bound on this card: bytes. Two arrays in and two out, one flop each, so
// 16 bytes an element in f32 (8 in bf16) against about 3 operations. One
// grid-stride loop with neighbouring threads on neighbouring elements keeps
// every load and store coalesced; nothing is reused, so no shared memory.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
    return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
    return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
    return __float2bfloat16_rn(x);
}

template <typename TG, typename TR>
__global__ void thgs_sparsify_kernel(const TG* __restrict__ g,
                                     const TR* __restrict__ r,
                                     const float* __restrict__ thr_ptr,
                                     float thr_value, long long n,
                                     TG* __restrict__ sparse,
                                     TR* __restrict__ resid) {
    const float thr = thr_ptr != nullptr ? __ldg(thr_ptr) : thr_value;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n; i += (long long)gridDim.x * blockDim.x) {
        const float acc = __fadd_rn(to_f32(g[i]), to_f32(r[i]));
        const float s = fabsf(acc) > thr ? acc : 0.0f;
        sparse[i] = from_f32<TG>(s);
        resid[i] = from_f32<TR>(__fsub_rn(acc, s));
    }
}

template <typename TG, typename TR>
void launch(const void* g, const void* r, const void* thr_ptr, float thr,
            long long n, void* sparse, void* resid, cudaStream_t stream) {
    const int threads = 256;
    long long blocks = (n + threads - 1) / threads;
    if (blocks > 132LL * 32) blocks = 132LL * 32;  // grid-stride beyond this
    thgs_sparsify_kernel<TG, TR><<<(unsigned)blocks, threads, 0, stream>>>(
        (const TG*)g, (const TR*)r, (const float*)thr_ptr, thr, n,
        (TG*)sparse, (TR*)resid);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. thr_ptr may be null (then thr).
extern "C" int thgs_sparsify_launch(const void* g, const void* r,
                                    const void* thr_ptr, float thr,
                                    long long n, int g_dtype, int r_dtype,
                                    void* sparse, void* resid,
                                    void* stream) {
    if (n <= 0) return 0;
    if ((g_dtype != 0 && g_dtype != 1) || (r_dtype != 0 && r_dtype != 1))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (g_dtype == 0 && r_dtype == 0)
        launch<float, float>(g, r, thr_ptr, thr, n, sparse, resid, s);
    else if (g_dtype == 0)
        launch<float, __nv_bfloat16>(g, r, thr_ptr, thr, n, sparse, resid, s);
    else if (r_dtype == 0)
        launch<__nv_bfloat16, float>(g, r, thr_ptr, thr, n, sparse, resid, s);
    else
        launch<__nv_bfloat16, __nv_bfloat16>(g, r, thr_ptr, thr, n, sparse,
                                             resid, s);
    return (int)cudaGetLastError();
}
