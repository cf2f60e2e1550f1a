// Causal GQA flash attention with an optional sliding window (Hopper, sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (body _flash_kernel): q [B,T,H,hd] against k, v
// [B,S,Hkv,hd], query head h reading kv head h / (H/Hkv), scores scaled by
// hd^-0.5, masked to -1e30 (not -inf) where a key is in the future (causal:
// k_pos > q_pos) or out of the window (k_pos <= q_pos - window), both
// positions counted from 0; an online softmax with an f32 running max m,
// normaliser l and accumulator; out = acc / max(l, 1e-30) in q's dtype. A row
// with every key masked so gets the uniform average, as the Pallas kernel
// gives, not NaN. It is the prefill attention of every layer of the LM
// serving path (models/attention.py::prefill_cache and self_attention).
//
// The TPU kernel runs a dense grid over (b, h, q block, kv block), kv
// minor-most, its m/l/acc carried in VMEM scratch from one grid step to the
// next. Blocks run in no order here, so one CTA owns one (q block, h, b) and
// walks its kv tiles in a loop, m/l/acc in registers:
//
//   * BQ = 64 queries and BK = 64 keys a tile, 256 threads. Thread
//     (ty, tx) = (tid / 16, tid % 16) owns query rows ty + 16 i (i < 4); for
//     a kv tile it computes the 4 x 4 scores of those rows against keys
//     tx + 16 j from Q and K in shared memory (f32, rows padded by one word so
//     neither operand conflicts on a bank), and the output columns
//     tx + 16 c (c < hd/16) of the same rows, so each row's rescale factor
//     stays in the registers of the 16 threads that share the row; row max
//     and row sum are butterfly shuffles inside a half-warp.
//   * P = exp(s - m) goes through shared memory to the P.V product.
//   * Tiles wholly above the causal diagonal or wholly before the window are
//     skipped. That is exact: in the Pallas kernel such a tile adds
//     exp(-1e30 - m) = 0 to a row whose max is real, and a tile met while a
//     row's max is still -1e30 adds terms that the first real tile scales by
//     exp(-1e30 - m) = 0. Where some row of the block has no key at all (a
//     window that ends before the keys start, T > S), no tile is skipped.
//   * T and S need not be multiples of the tile: query rows past T are
//     neither loaded nor stored, key columns past S take p = 0 exactly (the
//     TPU kernel never has such columns, so they must not count in l).
//
// Everything is f32 on CUDA cores: no tensor-core instruction, no library
// call. Bound on this card: operations. Yi-6B's prefill (B 4, T = S = 1024,
// H 32, Hkv 4, hd 128, causal) needs 4*B*H*hd*T(T+1)/2 = 3.4e10 flops against
// 75.5 MB of traffic: 35 us at the bf16 tensor-core rate, 0.5 ms at the f32
// CUDA-core rate this design runs at. A wgmma/TMA pipeline is later work.

#include <cmath>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
    return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
    return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
        float x) {
    return __float2bfloat16_rn(x);
}

template <int HD>
constexpr size_t smem_bytes() {
    // Q [BQ][HD+1], K [BK][HD+1], V [BK][HD], P [BQ][BK+1], all f32
    return sizeof(float) * (BQ * (HD + 1) + BK * (HD + 1) + BK * HD
                            + BQ * (BK + 1));
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT, 2) flash_attention_kernel(
        const T* __restrict__ q, const T* __restrict__ k,
        const T* __restrict__ v, T* __restrict__ out, int Tq, int S, int H,
        int Hkv, float sm_scale, int causal, int window) {
    constexpr int NC = HD / 16;              // output columns per thread
    extern __shared__ float smem[];
    float* Qs = smem;
    float* Ks = Qs + BQ * (HD + 1);
    float* Vs = Ks + BK * (HD + 1);
    float* Ps = Vs + BK * HD;

    // heaviest causal blocks (the last queries) first
    const int qb = gridDim.x - 1 - blockIdx.x;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int hk = h / (H / Hkv);
    const int tid = threadIdx.x;
    const int tx = tid & 15;
    const int ty = tid >> 4;
    const int q0 = qb * BQ;
    const long long q_stride = (long long)H * HD;      // between positions
    const long long kv_stride = (long long)Hkv * HD;
    const T* qbase = q + ((long long)b * Tq * H + h) * HD;
    const T* kbase = k + ((long long)b * S * Hkv + hk) * HD;
    const T* vbase = v + ((long long)b * S * Hkv + hk) * HD;

    for (int i = tid; i < BQ * HD; i += NT) {
        const int r = i / HD, d = i - r * HD;
        const int pos = q0 + r;
        Qs[r * (HD + 1) + d] = pos < Tq ? to_f32(qbase[pos * q_stride + d])
                                        : 0.f;
    }

    // the key range this block needs: every tile, unless each of its rows
    // has a key, in which case tiles wholly masked for all rows are skipped
    const int q_last = min(q0 + BQ, Tq) - 1;
    int lo = 0, hi = S - 1;
    const bool every_row_has_a_key =
        window <= 0 || (long long)q_last <= (long long)S + window - 2;
    if (every_row_has_a_key) {
        if (causal) hi = min(hi, q_last);
        if (window > 0) lo = max(0, q0 - window + 1);
    }

    float m[4], l[4], acc[4][NC];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m[i] = NEG_INF;
        l[i] = 0.f;
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
    }

    for (int kt = lo / BK; kt <= hi / BK; ++kt) {
        const int k0 = kt * BK;
        __syncthreads();                 // the last tile's K, V, P are read
        for (int i = tid; i < BK * HD; i += NT) {
            const int r = i / HD, d = i - r * HD;
            const int pos = k0 + r;
            const bool in = pos < S;
            Ks[r * (HD + 1) + d] = in ? to_f32(kbase[pos * kv_stride + d]) : 0.f;
            Vs[r * HD + d] = in ? to_f32(vbase[pos * kv_stride + d]) : 0.f;
        }
        __syncthreads();

        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
        for (int d = 0; d < HD; ++d) {
            float qv[4], kv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * (HD + 1) + d];
#pragma unroll
            for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * (HD + 1) + d];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        }

#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int r = ty + 16 * i;
            const int qpos = q0 + r;
            float rowmax = -CUDART_INF_F;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int kpos = k0 + tx + 16 * j;
                float sc = s[i][j] * sm_scale;
                const bool ok = (!causal || kpos <= qpos)
                                && (window <= 0 || kpos > qpos - window);
                sc = ok ? sc : NEG_INF;
                s[i][j] = kpos < S ? sc : -CUDART_INF_F;   // past S: p = 0
                rowmax = fmaxf(rowmax, s[i][j]);
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                rowmax = fmaxf(rowmax, __shfl_xor_sync(0xffffffffu, rowmax, off));
            // column k0 < S is in every tile, so rowmax >= -1e30 is finite
            const float m_new = fmaxf(m[i], rowmax);
            const float alpha = expf(m[i] - m_new);
            float rowsum = 0.f;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float p = expf(s[i][j] - m_new);
                rowsum += p;
                Ps[r * (BK + 1) + tx + 16 * j] = p;
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                rowsum += __shfl_xor_sync(0xffffffffu, rowsum, off);
            l[i] = alpha * l[i] + rowsum;
            m[i] = m_new;
#pragma unroll
            for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
        }
        __syncthreads();

#pragma unroll 4
        for (int kk = 0; kk < BK; ++kk) {
            float p[4], vv[NC];
#pragma unroll
            for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * (BK + 1) + kk];
#pragma unroll
            for (int c = 0; c < NC; ++c) vv[c] = Vs[kk * HD + tx + 16 * c];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int c = 0; c < NC; ++c)
                    acc[i][c] = fmaf(p[i], vv[c], acc[i][c]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int pos = q0 + ty + 16 * i;
        if (pos >= Tq) continue;
        const float denom = fmaxf(l[i], 1e-30f);
        T* orow = out + ((long long)b * Tq * H + h) * HD + pos * q_stride;
#pragma unroll
        for (int c = 0; c < NC; ++c)
            orow[tx + 16 * c] = from_f32<T>(acc[i][c] / denom);
    }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Tq, int S, int H, int Hkv, int causal, int window,
           cudaStream_t stream) {
    constexpr size_t smem = smem_bytes<HD>();
    auto kern = flash_attention_kernel<T, HD>;
    // above 48 KB of shared memory only on request; made once per instance,
    // so a launch inside a CUDA graph capture makes no such call
    static bool configured = false;
    if (!configured) {
        cudaError_t err = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
        configured = true;
    }
    const dim3 grid((Tq + BQ - 1) / BQ, H, B);
    const float sm_scale = (float)(1.0 / sqrt((double)HD));   // f32(hd^-0.5)
    kern<<<grid, NT, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out), Tq, S, H, Hkv,
        sm_scale, causal, window);
    return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; hd: 64 or 128; window <= 0 = none.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for a
// dtype or head width without an instance).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int Tq,
                                      int S, int H, int Hkv, int hd,
                                      int causal, int window, int dtype,
                                      void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0 && hd == 64)
        return launch<float, 64>(q, k, v, out, B, Tq, S, H, Hkv, causal,
                                 window, st);
    if (dtype == 0 && hd == 128)
        return launch<float, 128>(q, k, v, out, B, Tq, S, H, Hkv, causal,
                                  window, st);
    if (dtype == 1 && hd == 64)
        return launch<__nv_bfloat16, 64>(q, k, v, out, B, Tq, S, H, Hkv,
                                         causal, window, st);
    if (dtype == 1 && hd == 128)
        return launch<__nv_bfloat16, 128>(q, k, v, out, B, Tq, S, H, Hkv,
                                          causal, window, st);
    return (int)cudaErrorInvalidValue;
}
