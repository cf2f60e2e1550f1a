// Causal GQA flash attention with an optional sliding window (Hopper, sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (body _flash_kernel): q [B,T,H,hd] against k, v
// [B,S,Hkv,hd], query head h reading kv head h / (H/Hkv), scores scaled by
// f32(hd^-0.5), masked to -1e30 (not -inf) where a key is in the future
// (causal: k_pos > q_pos) or out of the window (k_pos <= q_pos - window), both
// positions counted from 0; an online softmax with an f32 running max m,
// normaliser l and accumulator; out = acc / max(l, 1e-30) in q's dtype. A row
// with every key masked so gets the uniform average, as the Pallas kernel
// gives, not NaN. It is the prefill attention of every layer of the LM
// serving path (models/attention.py::prefill_cache and self_attention).
//
// The TPU kernel runs a dense grid over (b, h, q block, kv block), kv
// minor-most, its m/l/acc carried in VMEM scratch from one grid step to the
// next. Blocks run in no order here, so one CTA owns one (q block, h, b) and
// walks its kv tiles in a loop, m/l/acc in registers. Two rules hold for both
// instances below:
//
//   * Tiles wholly above the causal diagonal or wholly before the window are
//     skipped. That is exact: in the Pallas kernel such a tile adds
//     exp(-1e30 - m) = 0 to a row whose max is real, and a tile met while a
//     row's max is still -1e30 adds terms that the first real tile scales by
//     exp(-1e30 - m) = 0. Where some row of the block has no key at all (a
//     window that ends before the keys start, T > S), no tile is skipped.
//   * T and S need not be multiples of the tile: query rows past T are not
//     stored, key columns past S take p = 0 exactly (the TPU kernel never has
//     such columns, so they must not count in l).
//
// Bound on this card: operations. Yi-6B's prefill (B 4, T = S = 1024, H 32,
// Hkv 4, hd 128, causal) needs 4*B*H*hd*T(T+1)/2 = 3.4e10 flops against
// 75.5 MB of traffic: 35 us at the bf16 tensor-core rate, 22 us of bytes.
//
// bf16: tensor cores (wgmma + TMA, warp-specialised)
// --------------------------------------------------
// One CTA per (128-query block, query head, batch), 384 threads, launched
// heaviest causal block first across all heads (a 1-D grid whose slowest
// index is the reversed query block).
//
//   * Warpgroup 2 is the producer. It drops to 40 registers (setmaxnreg) and
//     one of its threads starts every TMA load: Q once (hd/64 boxes of
//     64 columns x 128 rows, 128-byte swizzle: a bf16 hd-128 row is 256 bytes
//     and a swizzled box row at most 128), then K and V tiles of BK = 128 keys
//     into a ring of 2 stages. A stage's K and V complete one `full` mbarrier
//     (expect_tx of the full box bytes: TMA zero-fills rows past T or S and
//     still counts them); the consumers free it through an `empty` mbarrier
//     (256 arrivals). The tensor maps are 4-D, dims {hd, heads, T|S, B}, box
//     {64, 1, 128, 1}, built on the host per launch with
//     cuTensorMapEncodeTiled (taken from libcuda.so.1 with dlsym: the library
//     links nothing) and passed by value as __grid_constant__, so a launch
//     inside a CUDA graph capture keeps its maps.
//   * Warpgroups 0 and 1 are consumers of 64 query rows each, at 232
//     registers. Per tile: S = Q K^T with wgmma m64n128k16 (bf16 -> f32,
//     both operands K-major in shared memory: descriptors step 32 bytes per
//     k16 inside a 64-column box and jump a box, 16 KB, between boxes; SBO
//     1024 bytes between 8-row groups). The mask is applied in registers on
//     the accumulator fragment, only on tiles that cross the diagonal, the
//     window edge or S. Scores are kept in log2 units, s * f32(hd^-0.5) *
//     log2(e), and exponentials are ex2.approx.ftz (one MUFU op; a p below
//     2^-126, under 1e-38 of its row's sum, flushes to 0): masked scores are
//     -1e30 and m starts at -1e30, so 2^(-1e30 - m) is 0 under a real max
//     and 1 in a row with no key, as exp() gives in the Pallas kernel. The
//     row max is a quad reduction (shfl_xor 1, 2: a row's 128 columns sit in
//     4 lanes); l is summed per lane and reduced once at the end.
//   * O += P V: P is rounded to bf16 pairs in registers (the m64nNk16
//     accumulator's fragment is the register-A fragment of the next wgmma,
//     pair for pair), V is the MN-major B operand (transpose flag set; LBO
//     16 KB between 64-column boxes, SBO 1024 bytes between 8-key groups,
//     2 KB a k16 step), m64n{hd}k16. P in bf16 is the one rounding the Pallas
//     kernel does not have: tests/test_torch_flash_tiles.py emulates this
//     order of operations on the CPU and bounds its error.
//   * The epilogue multiplies by the reciprocal of max(l, 1e-30) (within an
//     ulp of the f32 division), rounds once to bf16 and stores the rows below
//     T from registers.
//
// On the H100 (ptxas -v of CUDA 12.8, sm_90a): both instances report 168
// registers, the launch bound of 384 threads; ptxas allocates the consumers
// within it although setmaxnreg grants them 232, so hd 128 spills 64 bytes
// (loop invariants, reloaded once a tile) and hd 64 nothing. The SASS holds
// 28 HGMMA (cuobjdump -sass; chip_smoke.py counts them). Measured there and
// dropped (PERF.md, section 6): ping-pong of the two consumers on named
// barriers, P V left in flight behind the next tile's Q K^T, a third stage;
// each was slower or no faster.
//
// f32: CUDA cores
// ---------------
// TF32 wgmma keeps 10 mantissa bits and would break the f32 instance's 2e-5
// tolerance (the serving path's card-vs-CPU parity runs it), so f32 stays on
// CUDA cores: BQ = 64 queries and BK = 64 keys a tile, 256 threads. Thread
// (ty, tx) = (tid / 16, tid % 16) owns query rows ty + 16 i (i < 4); for a kv
// tile it computes the 4 x 4 scores of those rows against keys tx + 16 j from
// Q and K in shared memory (rows padded by one word so neither operand
// conflicts on a bank), and the output columns tx + 16 c (c < hd/16) of the
// same rows, so each row's rescale factor stays in the registers of the 16
// threads that share the row; row max and row sum are butterfly shuffles
// inside a half-warp; P goes through shared memory to the P.V product.

#include <cmath>
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <math_constants.h>

#include "smem_attr.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

// The key range a block of queries [q0, q_last] needs: every tile, unless
// each of its rows has a key, in which case tiles wholly masked for all rows
// are skipped.
__device__ __forceinline__ void key_range(int q0, int q_last, int S,
                                          int causal, int window, int& lo,
                                          int& hi) {
    lo = 0;
    hi = S - 1;
    const bool every_row_has_a_key =
        window <= 0 || (long long)q_last <= (long long)S + window - 2;
    if (every_row_has_a_key) {
        if (causal) hi = min(hi, q_last);
        if (window > 0) lo = max(0, q0 - window + 1);
    }
}

// ------------------------------------------------------------ f32, CUDA cores
namespace cores {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;

template <int HD>
constexpr size_t smem_bytes() {
    // Q [BQ][HD+1], K [BK][HD+1], V [BK][HD], P [BQ][BK+1], all f32
    return sizeof(float) * (BQ * (HD + 1) + BK * (HD + 1) + BK * HD
                            + BQ * (BK + 1));
}

template <int HD>
__global__ void __launch_bounds__(NT, 2) flash_attention_f32_kernel(
        const float* __restrict__ q, const float* __restrict__ k,
        const float* __restrict__ v, float* __restrict__ out, int Tq, int S,
        int H, int Hkv, float sm_scale, int causal, int window) {
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
    const float* qbase = q + ((long long)b * Tq * H + h) * HD;
    const float* kbase = k + ((long long)b * S * Hkv + hk) * HD;
    const float* vbase = v + ((long long)b * S * Hkv + hk) * HD;

    for (int i = tid; i < BQ * HD; i += NT) {
        const int r = i / HD, d = i - r * HD;
        const int pos = q0 + r;
        Qs[r * (HD + 1) + d] = pos < Tq ? qbase[pos * q_stride + d] : 0.f;
    }

    int lo, hi;
    key_range(q0, min(q0 + BQ, Tq) - 1, S, causal, window, lo, hi);

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
            Ks[r * (HD + 1) + d] = in ? kbase[pos * kv_stride + d] : 0.f;
            Vs[r * HD + d] = in ? vbase[pos * kv_stride + d] : 0.f;
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
        float* orow = out + ((long long)b * Tq * H + h) * HD + pos * q_stride;
#pragma unroll
        for (int c = 0; c < NC; ++c) orow[tx + 16 * c] = acc[i][c] / denom;
    }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Tq, int S, int H, int Hkv, int causal, int window,
           cudaStream_t stream) {
    constexpr size_t smem = smem_bytes<HD>();
    auto kern = flash_attention_f32_kernel<HD>;
    // above 48 KB of shared memory only on request, once per instance and
    // device
    static bool configured[kMaxDevices] = {};
    const cudaError_t err = set_smem_once(configured, kern, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((Tq + BQ - 1) / BQ, H, B);
    const float sm_scale = (float)(1.0 / sqrt((double)HD));   // f32(hd^-0.5)
    kern<<<grid, NT, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), Tq, S, H, Hkv,
        sm_scale, causal, window);
    return (int)cudaGetLastError();
}

}  // namespace cores

// ------------------------------------------------- bf16, wgmma + TMA (sm_90a)
namespace tc {

constexpr int BQ = 128;              // queries a CTA: two consumer warpgroups
constexpr int BK = 128;              // keys a K/V stage
constexpr int NSTAGE = 2;
constexpr int NT = 384;              // warpgroups 0, 1 consume; 2 produces
constexpr int BOX = 128 * 128;       // one TMA box: 128 rows x 64 bf16 columns
constexpr float LOG2E = 1.4426950408889634f;

template <int HD>
struct Layout {                      // byte offsets from the 1024-aligned base
    static constexpr int NB = HD / 64;          // 64-column boxes a tile
    static constexpr int TILE = NB * BOX;       // one Q, K or V tile
    static constexpr int Q = 0;
    static constexpr int K = Q + TILE;          // stage s at K + s * TILE
    static constexpr int V = K + NSTAGE * TILE;
    static constexpr int BAR = V + NSTAGE * TILE;   // q, full[2], empty[2]
    static constexpr int ALLOC = BAR + 8 * (1 + 2 * NSTAGE) + 1024;
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
                 :: "r"(bar) : "memory");
}

// A phase that never completes is a fault of the kernel: it traps (the
// launch fails) instead of holding the card. No wait on the path is longer
// than one tile's work.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    for (uint32_t n = 0;; ++n) {
        uint32_t done;
        asm volatile("{\n.reg .pred p;\n"
                     "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                     "selp.u32 %0, 1, 0, p;\n}"
                     : "=r"(done) : "r"(bar), "r"(parity) : "memory");
        if (done) return;
        if (n == (1u << 26)) __trap();
    }
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
           "r"(c0), "r"(c1), "r"(c2), "r"(c3)
        : "memory");
}

// A wgmma shared-memory descriptor for a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (in 16-byte units), layout 1.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
    return (uint64_t)((addr & 0x3FFFF) >> 4)
           | ((uint64_t)(lbo >> 4) << 16)
           | ((uint64_t)(sbo >> 4) << 32)
           | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// 2^x, one MUFU op: a result below 2^-126 flushes to 0 (exp2f spends three
// more instructions a value to keep it subnormal)
__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous wgmma and its wait
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

#define ACC8(i)                                                         \
    "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),         \
    "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64] (+)= A[64x16] B[16x128]: A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}"
        : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48),
          ACC8(56)
        : "l"(da), "l"(db), "r"(accumulate));
}

// d[64] += A[64x16] B[16x128]: A in registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t* a,
                                         uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}"
        : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48),
          ACC8(56)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[32] += A[64x16] B[16x64]: A in registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a,
                                         uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}"
        : ACC8(0), ACC8(8), ACC8(16), ACC8(24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef ACC8

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // .x = lo
    return *reinterpret_cast<const uint32_t*>(&p);
}

template <int HD>
__global__ void __launch_bounds__(NT, 1) flash_attention_bf16_kernel(
        const __grid_constant__ CUtensorMap tq,
        const __grid_constant__ CUtensorMap tk,
        const __grid_constant__ CUtensorMap tv,
        __nv_bfloat16* __restrict__ out, int Tq, int S, int H, int Hkv,
        int nqb, float scale_log2, int causal, int window) {
    using L = Layout<HD>;
    extern __shared__ uint8_t smem_raw[];
    // 128-byte swizzle repeats every 1024 bytes: tiles start on that grid
    const uint32_t base =
        ((uint32_t)__cvta_generic_to_shared(smem_raw) + 1023u) & ~1023u;
    const uint32_t qbar = base + L::BAR;
    const uint32_t full = qbar + 8;                  // full[s] = full + 8 s
    const uint32_t empty = full + 8 * NSTAGE;

    // heaviest causal blocks (the last queries of every head) first
    const int hb = gridDim.x / nqb;                  // = H * B
    const int qb = nqb - 1 - (int)(blockIdx.x / hb);
    const int h = (int)(blockIdx.x % hb) % H;
    const int b = (int)(blockIdx.x % hb) / H;
    const int hk = h / (H / Hkv);
    const int q0 = qb * BQ;
    int lo, hi;
    key_range(q0, min(q0 + BQ, Tq) - 1, S, causal, window, lo, hi);
    const int t0 = lo / BK;
    const int n_tiles = hi / BK - t0 + 1;

    const int tid = threadIdx.x;
    if (tid == 0) {
        mbar_init(qbar, 1);
        for (int s = 0; s < NSTAGE; ++s) {
            mbar_init(full + 8 * s, 1);
            mbar_init(empty + 8 * s, 2 * 128);
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    if (tid >= 256) {
        // ---------------------------------------------------- producer
        asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
        if (tid == 256) {
            mbar_expect_tx(qbar, L::TILE);
            for (int c = 0; c < L::NB; ++c)
                tma_load(base + L::Q + c * BOX, &tq, qbar, 64 * c, h, q0, b);
            for (int i = 0; i < n_tiles; ++i) {
                const int s = i % NSTAGE;
                if (i >= NSTAGE)                     // tile i - NSTAGE read
                    mbar_wait(empty + 8 * s, ((i / NSTAGE) - 1) & 1);
                const uint32_t bar = full + 8 * s;
                const int k0 = (t0 + i) * BK;
                mbar_expect_tx(bar, 2 * L::TILE);
                for (int c = 0; c < L::NB; ++c) {
                    tma_load(base + L::K + s * L::TILE + c * BOX, &tk, bar,
                             64 * c, hk, k0, b);
                    tma_load(base + L::V + s * L::TILE + c * BOX, &tv, bar,
                             64 * c, hk, k0, b);
                }
            }
            // stay until the last stages are read, so no load outlives the
            // thread that started it
            for (int i = max(n_tiles, NSTAGE); i < n_tiles + NSTAGE; ++i)
                mbar_wait(empty + 8 * (i % NSTAGE), ((i / NSTAGE) - 1) & 1);
        }
    } else {
        // --------------------------------------------------- consumers
        asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
        const int wg = tid / 128;
        const int warp = (tid % 128) / 32;
        const int lane = tid % 32;
        const int q_lo = q0 + 64 * wg;               // this warpgroup's rows
        const int row0 = q_lo + 16 * warp + lane / 4;  // and row0 + 8
        const int col0 = 2 * (lane % 4);
        // accumulator fragment of m64nNk16: d[4 j + 2 r + c] is row
        // row0 + 8 r, column 8 j + col0 + c
        float o[HD / 2];
#pragma unroll
        for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
        float m[2] = {NEG_INF, NEG_INF};
        float l[2] = {0.f, 0.f};                      // this lane's columns
        const uint32_t qaddr = base + L::Q + wg * 64 * 128;
        mbar_wait(qbar, 0);

        for (int i = 0; i < n_tiles; ++i) {
            const int s = i % NSTAGE;
            const int k0 = (t0 + i) * BK;
            const uint32_t kaddr = base + L::K + s * L::TILE;
            const uint32_t vaddr = base + L::V + s * L::TILE;
            mbar_wait(full + 8 * s, (i / NSTAGE) & 1);

            // S = Q K^T, f32, over hd in k16 steps
            float sc[64];
            wg_fence();
#pragma unroll
            for (int kk = 0; kk < HD / 16; ++kk) {
                const uint32_t off = (kk / 4) * BOX + (kk % 4) * 32;
                wgmma_ss_n128(sc, desc(qaddr + off, 16, 1024),
                              desc(kaddr + off, 16, 1024), kk > 0);
            }
            wg_commit();
            wg_wait_all();
            reg_fence(sc);

            // scale to log2 units; mask only where the tile needs it
            const bool edge = (causal && k0 + BK - 1 > q_lo)
                              || (window > 0 && k0 <= q_lo + 63 - window)
                              || k0 + BK > S;
            if (edge) {
#pragma unroll
                for (int j = 0; j < 16; ++j)
#pragma unroll
                    for (int r = 0; r < 2; ++r)
#pragma unroll
                        for (int c = 0; c < 2; ++c) {
                            const int kpos = k0 + 8 * j + col0 + c;
                            const int qpos = row0 + 8 * r;
                            const bool ok =
                                (!causal || kpos <= qpos)
                                && (window <= 0 || kpos > qpos - window);
                            float& x = sc[4 * j + 2 * r + c];
                            x = kpos >= S ? -CUDART_INF_F
                                          : (ok ? x * scale_log2 : NEG_INF);
                        }
            } else {
#pragma unroll
                for (int i2 = 0; i2 < 64; ++i2) sc[i2] *= scale_log2;
            }

            // online softmax: a row's 128 columns are in the 4 lanes of a
            // quad; column k0 < S is in every tile, so the max is finite
            float alpha[2];
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                float mx = -CUDART_INF_F;
#pragma unroll
                for (int j = 0; j < 16; ++j)
                    mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * r],
                                         sc[4 * j + 2 * r + 1]));
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
                const float m_new = fmaxf(m[r], mx);
                alpha[r] = ex2(m[r] - m_new);
                m[r] = m_new;
                l[r] *= alpha[r];
            }
            uint32_t pa[32];                          // P as bf16 pairs
#pragma unroll
            for (int t = 0; t < 32; ++t) {
                const int r = t % 2;                  // 2t = 4 j + 2 r
                const float p0 = ex2(sc[2 * t] - m[r]);
                const float p1 = ex2(sc[2 * t + 1] - m[r]);
                l[r] += p0 + p1;
                pa[t] = pack_bf16(p0, p1);
            }
#pragma unroll
            for (int i2 = 0; i2 < HD / 2; ++i2) o[i2] *= alpha[(i2 / 2) % 2];

            // O += P V over the tile's keys in k16 steps
            reg_fence(o);
            wg_fence();
#pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk)
                wgmma_rs(o, pa + 4 * kk, desc(vaddr + kk * 2048, BOX, 1024));
            wg_commit();
            wg_wait_all();
            reg_fence(o);
            mbar_arrive(empty + 8 * s);               // stage s is read
        }

#pragma unroll
        for (int r = 0; r < 2; ++r) {
            float lt = l[r];
            lt += __shfl_xor_sync(0xffffffffu, lt, 1);
            lt += __shfl_xor_sync(0xffffffffu, lt, 2);
            // one reciprocal a row (MUFU; l >= 1 here) and multiplies: an
            // IEEE division a value would call its slow path 64 times, and a
            // call keeps the region at the entry's register budget
            const float inv = __fdividef(1.f, fmaxf(lt, 1e-30f));
            const int qpos = row0 + 8 * r;
            if (qpos < Tq) {
                __nv_bfloat16* orow =
                    out + (((long long)b * Tq + qpos) * H + h) * HD;
#pragma unroll
                for (int j = 0; j < HD / 8; ++j)
                    *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + col0) =
                        __floats2bfloat162_rn(o[4 * j + 2 * r] * inv,
                                              o[4 * j + 2 * r + 1] * inv);
            }
        }
    }
}

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// libcuda's tensor-map encoder, looked up once (the library links nothing)
EncodeTiled encoder() {
    static const EncodeTiled fn = [] {
        void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
        return lib ? reinterpret_cast<EncodeTiled>(
                         dlsym(lib, "cuTensorMapEncodeTiled"))
                   : nullptr;
    }();
    return fn;
}

// a bf16 [B, len, heads, hd] tensor as a 4-D map {hd, heads, len, B}, box
// {64, 1, 128, 1}, 128-byte swizzle, out-of-bounds rows read as zeros
bool encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int B,
            int len, int heads, int hd) {
    const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                                (cuuint64_t)len, (cuuint64_t)B};
    const cuuint64_t strides[3] = {
        (cuuint64_t)hd * 2, (cuuint64_t)heads * hd * 2,
        (cuuint64_t)len * heads * hd * 2};
    const cuuint32_t box[4] = {64, 1, (cuuint32_t)BK, 1};
    const cuuint32_t elem[4] = {1, 1, 1, 1};
    return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
              const_cast<void*>(ptr), dims, strides, box, elem,
              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
              CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Tq, int S, int H, int Hkv, int causal, int window,
           cudaStream_t stream) {
    static_assert(BQ == BK, "one box shape serves Q, K and V");
    const EncodeTiled fn = encoder();
    if (fn == nullptr) return (int)cudaErrorSharedObjectSymbolNotFound;
    CUtensorMap tq, tk, tv;
    if (!encode(fn, &tq, q, B, Tq, H, HD) || !encode(fn, &tk, k, B, S, Hkv, HD)
        || !encode(fn, &tv, v, B, S, Hkv, HD))
        return (int)cudaErrorInvalidValue;
    auto kern = flash_attention_bf16_kernel<HD>;
    static bool configured[kMaxDevices] = {};
    const cudaError_t err = set_smem_once(configured, kern, Layout<HD>::ALLOC);
    if (err != cudaSuccess) return (int)err;
    const int nqb = (Tq + BQ - 1) / BQ;
    const long long blocks = (long long)nqb * H * B;
    if (blocks >= (1ll << 31)) return (int)cudaErrorInvalidConfiguration;
    const float scale_log2 = (float)(1.0 / sqrt((double)HD)) * LOG2E;
    kern<<<(unsigned)blocks, NT, Layout<HD>::ALLOC, stream>>>(
        tq, tk, tv, static_cast<__nv_bfloat16*>(out), Tq, S, H, Hkv, nqb,
        scale_log2, causal, window);
    return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (wgmma + TMA; q, k, v 16-byte
// aligned); hd: 64 or 128; window <= 0 = none. Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for a dtype or head width without
// an instance, or a tensor the tensor-map encoder refuses).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int Tq,
                                      int S, int H, int Hkv, int hd,
                                      int causal, int window, int dtype,
                                      void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0 && hd == 64)
        return cores::launch<64>(q, k, v, out, B, Tq, S, H, Hkv, causal,
                                 window, st);
    if (dtype == 0 && hd == 128)
        return cores::launch<128>(q, k, v, out, B, Tq, S, H, Hkv, causal,
                                  window, st);
    if (dtype == 1 && hd == 64)
        return tc::launch<64>(q, k, v, out, B, Tq, S, H, Hkv, causal, window,
                              st);
    if (dtype == 1 && hd == 128)
        return tc::launch<128>(q, k, v, out, B, Tq, S, H, Hkv, causal, window,
                               st);
    return (int)cudaErrorInvalidValue;
}
