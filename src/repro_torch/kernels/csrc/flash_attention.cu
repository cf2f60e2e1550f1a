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
// In f32 (151 MB) the same flops take 208 us at a third of the TF32 rate
// (the three passes below), 513 us at the CUDA cores' 67 TFLOP/s.
//
// bf16: tensor cores (wgmma + TMA, warp-specialised)
// --------------------------------------------------
// One CTA per (128-query block, query head, batch), 384 threads, launched
// heaviest causal block first across all heads (a 1-D grid whose slowest
// index is the reversed query block).
//
//   * Warpgroup 2 is the producer. It drops to 40 registers (setmaxnreg) and
//     one of its threads starts every TMA load: Q once (ceil(hd/64) boxes of
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
//     2 KB a k16 step), m64n{PD}k16 (PD: hd padded to a multiple of 64,
//     below). P in bf16 is the one rounding the Pallas kernel does not
//     have: tests/test_torch_flash_tiles.py emulates this order of
//     operations on the CPU and bounds its error.
//   * The epilogue multiplies by the reciprocal of max(l, 1e-30) (within an
//     ulp of the f32 division), rounds once to bf16 and stores the rows below
//     T from registers.
//
// Head widths 80 and 112 (HuBERT-XLarge's 1280/16, Zamba2-7B's shared block's
// 3584/32). Both instances are templated on the true width HD; the f32 one
// needs nothing more (HD / 8 k8 steps of Q K^T, P V at N = HD: 80 and 112
// are multiples of 8, and its V^T is K-major). The bf16 one runs on
// a padded width PD = 64 * ceil(HD / 64), 128 for both: the tensor maps
// keep dim 0 = HD, so TMA zero-fills the box columns at and past HD in Q,
// K and V (and still counts them in expect_tx). Q K^T steps over HD only
// (5 or 7 k16 steps: a box of 64 columns holds whole k16 steps, and the
// zero columns past HD are never read); P V runs m64n128k16 over all PD
// columns, whose columns past HD come out 0 and are not stored; the scale
// is f32(HD^-0.5) of the true width. Chosen over native m64n80k16 /
// m64n112k16 for P V: those N are valid, but an N that is not a multiple of
// 64 splits the MN-major, 128-byte-swizzled V operand mid-atom, while the
// padding reuses the hd-128 path as it is. It costs P V 1.6x (hd 80) and
// 1.14x (hd 112) its tensor-core work, the whole kernel 1.3x and 1.07x
// (PERF.md, section 6, times it).
//
// On the H100 (ptxas -v of CUDA 12.8, sm_90a): every bf16 instance reports
// 168 registers, the launch bound of 384 threads; ptxas allocates the
// consumers within it although setmaxnreg grants them 232, so hd 128 and
// 112 spill 64 bytes, hd 80 48 (loop invariants, reloaded once a tile) and
// hd 64 nothing. The SASS holds 56 HGMMA over the four widths (28 for hd
// 64 and 128; cuobjdump -sass; chip_smoke.py counts them). Measured there and
// dropped (PERF.md, section 6): ping-pong of the two consumers on named
// barriers, P V left in flight behind the next tile's Q K^T, a third stage;
// each was slower or no faster.
//
// f32: 3xTF32 on the tensor cores (wgmma)
// ---------------------------------------
// One TF32 pass keeps 10 of f32's 23 mantissa bits of each operand: scores
// off by about 2^-11 |q||k| miss the f32 instance's 2e-5 tolerance (the
// serving path's card-vs-CPU parity runs it) 12 to 62 times over
// (tests/test_torch_flash_tf32.py). So each operand is split, x = hi +
// lo, hi = rna(x) and lo = rna(x - hi), rna being cvt.rna.tf32.f32 (round
// at bit 13, ties away from zero): both exact in
// TF32, x - hi exact in f32, |x - hi - lo| <= 2^-22 |x|. A product is
// lo*hi' + hi*lo' + hi*hi', accumulated in f32 in that order, the small
// terms first, and lo*lo' (2^-22) dropped: about 21 bits, on the tensor cores
// at a third of their 495 TFLOP/s TF32 rate, 2.5x the CUDA cores' 67. The
// split has to be explicit: fed f32 bits, the tensor core drops the low 13
// itself and nothing carries them. rna here is an add and a mask on the f32
// bits, equal to the cvt for every finite value: ptxas emits four
// instructions for the cvt (a NaN check and a select besides).
//
//   * One CTA per (64 or 128 query rows, head, batch): one or two consumer
//     warpgroups of 64 rows, no producer. The height is chosen at launch:
//     128 rows where that grid still gives every SM a CTA (B * H * ceil(T /
//     128) >= the SM count), else 64. A row's key tiles, their order and its
//     arithmetic do not depend on the height (the skip rule only adds or
//     drops tiles that change the row by exact zeros), so the choice changes
//     no result: tests/test_torch_flash_tf32.py holds the rows equal.
//   * Both products are wgmma m64nNk8 TF32 with A in registers and B K-major
//     in shared memory (the only layout wgmma takes for a TF32 operand in
//     shared memory), three wgmma a k8 step. Q K^T: Q's fragments are read
//     from device memory once into registers (HD / 2 floats a thread) and
//     split at each step (held split they would take HD more registers); B
//     is the split K tile, N = 64 keys. P V: P is split from the score
//     accumulator, whose fragment is the A fragment of the next product once
//     the keys of each group of 8 are permuted (A's columns t, t + 4 are keys
//     2t, 2t + 1); B is the split V^T tile, N = HD (80 and 112 run at their
//     width), its keys permuted alike. Two A fragments are in flight: a
//     step's split overlaps the last step's wgmma.
//   * The split is paid once a value, not once a warp: K and V tiles of
//     BK = 64 keys land by cp.async (16 bytes a thread, rows past S
//     zero-filled) in raw buffers; each thread splits the chunks it copied
//     (its own copies are visible to it after cp.async.wait_group) into the
//     128-byte-swizzled hi and lo tiles, K as it is, V transposed, and fences
//     them to the async proxy before the barrier that precedes the wgmma.
//     V's copies are assigned so that its transposing stores fill whole
//     rows, free of bank conflicts (assigned as K's are, they conflict
//     16-way: a Yi-6B f32 prefill took 0.62 ms so, 0.51 without).
//   * Pipeline: one raw K and one raw V buffer, two barriers a tile. K_j+1
//     loads while tile j's softmax and P V run, V_j+1 while Q K_j+1^T runs.
//     Shared memory binds: raw and split tiles take 193 KB at hd 128 (177 /
//     129 / 97 KB at hd 112 / 80 / 64), one CTA an SM (two at hd 64), so a
//     second stage does not fit.
//   * The softmax stays f32 and in natural units, as the Pallas kernel's:
//     x = s * f32(hd^-0.5), exp as 2^((x - m) log2 e) with ex2.approx.ftz.
//     Folding log2 e into the scale (the bf16 instance's way) would round
//     every score once more at its own magnitude; here only x - m is scaled.
//     Masks apply only on tiles that cross the diagonal, the window edge or
//     S; the row max is a quad reduction, l is summed per lane; the epilogue
//     multiplies by the reciprocal of max(l, 1e-30).
//
// Why wgmma (PERF.md, section 6): mma.sync m16n8k8 for both products was
// measured first; at Yi-6B's f32 prefill it reached 45 TFLOP/s of f32 work,
// 136 TFLOP/s of TF32 HMMA.1688, under a third of wgmma's 495 (0.76 ms
// against 0.51 for this design).

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
    static constexpr int NB = (HD + 63) / 64;   // 64-column boxes a tile
    static constexpr int PD = 64 * NB;          // the padded head width
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
        // row0 + 8 r, column 8 j + col0 + c; N = PD, the columns past HD
        // stay 0 (V's are zero-filled)
        float o[L::PD / 2];
#pragma unroll
        for (int i = 0; i < L::PD / 2; ++i) o[i] = 0.f;
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

            // S = Q K^T, f32, over the true hd in k16 steps
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
            for (int i2 = 0; i2 < L::PD / 2; ++i2)
                o[i2] *= alpha[(i2 / 2) % 2];

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
// {64, 1, 128, 1}, 128-byte swizzle, out-of-bounds rows (and columns past an
// hd that is not a multiple of 64) read as zeros
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

// ------------------------------ f32, 3xTF32 on the tensor cores (wgmma)
namespace tf32 {

using tc::desc;
using tc::ex2;
using tc::LOG2E;
using tc::reg_fence;
using tc::wg_commit;
using tc::wg_fence;

constexpr int BK = 64;               // keys a K/V tile
constexpr int BOX = BK * 128;        // a split K tile's box: 64 rows x 32 f32

template <int HD>
struct Layout {                      // byte offsets from the 1024-aligned base
    static constexpr int RAW = BK * HD * 4;     // a K or V tile as it lands
    // the split tiles, hi and lo each: K in boxes of 32 head columns, V^T in
    // boxes of 32 keys (HD rows)
    static constexpr int K_TILE = (HD + 31) / 32 * BOX;
    static constexpr int V_BOX = HD * 128;
    static constexpr int V_TILE = BK / 32 * V_BOX;
    static constexpr int K_RAW = 0;
    static constexpr int V_RAW = RAW;
    static constexpr int K_HI = 2 * RAW;        // RAW: a multiple of 1024
    static constexpr int K_LO = K_HI + K_TILE;
    static constexpr int V_HI = K_LO + K_TILE;
    static constexpr int V_LO = V_HI + V_TILE;
    static constexpr int ALLOC = V_LO + V_TILE + 1024;
};

// byte offset of 16-byte chunk `chunk` (of 8) of row `row` in a box of
// 128-byte rows under the 128-byte swizzle (the chunk index XOR row % 8)
__device__ __forceinline__ int swz(int row, int chunk) {
    return row * 128 + (((chunk ^ row) & 7) << 4);
}

// cvt.rna.tf32.f32 for finite x (and +-inf): round the f32 bits at bit 13,
// ties away from zero. Two integer instructions; ptxas emits four for the
// cvt itself (a NaN check and a select besides).
__device__ __forceinline__ float rna_tf32(float x) {
    return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
}

// x = hi + lo + r: hi and lo exact in TF32, x - hi exact in f32,
// |r| <= 2^-22 |x|
__device__ __forceinline__ void split(float x, float& hi, float& lo) {
    hi = rna_tf32(x);
    lo = rna_tf32(x - hi);
}

__device__ __forceinline__ void split4(const float (&x)[4], float (&hi)[4],
                                       float (&lo)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) split(x[i], hi[i], lo[i]);
}

template <int N>
__device__ __forceinline__ void wg_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

#define ACC8(i)                                                         \
    "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),         \
    "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d[32] (+)= A[64x8] B[8x64]: A (TF32) in registers, B K-major in shared
// memory (128-byte swizzle); scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const float (&a)[4],
                                        uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n}"
        : ACC8(0), ACC8(8), ACC8(16), ACC8(24)
        : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])),
          "r"(__float_as_uint(a[2])), "r"(__float_as_uint(a[3])), "l"(db),
          "r"(scale_d));
}

// d[40] (+)= A[64x8] B[8x80]: A (TF32) in registers, B K-major in shared
// memory (128-byte swizzle); scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_rs(float (&d)[40], const float (&a)[4],
                                        uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, "
        "{%40, %41, %42, %43}, %44, p, 1, 1;\n}"
        : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32)
        : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])),
          "r"(__float_as_uint(a[2])), "r"(__float_as_uint(a[3])), "l"(db),
          "r"(scale_d));
}

// d[56] (+)= A[64x8] B[8x112]: A (TF32) in registers, B K-major in shared
// memory (128-byte swizzle); scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_rs(float (&d)[56], const float (&a)[4],
                                        uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n112k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "
        "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, "
        "%55}, "
        "{%56, %57, %58, %59}, %60, p, 1, 1;\n}"
        : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48)
        : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])),
          "r"(__float_as_uint(a[2])), "r"(__float_as_uint(a[3])), "l"(db),
          "r"(scale_d));
}

// d[64] (+)= A[64x8] B[8x128]: A (TF32) in registers, B K-major in shared
// memory (128-byte swizzle); scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const float (&a)[4],
                                        uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "
        "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1;\n}"
        : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48),
          ACC8(56)
        : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])),
          "r"(__float_as_uint(a[2])), "r"(__float_as_uint(a[3])), "l"(db),
          "r"(scale_d));
}

#undef ACC8

// K rows [k0, k0 + BK) of one kv head into the raw tile, one 16-byte
// cp.async a chunk, chunk i (row i / (HD / 4)) by thread i % NT; rows past S
// are zero-filled (nothing is read)
template <int HD, int NT>
__device__ __forceinline__ void load_k(uint32_t dst, const float* src, int k0,
                                       int S, long long stride, int tid) {
    constexpr int CH = HD / 4;
#pragma unroll 4
    for (int i = tid; i < BK * CH; i += NT) {
        const int r = i / CH, c = i - r * CH;
        const int pos = k0 + r;
        const bool in = pos < S;
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
                     :: "r"(dst + 16 * i),
                        "l"(src + (in ? pos * stride : 0) + 4 * c),
                        "r"(in ? 16 : 0)
                     : "memory");
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
}

// V rows likewise, by units: unit u = 16 c + w copies the 16-byte chunk c
// (head columns 4c .. 4c + 3) of rows 8 (w / 2) + w % 2 + 2e, e < 4: four keys
// that lie side by side in V^T (see split_v). Its chunk e lands at
// (e * NU + u) * 16 bytes (NU units), so that the reads of split_v, like
// these copies, take consecutive 16 bytes thread by thread.
template <int HD, int NT>
__device__ __forceinline__ void load_v(uint32_t dst, const float* src, int k0,
                                       int S, long long stride, int tid) {
    constexpr int NU = BK / 4 * (HD / 4);
#pragma unroll 2
    for (int u = tid; u < NU; u += NT) {
        const int c = u / 16, w = u % 16;
        const int r0 = 8 * (w / 2) + w % 2;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int pos = k0 + r0 + 2 * e;
            const bool in = pos < S;
            asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
                         :: "r"(dst + 16 * (e * NU + u)),
                            "l"(src + (in ? pos * stride : 0) + 4 * c),
                            "r"(in ? 16 : 0)
                         : "memory");
        }
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
}

// Waits for this thread's copies of every group but the newest and splits
// the K chunks it copied into the swizzled hi and lo tiles (row = key,
// column = head column), then makes the stores visible to wgmma.
template <int HD, int NT>
__device__ __forceinline__ void split_k(uint8_t* s, int tid) {
    using L = Layout<HD>;
    constexpr int CH = HD / 4;
    asm volatile("cp.async.wait_group 1;" ::: "memory");
#pragma unroll 4
    for (int i = tid; i < BK * CH; i += NT) {
        const int r = i / CH, c = i - r * CH;
        const float4 x =
            *reinterpret_cast<const float4*>(s + L::K_RAW + 16 * i);
        float4 h, l;
        split(x.x, h.x, l.x);
        split(x.y, h.y, l.y);
        split(x.z, h.z, l.z);
        split(x.w, h.w, l.w);
        const int off = c / 8 * BOX + swz(r, c % 8);
        *reinterpret_cast<float4*>(s + L::K_HI + off) = h;
        *reinterpret_cast<float4*>(s + L::K_LO + off) = l;
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// The same for V, transposed: V^T's hi and lo tiles, row = head column,
// column = key position. Keys are permuted inside each group of 8, key
// 8j + 2u + p at position 8j + u + 4p, to match P's A fragments (see P V):
// unit 16 c + w's four keys take positions 4w .. 4w + 3, one 16-byte chunk
// of each of its four rows 4c + e, and the 8 units of a quarter warp fill
// the 8 chunks of a row (free of bank conflicts).
template <int HD, int NT>
__device__ __forceinline__ void split_v(uint8_t* s, int tid) {
    using L = Layout<HD>;
    constexpr int NU = BK / 4 * (HD / 4);
    asm volatile("cp.async.wait_group 1;" ::: "memory");
#pragma unroll 2
    for (int u = tid; u < NU; u += NT) {
        const int c = u / 16, w = u % 16;
        float x[4][4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
            *reinterpret_cast<float4*>(x[e]) = *reinterpret_cast<const float4*>(
                s + L::V_RAW + 16 * (e * NU + u));
#pragma unroll
        for (int e = 0; e < 4; ++e) {                // head column 4c + e
            float4 h, l;
            split(x[0][e], h.x, l.x);
            split(x[1][e], h.y, l.y);
            split(x[2][e], h.z, l.z);
            split(x[3][e], h.w, l.w);
            const int off = w / 8 * L::V_BOX + swz(4 * c + e, w % 8);
            *reinterpret_cast<float4*>(s + L::V_HI + off) = h;
            *reinterpret_cast<float4*>(s + L::V_LO + off) = l;
        }
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

template <int HD, int NW>
__global__ void __launch_bounds__(32 * NW, 1) flash_attention_f32_kernel(
        const float* __restrict__ q, const float* __restrict__ k,
        const float* __restrict__ v, float* __restrict__ out, int Tq, int S,
        int H, int Hkv, int nqb, float scale, int causal, int window) {
    using L = Layout<HD>;
    constexpr int NT = 32 * NW;
    constexpr int BQ = 16 * NW;
    constexpr int KS = HD / 8;       // k8 steps of Q K^T
    constexpr int NB = BK / 8;       // n8 blocks of Q K^T, k8 steps of P V
    extern __shared__ uint8_t smem_raw[];
    // the 128-byte swizzle repeats every 1024 bytes: tiles start on that grid
    const uint32_t raw_addr = (uint32_t)__cvta_generic_to_shared(smem_raw);
    const uint32_t base = (raw_addr + 1023u) & ~1023u;
    uint8_t* sm = smem_raw + (base - raw_addr);

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
    const int lane = tid % 32;
    const int g = lane / 4, t = lane % 4;            // fragment row, column
    const int q_lo = q0 + 16 * (tid / 32);           // this warp's 16 rows
    const long long kv_stride = (long long)Hkv * HD;
    const float* kbase = k + ((long long)b * S * Hkv + hk) * HD;
    const float* vbase = v + ((long long)b * S * Hkv + hk) * HD;
    load_k<HD, NT>(base + L::K_RAW, kbase, t0 * BK, S, kv_stride, tid);
    load_v<HD, NT>(base + L::V_RAW, vbase, t0 * BK, S, kv_stride, tid);

    // Q's A fragments, read once: qa[kk][i] is row g + 8 (i % 2), column
    // 8 kk + t + 4 (i / 2); rows past T read as 0
    float qa[KS][4];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int pos = q_lo + g + 8 * r;
        const float* row = q + (((long long)b * Tq + pos) * H + h) * HD;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
            qa[kk][r] = pos < Tq ? __ldg(row + 8 * kk + t) : 0.f;
            qa[kk][r + 2] = pos < Tq ? __ldg(row + 8 * kk + t + 4) : 0.f;
        }
    }

    // accumulator fragments of m64nN: d[4 j + 2 r + c] is row g + 8 r,
    // column 8 j + 2 t + c of this warp's 16 rows
    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    float m[2] = {NEG_INF, NEG_INF};
    float l[2] = {0.f, 0.f};                         // this lane's columns
    float ah[2][4], al[2][4];                        // A fragments, 2 in flight
    const uint32_t k_hi = base + L::K_HI, k_lo = base + L::K_LO;
    const uint32_t v_hi = base + L::V_HI, v_lo = base + L::V_LO;

    for (int i = 0; i < n_tiles; ++i) {
        const int k0 = (t0 + i) * BK;
        // K_i split (the last Q K^T read its tiles before the last barrier)
        split_k<HD, NT>(sm, tid);
        __syncthreads();
        if (i + 1 < n_tiles)
            load_k<HD, NT>(base + L::K_RAW, kbase, k0 + BK, S, kv_stride, tid);
        else
            asm volatile("cp.async.commit_group;" ::: "memory");

        // S = Q K^T over the true hd: per k8 step lo hi', hi lo', hi hi'; Q
        // is split again each tile (held split it would take HD more
        // registers), one step's fragments split while the last one's run
        float s[32];
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
            float (&bh)[4] = ah[kk % 2];
            float (&bl)[4] = al[kk % 2];
            reg_fence(qa[kk]);                       // not hoisted: split here
            split4(qa[kk], bh, bl);
            wg_fence();
            const uint32_t off = kk / 4 * BOX + kk % 4 * 32;
            wgmma_rs(s, bl, desc(k_hi + off, 16, 1024), kk > 0);
            wgmma_rs(s, bh, desc(k_lo + off, 16, 1024), 1);
            wgmma_rs(s, bh, desc(k_hi + off, 16, 1024), 1);
            wg_commit();
            if (kk > 0) {
                wg_wait<1>();                        // step kk - 1 is done
                reg_fence(ah[(kk + 1) % 2]);
                reg_fence(al[(kk + 1) % 2]);
            }
        }
        wg_wait<0>();
        reg_fence(s);
        reg_fence(ah[(KS + 1) % 2]);
        reg_fence(al[(KS + 1) % 2]);

        // scale; mask only where the tile needs it
        const bool edge = (causal && k0 + BK - 1 > q_lo)
                          || (window > 0 && k0 <= q_lo + 15 - window)
                          || k0 + BK > S;
        if (edge) {
#pragma unroll
            for (int e = 0; e < 32; ++e) {
                const int kpos = k0 + 8 * (e / 4) + 2 * t + e % 2;
                const int qpos = q_lo + g + 8 * (e / 2 % 2);
                const bool ok = (!causal || kpos <= qpos)
                                && (window <= 0 || kpos > qpos - window);
                s[e] = kpos >= S ? -CUDART_INF_F
                                 : (ok ? s[e] * scale : NEG_INF);
            }
        } else {
#pragma unroll
            for (int e = 0; e < 32; ++e) s[e] *= scale;
        }

        // online softmax in natural units, 2^((x - m) log2 e): a row's 64
        // columns are in the 4 lanes of a quad; column k0 < S is in every
        // tile, so the max is finite
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            float mx = -CUDART_INF_F;
#pragma unroll
            for (int j = 0; j < NB; ++j)
                mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            const float m_new = fmaxf(m[r], mx);
            alpha[r] = ex2((m[r] - m_new) * LOG2E);
            m[r] = m_new;
            l[r] *= alpha[r];
        }
#pragma unroll
        for (int e = 0; e < 32; ++e) {
            const float p = ex2((s[e] - m[e / 2 % 2]) * LOG2E);
            l[e / 2 % 2] += p;
            s[e] = p;
        }
#pragma unroll
        for (int e = 0; e < HD / 2; ++e) o[e] *= alpha[e / 2 % 2];

        // V_i split (the last P V read its tiles before the last barrier)
        split_v<HD, NT>(sm, tid);
        __syncthreads();
        if (i + 1 < n_tiles)
            load_v<HD, NT>(base + L::V_RAW, vbase, k0 + BK, S, kv_stride, tid);
        else
            asm volatile("cp.async.commit_group;" ::: "memory");

        // O += P V: P's block j is the A fragment of k8 step j (its columns
        // t, t + 4 are keys 8j + 2t, 8j + 2t + 1: V^T holds them at
        // positions 8j + t, 8j + t + 4)
#pragma unroll
        for (int j = 0; j < NB; ++j) {
            float (&bh)[4] = ah[j % 2];
            float (&bl)[4] = al[j % 2];
            const float pa[4] = {s[4 * j], s[4 * j + 2], s[4 * j + 1],
                                 s[4 * j + 3]};
            split4(pa, bh, bl);
            wg_fence();
            const uint32_t off = j / 4 * L::V_BOX + j % 4 * 32;
            wgmma_rs(o, bl, desc(v_hi + off, 16, 1024), 1);
            wgmma_rs(o, bh, desc(v_lo + off, 16, 1024), 1);
            wgmma_rs(o, bh, desc(v_hi + off, 16, 1024), 1);
            wg_commit();
            if (j > 0) {
                wg_wait<1>();
                reg_fence(ah[(j + 1) % 2]);
                reg_fence(al[(j + 1) % 2]);
            }
        }
        wg_wait<0>();
        reg_fence(o);
        reg_fence(ah[(NB + 1) % 2]);
        reg_fence(al[(NB + 1) % 2]);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
        float lt = l[r];
        lt += __shfl_xor_sync(0xffffffffu, lt, 1);
        lt += __shfl_xor_sync(0xffffffffu, lt, 2);
        const float inv = 1.f / fmaxf(lt, 1e-30f);
        const int qpos = q_lo + g + 8 * r;
        if (qpos < Tq) {
            float* orow = out + (((long long)b * Tq + qpos) * H + h) * HD;
#pragma unroll
            for (int j = 0; j < HD / 8; ++j)
                *reinterpret_cast<float2*>(orow + 8 * j + 2 * t) =
                    make_float2(o[4 * j + 2 * r] * inv,
                                o[4 * j + 2 * r + 1] * inv);
        }
    }
}

template <int HD, int NW>
int launch_rows(const void* q, const void* k, const void* v, void* out,
                int B, int Tq, int S, int H, int Hkv, int causal, int window,
                cudaStream_t stream) {
    constexpr int BQ = 16 * NW;
    auto kern = flash_attention_f32_kernel<HD, NW>;
    static bool configured[kMaxDevices] = {};
    const cudaError_t err = set_smem_once(configured, kern, Layout<HD>::ALLOC);
    if (err != cudaSuccess) return (int)err;
    const int nqb = (Tq + BQ - 1) / BQ;
    const long long blocks = (long long)nqb * H * B;
    if (blocks >= (1ll << 31)) return (int)cudaErrorInvalidConfiguration;
    const float scale = (float)(1.0 / sqrt((double)HD));     // f32(hd^-0.5)
    kern<<<(unsigned)blocks, 32 * NW, Layout<HD>::ALLOC, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), Tq, S, H, Hkv,
        nqb, scale, causal, window);
    return (int)cudaGetLastError();
}

// the current device's SM count, read once per device (0 if unknown)
inline int sm_count() {
    static int sms[kMaxDevices] = {};
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
        return 0;
    if (sms[dev] == 0
        && cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                  dev) != cudaSuccess)
        sms[dev] = 0;
    return sms[dev];
}

// the query-block height: two warpgroups (128 rows) where that grid still
// gives every SM a CTA, else one (64 rows)
template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Tq, int S, int H, int Hkv, int causal, int window,
           cudaStream_t stream) {
    if ((long long)B * H * ((Tq + 127) / 128) >= sm_count())
        return launch_rows<HD, 8>(q, k, v, out, B, Tq, S, H, Hkv, causal,
                                  window, stream);
    return launch_rows<HD, 4>(q, k, v, out, B, Tq, S, H, Hkv, causal, window,
                              stream);
}

}  // namespace tf32

}  // namespace

// dtype: 0 = float32 (3xTF32 wgmma), 1 = bfloat16 (wgmma + TMA; q, k, v 16-byte
// aligned); hd: 64, 80, 112 or 128; window <= 0 = none. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a dtype or
// head width without an instance, or a tensor the tensor-map encoder
// refuses).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int Tq,
                                      int S, int H, int Hkv, int hd,
                                      int causal, int window, int dtype,
                                      void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FLASH_HD(W)                                                          \
    if (hd == W)                                                             \
        return dtype == 0 ? tf32::launch<W>(q, k, v, out, B, Tq, S, H, Hkv,  \
                                            causal, window, st)              \
             : dtype == 1 ? tc::launch<W>(q, k, v, out, B, Tq, S, H, Hkv,    \
                                          causal, window, st)                \
                          : (int)cudaErrorInvalidValue;
    FLASH_HD(64)
    FLASH_HD(80)
    FLASH_HD(112)
    FLASH_HD(128)
#undef FLASH_HD
    return (int)cudaErrorInvalidValue;
}
