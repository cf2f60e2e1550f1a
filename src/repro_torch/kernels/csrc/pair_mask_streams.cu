// Counter-based pair masks for Hopper (sm_90a): the sparse pair-mask streams
// of a whole round and the dense mask-and-apply pass, which share the
// murmur finalizer mix32.
//
// ---- pair_mask_streams: the round launch
// Replaces the Pallas TPU kernel src/repro/kernels/mask_prng.py::
// pair_mask_streams (body _pair_stream_kernel), and with it the work the
// reference fuses around that call under jit: the leaf-seed fold
// (core/streams.py::_fold_seeds), the upper-triangle-and-mirror of
// mask_streams_all_pairs, the Bonawitz signs, the recovery gate of
// dropout_cancel_streams_seeded and the engine's per-client layout
// (_client_mask_layout). For a slot at (row i, block b, peer j, counter t),
// c = b * k_mask + t:
//
//   s   = mirror ? S[min(i,j), max(i,j)] : S[i, j]
//   s   = mix32(s ^ mix32(leaf_id + LEAF_SALT))          if a leaf is folded
//   idx = mix32(mix32(s ^ IDX_SALT) + c) % m  (+ b * m for global indices)
//   mag = p + q * (mix32(mix32(s ^ VAL_SALT) + c) >> 8) / 2^24
//   val = sign[i, j] * mag
//   val = -(alive[i] * (1 - alive[j])) * val               if gated
//
// Why each step is bit-exact against the reference:
//   mirror: the reference generates each unordered pair once from the upper
//     triangle (diagonal included) and gathers the copy for (j, i); the
//     stream depends on the seed alone, so reading the seed at (min, max)
//     is the same stream, even for a matrix that is not symmetric.
//   fold: elementwise on the seed, so folding before or after the mirror is
//     the same; mix32(leaf_id + LEAF_SALT) is computed once on the host
//     (the same function), and uint32_t wraps like the reference's lanes.
//   signs: the reference draws the magnitude with sign 1 (an exact multiply)
//     and multiplies by sign[i, j] after the gather; here it is the one
//     __fmul_rn(sign, mag), the same single rounding, so a 0 sign gives
//     the same signed zero (-0.0 where mag < 0).
//   mag: only the top 24 bits are drawn, so u is exact in f32; the multiply
//     and the add are __fmul_rn / __fadd_rn, which nvcc may not contract into
//     an FMA, so the two roundings match the reference for any p, q.
//   gate: alive holds 0.0 / 1.0, so alive[i] * (1 - alive[j]) is exactly 0
//     or 1, and -(gate) * val is the reference's -gates * vals: -0.0 * val
//     keeps the XOR of the signs, as in the reference.
//   layout: each slot is written straight to its place in the output --
//     [rows, nb, peers * k_mask] (peer-major within a row, the engine's
//     client layout) or, with the pair-major flag, [rows * peers, nb,
//     k_mask] (the recovery streams' layout) -- so no gather and no permute
//     follow the launch.
//
// What bounds it. Bytes: each slot writes 8 bytes (int32 + f32) after about
// 25 integer operations, so a round of mnist_mlp's four leaves (7,975 slots)
// is bound at 0.02 us and VGG16's 54 leaves (736,575 slots) at 1.8 us. A
// launch costs 1.5-1.8 us on the H100, so the design first cuts launches --
// one a round for every leaf's pair masks, one more in a dropout round for
// every leaf's recovery streams -- and then keeps each slot short:
//
//   segments: a launch takes up to 64 segments, one a leaf (or the single
//     segment of the flat per-pair call). What a round shares -- the seed
//     and sign matrices with their row stride, alive, rows, peers, the
//     flags, p and q -- is in the launch's header; a segment holds only its
//     outputs, nb, k_mask, m, its folded leaf key and its first tile (40
//     bytes). Header and table travel in a __grid_constant__ kernel
//     parameter: no host-to-device copy, no extra launch. 64 because
//     cifar_vgg16 has 54 leaves with its BatchNorm scales and 64 x 40 bytes
//     plus the header stays under the classic 4 KB parameter limit; a round
//     with more leaves launches once per 64 (the same kernel). A CTA finds
//     its segment by a binary search over the first tiles.
//   tile: a CTA of 256 threads owns consecutive output slots of one
//     segment, and the launcher picks one of two instances by the launch's
//     size (both write the same bits):
//     - large (more slots than one wave of one-slot CTAs holds: 256 x 8
//       CTAs x the card's SMs, 270,336 on the H100): 1,024 slots a CTA, 4
//       a thread. A thread decomposes its first slot once (three 32-bit
//       divisions) and steps the next three by carries. Its four indices
//       and four values go out as one 16-byte store each where the
//       segment's outputs are 16-byte aligned (the wrapper aligns every
//       leaf's offset in its one int32 and one f32 buffer to 4 elements);
//       the ragged last group stores slot by slot.
//     - small: 256 slots a CTA, one a thread, so a launch of a few
//       thousand slots spreads over more SMs and no thread runs four slots
//       in a row. On the H100 the small instance takes about a third less
//       time than the large one for the mnist_mlp round and the flat
//       calls, and the large one half the time of the small one for the
//       VGG16 round (PERF.md).
//     Offsets inside a segment are 32-bit (the host refuses a segment of
//     2^31 slots or more).
//   base words: in the large instance the threads first compute, for each
//     of the segment's rows x peers pairs, the folded mix32(s ^ IDX_SALT)
//     and mix32(s ^ VAL_SALT), the sign and the gate into shared memory
//     (16 bytes a pair, at most 1,024 pairs: 16 KB), then one barrier;
//     after that a slot costs two mix32, not five. Above 1,024 pairs, and
//     in the small instance (where the barrier cost more than it saved),
//     each thread computes the words of its own pair, again only when its
//     pair changes.
//   integer ops: % m and the three divisions stay plain 32-bit integer
//     operations. A multiply-based remainder (Lemire's fastmod, 64-bit
//     products) made VGG16's round slower on the H100, so the plain 32-bit
//     remainder stays.
//
// No atomics and no state shared between CTAs: the kernel is deterministic.
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
constexpr uint32_t kLeafSalt = 0xA511E9B3u;

constexpr int kThreads = 256;
constexpr int kLargeSlots = 4;          // slots a thread, large instance
constexpr int kCtasPerSm = 8;           // 2,048 threads an SM at 31 registers
constexpr int kMaxSegments = 64;
constexpr int kMaxTablePairs = 1024;                       // 16 KB shared
constexpr int kDescLongs = 6;           // idx, val, nb, k_mask, m, leaf_id

// header flags
constexpr int kMirror = 1;              // seed at (min(i,j), max(i,j))
constexpr int kGate = 2;                // val *= -(alive[i] * (1 - alive[j]))
constexpr int kGlobal = 4;              // idx += b * m
constexpr int kPairMajor = 8;           // [rows * peers, nb, k_mask] layout
constexpr int kAllFlags = kMirror | kGate | kGlobal | kPairMajor;

__host__ __device__ __forceinline__ uint32_t mix32(uint32_t x) {
    x ^= x >> 16;
    x *= 0x7FEB352Du;
    x ^= x >> 15;
    x *= 0x846CA68Bu;
    x ^= x >> 16;
    return x;
}

struct MaskSegment {                    // 40 bytes
    int32_t* idx;
    float* val;
    uint32_t nb;
    uint32_t k_mask;
    uint32_t m;
    uint32_t leaf_key;                  // mix32(leaf_id + LEAF_SALT)
    int fold;                           // 1: fold leaf_key into the seed
    int tile0;                          // this segment's first tile
};

struct MaskRound {
    const uint32_t* seeds;              // [rows, stride] uint32 bits
    const float* signs;                 // [rows, stride]
    const float* alive;                 // [max(rows, peers)] with kGate
    int stride;
    int rows;
    int peers;
    int flags;
    float p;
    float q;
    int n;                              // segments in seg[]
    MaskSegment seg[kMaxSegments];
};

struct PairWords {                      // 16 bytes a pair
    uint32_t bi;                        // mix32(s ^ IDX_SALT)
    uint32_t bv;                        // mix32(s ^ VAL_SALT)
    float sign;
    float gate;                         // -(alive[i] * (1 - alive[j]))
};

__device__ __forceinline__ PairWords pair_words(const MaskRound& r,
                                                const MaskSegment& sg,
                                                uint32_t i, uint32_t j) {
    const bool mirror = r.flags & kMirror;
    const uint32_t a = mirror ? min(i, j) : i;
    const uint32_t b = mirror ? max(i, j) : j;
    uint32_t s = __ldg(r.seeds + (long long)a * r.stride + b);
    if (sg.fold) s = mix32(s ^ sg.leaf_key);
    PairWords w;
    w.bi = mix32(s ^ kIdxSalt);
    w.bv = mix32(s ^ kValSalt);
    w.sign = __ldg(r.signs + (long long)i * r.stride + j);
    w.gate = 0.0f;
    if (r.flags & kGate) {
        w.gate = -__fmul_rn(__ldg(r.alive + i),
                            __fsub_rn(1.0f, __ldg(r.alive + j)));
    }
    return w;
}

template <int kSlots>
__global__ void __launch_bounds__(kThreads)
pair_mask_streams_kernel(const __grid_constant__ MaskRound r) {
    constexpr int kTileSlots = kThreads * kSlots;
    constexpr bool kTable = kSlots > 1;   // the large instance
    __shared__ PairWords table[kTable ? kMaxTablePairs : 1];
    const int blk = blockIdx.x;
    int lo = 0, hi = r.n - 1;           // the last segment with tile0 <= blk
    while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (r.seg[mid].tile0 <= blk) lo = mid; else hi = mid - 1;
    }
    const MaskSegment& sg = r.seg[lo];
    const uint32_t peers = (uint32_t)r.peers;
    const uint32_t n_pairs = (uint32_t)r.rows * peers;
    const bool shared_table = kTable && n_pairs <= (uint32_t)kMaxTablePairs;
    if (shared_table) {
        for (uint32_t q = threadIdx.x; q < n_pairs; q += kThreads)
            table[q] = pair_words(r, sg, q / peers, q % peers);
        __syncthreads();
    }
    const uint32_t k = sg.k_mask, nb = sg.nb;
    const uint32_t n_slots = n_pairs * nb * k;      // < 2^31 (host check)
    const uint32_t g0 = (uint32_t)(blk - sg.tile0) * kTileSlots
                        + kSlots * threadIdx.x;
    if (g0 >= n_slots) return;
    const bool pair_major = r.flags & kPairMajor;
    const bool global = r.flags & kGlobal;
    const bool gate = r.flags & kGate;
    uint32_t t = g0 % k, rest = g0 / k, i, j, b;
    if (pair_major) {                               // (i, j, b, t)
        b = rest % nb;
        rest /= nb;
        j = rest % peers;
        i = rest / peers;
    } else {                                        // (i, b, j, t)
        j = rest % peers;
        rest /= peers;
        b = rest % nb;
        i = rest / nb;
    }
    PairWords w =
        shared_table ? table[i * peers + j] : pair_words(r, sg, i, j);
    int32_t oi[kSlots];
    float ov[kSlots];
#pragma unroll
    for (int e = 0; e < kSlots; ++e) {
        oi[e] = 0;
        ov[e] = 0.0f;
        if (g0 + e >= n_slots) continue;
        const uint32_t c = b * k + t;
        uint32_t idx = mix32(w.bi + c) % sg.m;
        if (global) idx += b * sg.m;
        const float u = (float)(mix32(w.bv + c) >> 8) * (1.0f / 16777216.0f);
        float v = __fmul_rn(w.sign, __fadd_rn(r.p, __fmul_rn(r.q, u)));
        if (gate) v = __fmul_rn(w.gate, v);
        oi[e] = (int32_t)idx;
        ov[e] = v;
        if (e + 1 == kSlots || ++t < k) continue;
        t = 0;                                      // carry into the next
        bool new_pair = true;                       // (pair, block) place
        if (pair_major) {
            if (++b == nb) {
                b = 0;
                if (++j == peers) { j = 0; ++i; }
            } else {
                new_pair = false;
            }
        } else if (++j == peers) {
            j = 0;
            if (++b == nb) { b = 0; ++i; }
        }
        if (new_pair && g0 + e + 1 < n_slots)
            w = shared_table ? table[i * peers + j] : pair_words(r, sg, i, j);
    }
    int32_t* di = sg.idx + g0;
    float* dv = sg.val + g0;
    if constexpr (kSlots == 4) {
        const bool aligned =
            (((uintptr_t)sg.idx | (uintptr_t)sg.val) & 15) == 0;
        if (aligned && g0 + kSlots <= n_slots) {
            *reinterpret_cast<int4*>(di) =
                make_int4(oi[0], oi[1], oi[2], oi[3]);
            *reinterpret_cast<float4*>(dv) =
                make_float4(ov[0], ov[1], ov[2], ov[3]);
            return;
        }
    }
#pragma unroll
    for (int e = 0; e < kSlots; ++e) {
        if (g0 + e < n_slots) {
            di[e] = oi[e];
            dv[e] = ov[e];
        }
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

// One launch of the pair-mask kernel over up to 64 segments.
// seeds: uint32 [rows, stride] (int32 lanes holding the bits), signs: f32
// [rows, stride], alive: f32 [max(rows, peers)] of 0.0 / 1.0 when flags has
// the gate (2), else null; flags: 1 mirror (needs rows == peers), 2 gate,
// 4 global indices, 8 pair-major layout. desc: n_seg x (idx ptr, val ptr,
// nb, k_mask, m, leaf_id or -1 for no fold); segment i writes int32 / f32
// [rows, nb, peers * k_mask] (or [rows * peers, nb, k_mask] pair-major).
// Segments with no slots are left out. Returns a cudaError code.
extern "C" int pair_mask_round_launch(const void* seeds, const void* signs,
                                      const void* alive, int stride, int rows,
                                      int peers, int flags, float p, float q,
                                      const long long* desc, int n_seg,
                                      void* stream) {
    if (n_seg < 0 || n_seg > kMaxSegments || (n_seg > 0 && desc == nullptr) ||
        rows < 1 || peers < 1 || stride < peers || (flags & ~kAllFlags) ||
        ((flags & kMirror) && rows != peers) ||
        ((flags & kGate) != 0) != (alive != nullptr) ||
        seeds == nullptr || signs == nullptr)
        return (int)cudaErrorInvalidValue;
    MaskRound r;
    r.seeds = (const uint32_t*)seeds;
    r.signs = (const float*)signs;
    r.alive = (const float*)alive;
    r.stride = stride;
    r.rows = rows;
    r.peers = peers;
    r.flags = flags;
    r.p = p;
    r.q = q;
    r.n = 0;
    const long long pairs = (long long)rows * peers;
    long long total = 0;
    for (int s = 0; s < n_seg; ++s) {
        const long long* d = desc + kDescLongs * s;
        const long long nb = d[2], k = d[3], m = d[4], leaf = d[5];
        if (nb < 0 || k < 0 || m < 1 || m > 0xFFFFFFFFLL || leaf < -1 ||
            leaf > 0xFFFFFFFFLL)
            return (int)cudaErrorInvalidValue;
        const long long slots = pairs * nb * k;
        if (slots > 0 && (slots >= (1LL << 31) || d[0] == 0 || d[1] == 0))
            return (int)cudaErrorInvalidValue;
        total += slots;
    }
    if (total == 0) return 0;
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err != cudaSuccess) return (int)err;
    const bool large = total > (long long)kThreads * kCtasPerSm * sms;
    const long long tile_slots = (long long)kThreads * (large ? kLargeSlots
                                                              : 1);
    long long tiles = 0;
    for (int s = 0; s < n_seg; ++s) {
        const long long* d = desc + kDescLongs * s;
        const long long nb = d[2], k = d[3], m = d[4], leaf = d[5];
        const long long slots = pairs * nb * k;
        if (slots == 0) continue;
        MaskSegment& sg = r.seg[r.n++];
        sg.idx = (int32_t*)d[0];
        sg.val = (float*)d[1];
        sg.nb = (uint32_t)nb;
        sg.k_mask = (uint32_t)k;
        sg.m = (uint32_t)m;
        sg.fold = leaf >= 0;
        sg.leaf_key = sg.fold ? mix32((uint32_t)leaf + kLeafSalt) : 0u;
        sg.tile0 = (int)tiles;
        tiles += (slots + tile_slots - 1) / tile_slots;
        if (tiles >= (1LL << 31)) return (int)cudaErrorInvalidValue;
    }
    if (large)
        pair_mask_streams_kernel<kLargeSlots><<<(unsigned)tiles, kThreads, 0,
                                              (cudaStream_t)stream>>>(r);
    else
        pair_mask_streams_kernel<1><<<(unsigned)tiles, kThreads, 0,
                                    (cudaStream_t)stream>>>(r);
    return (int)cudaGetLastError();
}
