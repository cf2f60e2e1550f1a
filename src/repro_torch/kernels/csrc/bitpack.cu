// Fixed-width bit packing of the stream wire for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels src/repro/kernels/pack.py::bitpack_rows
// and ::bitunpack_rows (bodies _pack_kernel/_unpack_kernel, which run
// kernels/ref.py::_pack_chunk/_unpack_chunk). Field s of a row lies at bits
// [s*w, s*w + w) of the row's word array, least significant bit first; a
// 32-field chunk at width w fills exactly w words, so chunks never share a
// word. The TPU kernel grids over (row tile, chunk group) on that property;
// this one does too, at the card's own scale.
//
// What bounds it. Bytes: a call reads each field or word once and writes
// each word or field once (4*R*k + 4*R*W bytes), under a microsecond at
// 3.35 TB/s even at VGG16's 512x512x3x3 leaf (5 rows, k = 60,199: 0.61 us
// for one stream). At the codec path's sizes the launch itself costs more
// than the bytes, so the design first cuts launches, then keeps every
// thread's work short:
//
//   segments: one launch packs (or unpacks) up to 8 independent [R, k]
//     arrays, each at its own width -- a leaf's index stream and value
//     stream go in one pack and one unpack. The host's descriptors (in, out,
//     R, k, w, W) and each segment's first tile travel in a __grid_constant__
//     kernel parameter: no host-to-device copy, no extra launch. A CTA finds
//     its segment by a short scan of the first tiles.
//   tile: a CTA owns 32 chunks of one row of one segment, 1,024 fields and
//     32*w words, so tiles are independent and no CTA reads another's data.
//     Pack loads its fields into shared memory with 16-byte loads (4 KB),
//     masked to w bits (a field with stray high bits cannot reach its
//     neighbours, as in the plain version), then thread t builds words t,
//     t + 256, ... of the tile from shared memory and stores them, so
//     neighbouring threads store neighbouring words. Below 8 bits a word
//     gathers more than 4 fields, a serial loop of up to 32 for one thread
//     (at w = 1 only 32 threads of the CTA would work), so there a warp
//     builds a chunk's w words together: each lane places its field, and
//     each word is one warp OR-reduction (__reduce_or_sync). Plain 16-byte
//     loads reach the same bytes as a 1-D TMA copy at 4 KB a tile, with no
//     barrier to arm, so the threads load the tile themselves. Unpack does
//     not stage: thread t extracts fields 4t .. 4t+3 of the tile, reading
//     the one or two words each needs straight from the tile's 32*w words
//     (neighbouring threads share their lines in L1), and stores the four
//     as one 16-byte store. Staging the words in shared memory first, as
//     pack must, cost 10-18% at the codec path's shapes on the H100 (the
//     barrier waits for the CTA's slowest load; PERF.md).
//   int32: the wrappers hand the kernels int32 lanes holding the uint32 bits
//     and take int32 lanes back, so no cast runs around a launch.
//
// Inside a tile every offset is 32-bit: a bit offset is below
// 32 * 32 * w <= 32,768, so no thread divides in 64 bits; only the tile's
// base address is a 64-bit product. On the ragged last tile of a row, pack
// zero-fills the fields at or beyond k in shared memory (the padding bits of
// the last word are zero) and stores only the words below W; unpack reads
// only the words its fields below k need and stores only those fields.
//
// Shared memory of the pack tile is padded by one word every 32 fields:
// thread j starts at field 32j/w, so at w = 1 the 32 threads of a warp would
// read one bank; with the pad they read 32 banks, and the 16-byte loads'
// scattered stores to shared memory are conflict-free as well.
//
// Traps kept from the first port: a shift by 32 is undefined in C++ (every
// shift here is in 0..31: the straddle branch runs only with 0 < off, and a
// pack word ORs a field in only while its start is below 32); for w = 32 the
// mask is 0xFFFFFFFF, never (1u << 32) - 1. No atomics, no state shared
// between CTAs: both kernels are deterministic.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileFields = 1024;           // 32 chunks of 32 fields
constexpr int kMaxSegments = 8;
constexpr int kDescLongs = 6;               // in, out, R, k, w, W
constexpr int kGatherMinWidth = 8;          // pack: a thread a word from here

struct Segment {
    const uint32_t* in;
    uint32_t* out;
    long long k;                            // fields per row
    long long W;                            // words per row
    int w;                                  // field width, 1..32
    int tiles_per_row;                      // ceil(k / 1024)
    int tile0;                              // this segment's first tile
};

struct Segments {
    Segment seg[kMaxSegments];
    int n;
};

__device__ __forceinline__ uint32_t field_mask(int w) {
    return w >= 32 ? 0xFFFFFFFFu : ((1u << w) - 1u);
}

// shared-memory slot of field s in the pack tile: one spare word every 32
__device__ __forceinline__ int padded(int s) { return s + (s >> 5); }

// the segment of tile b, and b's row and tile within that segment
struct Place {
    const Segment* sg;
    int row;
    int tile;
};

__device__ __forceinline__ Place place_of(const Segments& p, int b) {
    int s = 0;
    while (s + 1 < p.n && b >= p.seg[s + 1].tile0) ++s;
    const Segment* sg = &p.seg[s];
    const int local = b - sg->tile0;
    const int row = local / sg->tiles_per_row;
    return {sg, row, local - row * sg->tiles_per_row};
}

__global__ void __launch_bounds__(kThreads)
bitpack_rows_tiles_kernel(const __grid_constant__ Segments p) {
    __shared__ uint32_t fields[kTileFields + kTileFields / 32];
    const Place pl = place_of(p, blockIdx.x);
    const Segment& sg = *pl.sg;
    const int w = sg.w;
    const uint32_t mask = field_mask(w);
    const long long f0 = (long long)pl.tile * kTileFields;
    const long long left = sg.k - f0;
    const int nf = left < kTileFields ? (int)left : kTileFields;
    const uint32_t* src = sg.in + (long long)pl.row * sg.k + f0;
    const int tid = threadIdx.x;
    if (nf == kTileFields && ((uintptr_t)src & 15) == 0) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(src) + tid);
        const int s = 4 * tid;
        fields[padded(s)] = v.x & mask;
        fields[padded(s + 1)] = v.y & mask;
        fields[padded(s + 2)] = v.z & mask;
        fields[padded(s + 3)] = v.w & mask;
    } else {
        for (int s = tid; s < kTileFields; s += kThreads) {
            fields[padded(s)] = s < nf ? (__ldg(src + s) & mask) : 0u;
        }
    }
    __syncthreads();
    // words of this tile: [tile*32w, tile*32w + nw); nw = ceil(nf*w/32)
    const long long j0 = (long long)pl.tile * 32 * w;
    const long long wleft = sg.W - j0;
    const int nw = wleft < 32LL * w ? (int)wleft : 32 * w;
    uint32_t* dst = sg.out + (long long)pl.row * sg.W + j0;
    if (w < kGatherMinWidth) {
        // narrow fields: a word gathers 32/w fields, too long a loop for one
        // thread, so a warp builds a chunk's w words together. Lane i holds
        // field i of the chunk, at bit i*w: its low part goes to word
        // (i*w)/32, a straddling high part to the next; each word is the OR
        // of the lanes' parts (REDUX), kept by lane jj.
        const int lane = tid & 31;
        const int b = lane * w;                 // < 32 * 8
        const int jl = b >> 5;
        const int off = b & 31;
        const int nchunks = (nf + 31) >> 5;
        for (int c = tid >> 5; c < nchunks; c += kThreads / 32) {
            const uint32_t f = fields[padded(32 * c + lane)];
            const uint32_t lo = f << off;
            // f < 2^w: the high part is 0 unless the field straddles
            const uint32_t hi = off ? (f >> (32 - off)) : 0u;
            uint32_t mine = 0u;
            for (int jj = 0; jj < w; ++jj) {
                const uint32_t part = (jl == jj ? lo : 0u)
                                      | (jl + 1 == jj ? hi : 0u);
                const uint32_t word = __reduce_or_sync(0xFFFFFFFFu, part);
                if (lane == jj) mine = word;
            }
            if (lane < w && c * w + lane < nw) dst[c * w + lane] = mine;
        }
        return;
    }
    for (int j = tid; j < nw; j += kThreads) {
        const int b = 32 * j;                   // word j's first bit, < 2^15
        int s = b / w;                          // the field holding bit b
        int pos = s * w - b;                    // its start: in (-w, 0]
        uint32_t word = fields[padded(s)] >> (-pos);
        pos += w;
        while (pos < 32) {                      // the next field starts in j
            ++s;                                // (s < 1024: see the note)
            word |= fields[padded(s)] << pos;
            pos += w;
        }
        dst[j] = word;
    }
}

__global__ void __launch_bounds__(kThreads)
bitunpack_rows_tiles_kernel(const __grid_constant__ Segments p) {
    const Place pl = place_of(p, blockIdx.x);
    const Segment& sg = *pl.sg;
    const int w = sg.w;
    const long long j0 = (long long)pl.tile * 32 * w;
    const uint32_t* src = sg.in + (long long)pl.row * sg.W + j0;
    const uint32_t mask = field_mask(w);
    const long long f0 = (long long)pl.tile * kTileFields;
    const long long left = sg.k - f0;
    const int nf = left < kTileFields ? (int)left : kTileFields;
    const int tid = threadIdx.x;
    uint32_t v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
        const int s = 4 * tid + e;
        uint32_t x = 0u;
        if (s < nf) {                           // reads only the tile's words
            const int b = s * w;                // < 2^15
            const int j = b >> 5;
            const int off = b & 31;
            x = __ldg(src + j) >> off;
            if (off + w > 32) {                 // straddles: off > 0
                x |= __ldg(src + j + 1) << (32 - off);
            }
        }
        v[e] = x & mask;
    }
    uint32_t* dst = sg.out + (long long)pl.row * sg.k + f0;
    if (nf == kTileFields && ((uintptr_t)dst & 15) == 0) {
        reinterpret_cast<uint4*>(dst)[tid] = make_uint4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            if (4 * tid + e < nf) dst[4 * tid + e] = v[e];
        }
    }
}

// Fill the parameter block from n_seg host descriptors (in, out, R, k, w,
// W); segments with no work are left out. Returns a cudaError code.
int fill_segments(const long long* desc, int n_seg, bool pack, Segments* p,
                  int* tiles) {
    if (n_seg < 0 || n_seg > kMaxSegments || (n_seg > 0 && desc == nullptr))
        return (int)cudaErrorInvalidValue;
    long long total = 0;
    p->n = 0;
    for (int i = 0; i < n_seg; ++i) {
        const long long* d = desc + kDescLongs * i;
        const long long R = d[2], k = d[3], w = d[4], W = d[5];
        if (w < 1 || w > 32 || R < 0 || k < 0 || W < 0)
            return (int)cudaErrorInvalidValue;
        const long long need = (k * w + 31) / 32;
        if (pack ? W != need : W < need) return (int)cudaErrorInvalidValue;
        if (R == 0 || k == 0) continue;
        if (d[0] == 0 || d[1] == 0) return (int)cudaErrorInvalidValue;
        const long long per_row = (k + kTileFields - 1) / kTileFields;
        Segment& s = p->seg[p->n++];
        s.in = (const uint32_t*)d[0];
        s.out = (uint32_t*)d[1];
        s.k = k;
        s.W = W;
        s.w = (int)w;
        s.tiles_per_row = (int)per_row;         // k < 2^31 * 1024 below
        s.tile0 = (int)total;
        total += R * per_row;
        if (per_row > INT_MAX || total > INT_MAX)
            return (int)cudaErrorInvalidValue;
    }
    *tiles = (int)total;
    return 0;
}

}  // namespace

// desc: n_seg x (fields ptr, words ptr, R, k, w, W), n_seg <= 8. Segment i:
// uint32[R, k] fields (low w bits taken) -> uint32[R, W] words,
// W = ceil(k * w / 32). One launch for all segments.
extern "C" int bitpack_segments_launch(const long long* desc, int n_seg,
                                       void* stream) {
    Segments p;
    int tiles = 0;
    const int rc = fill_segments(desc, n_seg, true, &p, &tiles);
    if (rc != 0 || tiles == 0) return rc;
    bitpack_rows_tiles_kernel<<<tiles, kThreads, 0,
                                (cudaStream_t)stream>>>(p);
    return (int)cudaGetLastError();
}

// desc: n_seg x (words ptr, fields ptr, R, k, w, W), n_seg <= 8. Segment i:
// uint32[R, W] words, 32 * W >= k * w -> uint32[R, k] fields, each < 2^w.
extern "C" int bitunpack_segments_launch(const long long* desc, int n_seg,
                                         void* stream) {
    Segments p;
    int tiles = 0;
    const int rc = fill_segments(desc, n_seg, false, &p, &tiles);
    if (rc != 0 || tiles == 0) return rc;
    bitunpack_rows_tiles_kernel<<<tiles, kThreads, 0,
                                  (cudaStream_t)stream>>>(p);
    return (int)cudaGetLastError();
}

// The one-segment case: u: uint32[R, k] fields -> out: uint32[R, W].
extern "C" int bitpack_rows_launch(const void* u, long long R, long long k,
                                   int w, void* out, long long W,
                                   void* stream) {
    const long long desc[kDescLongs] = {(long long)(uintptr_t)u,
                                        (long long)(uintptr_t)out, R, k, w, W};
    return bitpack_segments_launch(desc, 1, stream);
}

// The one-segment case: words: uint32[R, W] -> out: uint32[R, k] fields.
extern "C" int bitunpack_rows_launch(const void* words, long long R,
                                     long long W, long long k, int w,
                                     void* out, void* stream) {
    const long long desc[kDescLongs] = {(long long)(uintptr_t)words,
                                        (long long)(uintptr_t)out, R, k, w, W};
    return bitunpack_segments_launch(desc, 1, stream);
}
