// Row gather out = tab[rows] and its backward, the row scatter, for Hopper
// (sm_90a).
//
// Replaces the three Mosaic gather probes of tools/probe_pallas.py: `take`
// (jnp.take of VMEM table rows), `take_along` (the same in take_along_axis
// form) and `scalar_ds` (a loop of scalar dynamic slices with the indices in
// SMEM). All three compute one function, a row gather, which the trainer runs
// on every step to assemble a batch: rays (N_train, 6) and rgbs (N_train, 3)
// at the sampler's ids (`TriPlaneTrainer._next_block`,
// ngf_tpu/train/loop.py:1438-1451). The top-K renderers gather whole groups of
// samples with it (K4's `gather_groups`, ngf_tpu/ops/compaction.py:50, a
// take_along_axis at the top groups of ngf_tpu/render/volume.py:320-332, and
// the dense path's take_along_axis at the top samples, :480-483): a group of G
// samples of an (n, ng * G, C) payload is one row of the (n * ng, G * C)
// table, so the top groups are one gather with ids relative to each ray's
// segment of ng rows. Their gradient, the vjp of take_along_axis, goes back
// by the scatter.
//
// Layout. tab is (R, D) with rows tab_stride elements apart and elements
// contiguous, of 4-byte (float32) or 2-byte (bfloat16) elements: the kernels
// move bits, so either works. idx is (B,) int64 or int32. out is (B, D)
// contiguous. With per = 0 row b is idx[b]. With per > 0 the ids are relative
// to segments of seg rows, one segment per `per` ids, as take_along_axis reads
// them: an id in [-seg, seg) is wrapped into [0, seg) and row b is that plus
// (b / per) * seg; an id outside [-seg, seg) names no row. A row that is
// named by no id or lies outside [0, R) gives a row of NaN in the gather (the
// kernel reads nothing out of bounds, and the bad row shows in the loss) and
// is dropped by the scatter, as take_along_axis's fill mode and its vjp do.
//
// Lanes. Every kernel moves a row as words of 16, 8, 4 or 2 bytes: the widest
// that divides the row's bytes, the table's row stride in bytes and both base
// pointers (`lane_bytes`, from the pointers and stride it is given; nothing
// is assumed). L lanes share a row, the smallest power of two that covers the
// row in UNROLL words a lane, at most MAX_LANES, widened for a gather of few
// narrow rows until its grid spreads over the SMs (`grid_lane_shift`); each
// lane issues its UNROLL loads before its stores. The id of a row is read once a warp by its first
// lane and shuffled to the rest, and the segment arithmetic (one 64-bit
// division) is done once a row.
//
// gather_rows_kernel: the bound is memory, B * (2 * D * e + idx bytes) (each
// gathered row read once and written once, each id read once; e the element
// size): 453.2 MB, 0.1353 ms at 3.35 TB/s for the fused features of the
// staged recipe's masked step at rgb_cap 64 ((114688, 1728) float32, 32768
// rows: 432 16-byte words a row, 128 lanes), and far below one launch's few
// microseconds for the trainer's 4096 rows of 6 or 9 floats (24 or 36 bytes:
// 8- or 4-byte words, 4 lanes a row, 64 blocks), where the launch and the
// latency of one dependent load after the id's are what it costs.
//
// scatter_segments_kernel (per > 0, the group gather's backward): one block a
// segment. The block builds the segment's inverse map in shared memory (seg
// int32 slots, -1 where no id points, else the id's position), then writes
// every word of its seg rows once: the picked source row, or zeros. Nothing is
// written twice and no atomics are needed, because a segment's ids are
// distinct (the caller's contract; with repeated ids one of their rows is
// written). The bound is memory, R * D * e + B * (D * e + idx bytes) (the
// gradient written once, the source rows and ids read once): 1019.5 MB,
// 0.3043 ms for the fused features' (114688, 1728) gradient from 32768 rows.
// Segments longer than MAX_SEGMENT rows (a map over 48 KB of shared memory)
// take the second route, below.
//
// scatter_rows_kernel (per = 0, the batch gather's form, which no path
// differentiates, and segments longer than MAX_SEGMENT rows): the output is
// zero-filled by cudaMemsetAsync, then each source row is written at its row
// by the lanes above. The fill writes the picked rows a second time: R * D * e
// + B * (2 * D * e + idx bytes).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;
constexpr int MAX_LANES = 128;
constexpr long long MAX_SEGMENT = 12288;  // int32 slots in 48 KB of shared memory
constexpr long long MIN_BLOCKS = 64;      // about half of the H100's 132 SMs
constexpr unsigned FULL = 0xffffffffu;

// A word of copies of a 32-bit pattern: zeros, or a NaN in every element
// (float32 0x7fc00000, bfloat16 0x7fc07fc0).
template <typename W>
__device__ __forceinline__ W splat(uint32_t bits);
template <>
__device__ __forceinline__ uint4 splat<uint4>(uint32_t n) { return make_uint4(n, n, n, n); }
template <>
__device__ __forceinline__ uint2 splat<uint2>(uint32_t n) { return make_uint2(n, n); }
template <>
__device__ __forceinline__ uint32_t splat<uint32_t>(uint32_t n) { return n; }
template <>
__device__ __forceinline__ uint16_t splat<uint16_t>(uint32_t n) { return (uint16_t)n; }

// The absolute row of id b, or -1 where it names no row of [0, R).
template <typename I>
__device__ __forceinline__ long long row_of(const I* idx, long long b, long long R,
                                            long long per, long long seg) {
    long long r = (long long)idx[b];
    if (per > 0) {
        if (r < -seg || r >= seg) return -1;
        if (r < 0) r += seg;
        r += (b / per) * seg;
    }
    return (r >= 0 && r < R) ? r : -1;
}

// Lane `lane` of the L sharing a row copies the row's `words` words from src
// (or writes `fill` where src is null), UNROLL loads in flight before the
// stores.
template <typename W>
__device__ __forceinline__ void copy_row(const W* __restrict__ src, W* __restrict__ dst,
                                         int words, int lane, int L, W fill) {
    for (int w0 = lane; w0 < words; w0 += L * UNROLL) {
        W v[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const int w = w0 + u * L;
            v[u] = (src != nullptr && w < words) ? src[w] : fill;
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const int w = w0 + u * L;
            if (w < words) dst[w] = v[u];
        }
    }
}

// The rows of a block's groups of L lanes: group g of block x takes rows
// x * groups + g, then a grid stride. Every thread of a block runs the same
// iterations, so the shuffles see whole warps.
template <typename W, typename I>
__global__ void __launch_bounds__(THREADS) gather_rows_kernel(
    const W* __restrict__ tab, long long R, int words, long long stride, const I* __restrict__ idx,
    long long B, long long per, long long seg, int lane_shift, uint32_t nan32,
    W* __restrict__ out) {
    const int L = 1 << lane_shift;
    const int lane = threadIdx.x & (L - 1);
    const int width = L < 32 ? L : 32;
    const long long groups = THREADS >> lane_shift;
    const W nan = splat<W>(nan32);
    for (long long b0 = (long long)blockIdx.x * groups; b0 < B; b0 += (long long)gridDim.x * groups) {
        const long long b = b0 + (threadIdx.x >> lane_shift);
        long long r = -1;
        if ((threadIdx.x & (width - 1)) == 0 && b < B) r = row_of(idx, b, R, per, seg);
        r = __shfl_sync(FULL, r, 0, width);
        if (b < B) copy_row(r >= 0 ? tab + r * stride : nullptr, out + b * words, words, lane, L, nan);
    }
}

// One block a segment s: rows s * seg .. of out (at most R), from the ids
// idx[s * per ..] (at most B). inv is the segment's inverse map.
template <typename W, typename I>
__global__ void __launch_bounds__(THREADS) scatter_segments_kernel(
    const W* __restrict__ src, long long R, int words, const I* __restrict__ idx, long long B,
    long long per, long long seg, int lane_shift, W* __restrict__ out) {
    extern __shared__ int inv[];
    const long long s = blockIdx.x;
    const long long first = s * seg;
    const int rows = (int)(R - first < seg ? R - first : seg);
    for (int i = threadIdx.x; i < rows; i += THREADS) inv[i] = -1;
    __syncthreads();
    const long long b_end = (s + 1) * per < B ? (s + 1) * per : B;
    for (long long b = s * per + threadIdx.x; b < b_end; b += THREADS) {
        const long long r = row_of(idx, b, R, per, seg);
        if (r >= 0) inv[r - first] = (int)(b - s * per);
    }
    __syncthreads();
    const int L = 1 << lane_shift;
    const int lane = threadIdx.x & (L - 1);
    const W zero = splat<W>(0u);
    for (int i = threadIdx.x >> lane_shift; i < rows; i += THREADS >> lane_shift) {
        const int j = inv[i];
        copy_row(j >= 0 ? src + (s * per + j) * (long long)words : nullptr,
                 out + (first + i) * (long long)words, words, lane, L, zero);
    }
}

// Source row b written at its row; the output is zero-filled before.
template <typename W, typename I>
__global__ void __launch_bounds__(THREADS) scatter_rows_kernel(
    const W* __restrict__ src, long long R, int words, const I* __restrict__ idx, long long B,
    long long per, long long seg, int lane_shift, W* __restrict__ out) {
    const int L = 1 << lane_shift;
    const int lane = threadIdx.x & (L - 1);
    const int width = L < 32 ? L : 32;
    const long long groups = THREADS >> lane_shift;
    const W zero = splat<W>(0u);
    for (long long b0 = (long long)blockIdx.x * groups; b0 < B; b0 += (long long)gridDim.x * groups) {
        const long long b = b0 + (threadIdx.x >> lane_shift);
        long long r = -1;
        if ((threadIdx.x & (width - 1)) == 0 && b < B) r = row_of(idx, b, R, per, seg);
        r = __shfl_sync(FULL, r, 0, width);
        if (r >= 0) copy_row(src + b * words, out + r * words, words, lane, L, zero);
    }
}

// The widest word (16, 8, 4 or 2 bytes, at least one element) that divides
// the row's bytes, the row stride's bytes and both pointers.
int lane_bytes(const void* a, const void* b, long long stride_bytes, long long row_bytes,
               int elem_bytes) {
    const unsigned long long bits = (unsigned long long)(uintptr_t)a |
                                    (unsigned long long)(uintptr_t)b |
                                    (unsigned long long)stride_bytes |
                                    (unsigned long long)row_bytes;
    for (int v = 16; v > elem_bytes; v /= 2)
        if (bits % v == 0) return v;
    return elem_bytes;
}

// log2 of the lanes that cover a row of `words` words in UNROLL words a lane.
int lane_shift_for(long long words) {
    int shift = 0;
    while ((1LL << shift) * UNROLL < words && (1 << shift) < MAX_LANES) ++shift;
    return shift;
}

long long blocks_for(long long rows, int lane_shift) {
    const long long groups = THREADS >> lane_shift;
    return (rows + groups - 1) / groups;
}

// The lanes a row of a grid of `rows` rows takes: those above, and more, up
// to one word a lane, while the grid would hold fewer than MIN_BLOCKS blocks.
// On the H100 the trainer's 4096 rows of 6 floats ran longer in 16 blocks of
// one lane a row than in 64 blocks of 4, and its rows of 9 floats longer in
// 256 blocks of 16 than in 64 of 4 (their device time), so the grid is
// spread only until it reaches about half the SMs.
int grid_lane_shift(long long words, long long rows) {
    int shift = lane_shift_for(words);
    while ((1LL << shift) < words && (1 << shift) < MAX_LANES &&
           blocks_for(rows, shift) < MIN_BLOCKS)
        ++shift;
    return shift;
}

unsigned grid_for(long long rows, int lane_shift) {
    const long long blocks = blocks_for(rows, lane_shift);
    return (unsigned)(blocks < (1LL << 20) ? blocks : (1LL << 20));
}

// The kernels of one word type W and index type I.
template <typename W, typename I>
struct Rows {
    static int gather(const void* tab, long long R, long long words, long long stride,
                      const void* idx, long long B, long long per, long long seg,
                      uint32_t nan32, void* out, cudaStream_t s) {
        const int shift = grid_lane_shift(words, B);
        gather_rows_kernel<W, I><<<grid_for(B, shift), THREADS, 0, s>>>(
            (const W*)tab, R, (int)words, stride, (const I*)idx, B, per, seg, shift, nan32,
            (W*)out);
        return (int)cudaGetLastError();
    }
    static int scatter(const void* src, long long R, long long words, const void* idx,
                       long long B, long long per, long long seg, void* out, cudaStream_t s) {
        if (per > 0 && seg <= MAX_SEGMENT) {
            const int shift = lane_shift_for(words);
            const long long segments = (R + seg - 1) / seg;
            scatter_segments_kernel<W, I><<<(unsigned)segments, THREADS, seg * sizeof(int), s>>>(
                (const W*)src, R, (int)words, (const I*)idx, B, per, seg, shift, (W*)out);
            return (int)cudaGetLastError();
        }
        cudaError_t err = cudaMemsetAsync(out, 0, (size_t)(R * words * sizeof(W)), s);
        if (err != cudaSuccess || B == 0) return (int)err;
        const int shift = grid_lane_shift(words, B);
        scatter_rows_kernel<W, I><<<grid_for(B, shift), THREADS, 0, s>>>(
            (const W*)src, R, (int)words, (const I*)idx, B, per, seg, shift, (W*)out);
        return (int)cudaGetLastError();
    }
};

template <typename I>
int gather_words(int v, const void* tab, long long R, long long words, long long stride,
                 const void* idx, long long B, long long per, long long seg, uint32_t nan32,
                 void* out, cudaStream_t s) {
    switch (v) {
        case 16: return Rows<uint4, I>::gather(tab, R, words, stride, idx, B, per, seg, nan32, out, s);
        case 8: return Rows<uint2, I>::gather(tab, R, words, stride, idx, B, per, seg, nan32, out, s);
        case 4: return Rows<uint32_t, I>::gather(tab, R, words, stride, idx, B, per, seg, nan32, out, s);
        case 2: return Rows<uint16_t, I>::gather(tab, R, words, stride, idx, B, per, seg, nan32, out, s);
    }
    return (int)cudaErrorInvalidValue;
}

template <typename I>
int scatter_words(int v, const void* src, long long R, long long words, const void* idx,
                  long long B, long long per, long long seg, void* out, cudaStream_t s) {
    switch (v) {
        case 16: return Rows<uint4, I>::scatter(src, R, words, idx, B, per, seg, out, s);
        case 8: return Rows<uint2, I>::scatter(src, R, words, idx, B, per, seg, out, s);
        case 4: return Rows<uint32_t, I>::scatter(src, R, words, idx, B, per, seg, out, s);
        case 2: return Rows<uint16_t, I>::scatter(src, R, words, idx, B, per, seg, out, s);
    }
    return (int)cudaErrorInvalidValue;
}

bool bad_layout(long long R, int D, int elem_bytes, int idx_bytes, long long per, long long seg) {
    return (elem_bytes != 4 && elem_bytes != 2) || (idx_bytes != 8 && idx_bytes != 4) || R < 0 ||
           D <= 0 || per < 0 || (per > 0 && seg <= 0);
}

template <typename W, typename I>
const void* kernel_of(int which) {
    if (which == 0) return reinterpret_cast<const void*>(gather_rows_kernel<W, I>);
    if (which == 1) return reinterpret_cast<const void*>(scatter_segments_kernel<W, I>);
    return reinterpret_cast<const void*>(scatter_rows_kernel<W, I>);
}

}  // namespace

extern "C" {

// elem_bytes: 4 or 2. idx_bytes: 8 = int64, 4 = int32. per, seg: the segments
// above (per = 0: none; per > 0 needs seg > 0). Launches on `stream` and
// returns the cudaError_t of the launch (0 on success). B * D must be > 0.
int ngf_gather_rows(const void* tab, long long R, int D, long long tab_stride, int elem_bytes,
                    const void* idx, int idx_bytes, long long B, long long per, long long seg,
                    void* out, void* stream) {
    if (bad_layout(R, D, elem_bytes, idx_bytes, per, seg)) return (int)cudaErrorInvalidValue;
    const int v = lane_bytes(tab, out, tab_stride * elem_bytes, (long long)D * elem_bytes,
                             elem_bytes);
    const long long words = (long long)D * elem_bytes / v;
    const long long stride = tab_stride * elem_bytes / v;
    const uint32_t nan32 = elem_bytes == 4 ? 0x7fc00000u : 0x7fc07fc0u;
    cudaStream_t s = (cudaStream_t)stream;
    if (idx_bytes == 8)
        return gather_words<long long>(v, tab, R, words, stride, idx, B, per, seg, nan32, out, s);
    return gather_words<int>(v, tab, R, words, stride, idx, B, per, seg, nan32, out, s);
}

// out (R, D) contiguous: src (B, D) contiguous at the rows of idx, which must
// be distinct, zeros elsewhere (ids as ngf_gather_rows reads them; a row that
// no id names is dropped). R * D > 0; B may be 0. One kernel a segment for
// per > 0 and seg <= MAX_SEGMENT, else a fill and the row writes.
int ngf_scatter_rows(const void* src, long long R, int D, int elem_bytes, const void* idx,
                     int idx_bytes, long long B, long long per, long long seg, void* out,
                     void* stream) {
    if (bad_layout(R, D, elem_bytes, idx_bytes, per, seg)) return (int)cudaErrorInvalidValue;
    const long long row_bytes = (long long)D * elem_bytes;
    const int v = lane_bytes(src, out, row_bytes, row_bytes, elem_bytes);
    const long long words = row_bytes / v;
    cudaStream_t s = (cudaStream_t)stream;
    if (idx_bytes == 8)
        return scatter_words<long long>(v, src, R, words, idx, B, per, seg, out, s);
    return scatter_words<int>(v, src, R, words, idx, B, per, seg, out, s);
}

// The word ngf_gather_rows (a = tab, b = out) or ngf_scatter_rows (a = src,
// b = out) moves for these pointers, row stride and row, in bytes; and the
// route ngf_scatter_rows takes: 1 one kernel a segment, 0 the fill and the
// row writes.
int ngf_rows_lane_bytes(const void* a, const void* b, long long stride_bytes,
                        long long row_bytes, int elem_bytes) {
    return lane_bytes(a, b, stride_bytes, row_bytes, elem_bytes);
}

int ngf_scatter_rows_route(long long per, long long seg) {
    return per > 0 && seg <= MAX_SEGMENT ? 1 : 0;
}

// The footprint of kernel `which` (0 gather_rows_kernel, 1
// scatter_segments_kernel, 2 scatter_rows_kernel) on words of `word_bytes`
// (16, 8, 4, 2) and ids of `idx_bytes` (8, 4): out[0] the blocks of 256
// threads an SM holds at once, out[1] its registers a thread, out[2] its
// local memory a thread in bytes (spills; 0 without). Returns the cudaError_t
// of the queries.
int ngf_rows_footprint(int which, int word_bytes, int idx_bytes, int* out) {
    const void* fn = nullptr;
    const bool i64 = idx_bytes == 8;
    switch (word_bytes) {
        case 16: fn = i64 ? kernel_of<uint4, long long>(which) : kernel_of<uint4, int>(which); break;
        case 8: fn = i64 ? kernel_of<uint2, long long>(which) : kernel_of<uint2, int>(which); break;
        case 4: fn = i64 ? kernel_of<uint32_t, long long>(which) : kernel_of<uint32_t, int>(which); break;
        case 2: fn = i64 ? kernel_of<uint16_t, long long>(which) : kernel_of<uint16_t, int>(which); break;
        default: return (int)cudaErrorInvalidValue;
    }
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, fn);
    if (err != cudaSuccess) return (int)err;
    out[1] = attr.numRegs;
    out[2] = (int)attr.localSizeBytes;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], fn, THREADS,
                                                              which == 1 ? 4096 : 0);
}

const char* ngf_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
