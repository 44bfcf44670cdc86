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
// samples with it (K4's `gather_groups`, ngf_tpu/ops/compaction.py:50, at the
// top groups of ngf_tpu/render/volume.py:320-332, and the dense path's
// take_along_axis at the top samples, :480-483): a group of G samples of an
// (n, ng * G, C) payload is one row of the (n * ng, G * C) table, so the top
// groups are one gather at rows ray * ng + id. Their gradient goes back by the
// scatter, which writes rows to distinct places and so needs no atomics.
//
// Layout. tab is (R, D) with rows tab_stride elements apart and elements
// contiguous, of 4-byte (float32) or 2-byte (bfloat16) elements: the kernels
// move bits, so either works. idx is (B,) int64 or int32; with per > 0 the ids
// are relative to segments of seg rows, one segment per `per` ids: row b is
// idx[b] + (b / per) * seg (per = 0: row b is idx[b]). out is (B, D)
// contiguous. A row outside [0, R) gives a row of NaN in the gather (the
// kernel reads nothing out of bounds, and the bad row shows in the loss) and
// is dropped by the scatter.
//
// Design. One thread per output element, in order: neighbouring threads
// write neighbouring elements of out, and the D threads of one row read one
// index (served by L1) and D consecutive elements of one table row. Rows of 3
// or 6 floats are narrower than a 32-byte sector, so each row read costs one
// or two sectors whatever the layout; a grid-stride loop covers any B. The
// scatter zero-fills its (R, D) output with cudaMemsetAsync, then writes the
// B rows by the same loop.
//
// Bound on an H100 SXM: memory, B * (2 * D * e + 8) bytes (each gathered row
// read once and written once, each int64 index read once; e the element
// size), and for the scatter R * D * e more for the fill: 0.23 MB and about
// 0.07 us for the 4096-ray batch of 6-float rays, far below the few
// microseconds of one launch, so the launch is what it costs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

template <typename T>
__device__ __forceinline__ T nan_bits();
template <>
__device__ __forceinline__ uint32_t nan_bits<uint32_t>() { return 0x7fc00000u; }
template <>
__device__ __forceinline__ uint16_t nan_bits<uint16_t>() { return (uint16_t)0x7fc0u; }

template <typename I>
__device__ __forceinline__ long long row_of(const I* idx, long long b, long long per,
                                            long long seg) {
    const long long r = (long long)idx[b];
    return per > 0 ? r + (b / per) * seg : r;
}

template <typename T, typename I>
__global__ void __launch_bounds__(THREADS) gather_rows_kernel(
    const T* __restrict__ tab, long long R, int D, long long tab_stride,
    const I* __restrict__ idx, long long B, long long per, long long seg, T* __restrict__ out) {
    const long long total = B * D;
    for (long long e = (long long)blockIdx.x * THREADS + threadIdx.x; e < total;
         e += (long long)gridDim.x * THREADS) {
        const long long b = e / D;
        const int d = (int)(e - b * D);
        const long long r = row_of(idx, b, per, seg);
        out[e] = (r >= 0 && r < R) ? tab[r * tab_stride + d] : nan_bits<T>();
    }
}

template <typename T, typename I>
__global__ void __launch_bounds__(THREADS) scatter_rows_kernel(
    const T* __restrict__ src, long long R, int D, const I* __restrict__ idx, long long B,
    long long per, long long seg, T* __restrict__ out) {
    const long long total = B * D;
    for (long long e = (long long)blockIdx.x * THREADS + threadIdx.x; e < total;
         e += (long long)gridDim.x * THREADS) {
        const long long b = e / D;
        const int d = (int)(e - b * D);
        const long long r = row_of(idx, b, per, seg);
        if (r >= 0 && r < R) out[r * D + d] = src[e];
    }
}

unsigned blocks_for(long long total) {
    long long blocks = (total + THREADS - 1) / THREADS;
    if (blocks > 65535LL * 32) blocks = 65535LL * 32;
    return (unsigned)blocks;
}

template <typename T>
int gather_typed(const void* tab, long long R, int D, long long tab_stride, const void* idx,
                 int idx_bytes, long long B, long long per, long long seg, void* out,
                 cudaStream_t s) {
    const unsigned blocks = blocks_for(B * D);
    if (idx_bytes == 8) {
        gather_rows_kernel<T, long long><<<blocks, THREADS, 0, s>>>(
            (const T*)tab, R, D, tab_stride, (const long long*)idx, B, per, seg, (T*)out);
    } else if (idx_bytes == 4) {
        gather_rows_kernel<T, int><<<blocks, THREADS, 0, s>>>(
            (const T*)tab, R, D, tab_stride, (const int*)idx, B, per, seg, (T*)out);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

template <typename T>
int scatter_typed(const void* src, long long R, int D, const void* idx, int idx_bytes,
                  long long B, long long per, long long seg, void* out, cudaStream_t s) {
    const unsigned blocks = blocks_for(B * D);
    if (idx_bytes == 8) {
        scatter_rows_kernel<T, long long><<<blocks, THREADS, 0, s>>>(
            (const T*)src, R, D, (const long long*)idx, B, per, seg, (T*)out);
    } else if (idx_bytes == 4) {
        scatter_rows_kernel<T, int><<<blocks, THREADS, 0, s>>>(
            (const T*)src, R, D, (const int*)idx, B, per, seg, (T*)out);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// elem_bytes: 4 or 2. idx_bytes: 8 = int64, 4 = int32. per, seg: the segments
// above (per = 0: none). Launches on `stream` and returns the cudaError_t of
// the launch (0 on success). B * D must be > 0.
int ngf_gather_rows(const void* tab, long long R, int D, long long tab_stride, int elem_bytes,
                    const void* idx, int idx_bytes, long long B, long long per, long long seg,
                    void* out, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (elem_bytes == 4)
        return gather_typed<uint32_t>(tab, R, D, tab_stride, idx, idx_bytes, B, per, seg, out, s);
    if (elem_bytes == 2)
        return gather_typed<uint16_t>(tab, R, D, tab_stride, idx, idx_bytes, B, per, seg, out, s);
    return (int)cudaErrorInvalidValue;
}

// out (R, D) contiguous: zeros, then src (B, D) contiguous at the rows of
// idx, which must be distinct. R * D > 0; B may be 0.
int ngf_scatter_rows(const void* src, long long R, int D, int elem_bytes, const void* idx,
                     int idx_bytes, long long B, long long per, long long seg, void* out,
                     void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (elem_bytes != 4 && elem_bytes != 2) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaMemsetAsync(out, 0, (size_t)R * D * elem_bytes, s);
    if (err != cudaSuccess) return (int)err;
    if (B == 0) return 0;
    if (elem_bytes == 4)
        return scatter_typed<uint32_t>(src, R, D, idx, idx_bytes, B, per, seg, out, s);
    return scatter_typed<uint16_t>(src, R, D, idx, idx_bytes, B, per, seg, out, s);
}

const char* ngf_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
