// Row gather out = tab[idx], for Hopper (sm_90a).
//
// Replaces the three Mosaic gather probes of tools/probe_pallas.py: `take`
// (jnp.take of VMEM table rows), `take_along` (the same in take_along_axis
// form) and `scalar_ds` (a loop of scalar dynamic slices with the indices in
// SMEM). All three compute one function, a row gather, which the trainer runs
// on every step to assemble a batch: rays (N_train, 6) and rgbs (N_train, 3)
// at the sampler's ids (`TriPlaneTrainer._next_block`,
// ngf_tpu/train/loop.py:1438-1451).
//
// Layout. tab is (R, D) float32 with rows tab_stride elements apart and
// elements contiguous; idx is (B,) int64 or int32; out is (B, D) contiguous.
// An index outside [0, R) gives a row of NaN: the kernel reads nothing out of
// bounds, and the bad row shows in the loss.
//
// Design. One thread per output element, in order: neighbouring threads
// write neighbouring words of out, and the D threads of one row read one
// index (served by L1) and D consecutive words of one table row. Rows of 3 or
// 6 floats are narrower than a 32-byte sector, so each row read costs one or
// two sectors whatever the layout; a grid-stride loop covers any B.
//
// Bound on an H100 SXM: memory, B * (2 * D * 4 + 8) bytes (each gathered row
// read once and written once, each int64 index read once): 0.23 MB and about
// 0.07 us for the 4096-ray batch of 6-float rays, far below the few
// microseconds of one launch, so the launch is what it costs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

template <typename I>
__global__ void __launch_bounds__(THREADS) gather_rows_kernel(
    const float* __restrict__ tab, long long R, int D, long long tab_stride,
    const I* __restrict__ idx, long long B, float* __restrict__ out) {
    const long long total = B * D;
    for (long long e = (long long)blockIdx.x * THREADS + threadIdx.x; e < total;
         e += (long long)gridDim.x * THREADS) {
        const long long b = e / D;
        const int d = (int)(e - b * D);
        const long long r = (long long)idx[b];
        out[e] = (r >= 0 && r < R) ? tab[r * tab_stride + d] : __int_as_float(0x7fc00000);
    }
}

}  // namespace

extern "C" {

// idx_bytes: 8 = int64, 4 = int32. Launches on `stream` and returns the
// cudaError_t of the launch (0 on success). B * D must be > 0.
int ngf_gather_rows(const float* tab, long long R, int D, long long tab_stride,
                    const void* idx, int idx_bytes, long long B, float* out, void* stream) {
    const long long total = B * D;
    long long blocks = (total + THREADS - 1) / THREADS;
    if (blocks > 65535LL * 32) blocks = 65535LL * 32;
    cudaStream_t s = (cudaStream_t)stream;
    if (idx_bytes == 8) {
        gather_rows_kernel<long long><<<(unsigned)blocks, THREADS, 0, s>>>(
            tab, R, D, tab_stride, (const long long*)idx, B, out);
    } else if (idx_bytes == 4) {
        gather_rows_kernel<int><<<(unsigned)blocks, THREADS, 0, s>>>(
            tab, R, D, tab_stride, (const int*)idx, B, out);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

const char* ngf_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
