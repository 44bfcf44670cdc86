// Group compaction (K4) for Hopper (sm_90a): per ray, the first `capg`
// groups of G consecutive samples that hold a valid sample, in marching
// order, with their depths and validity.
//
// Replaces a hand-written XLA op of the JAX package's grouped renderer
// (ngf_tpu/render/volume.py:252-261): `group_compact_indices` (an exclusive
// cumsum and a one-hot contraction over the group axis) and `gather_groups`
// of the stacked (z_vals, valid) payload times `got`
// (ngf_tpu/ops/compaction.py:26-66). Outputs, exactly as those give them:
//   idx   (n, capg) int32   the group of each slot, 0 in a pad slot;
//   got   (n, capg) bool    the slot holds a group;
//   z_c   (n, capg*G) f32   the slot's group's depths (group 0's in a pad
//                           slot, as JAX's idx = 0 gathers them);
//   vmask (n, capg*G) f32   valid as 0/1 in a held slot, 0 in a pad slot.
// A ray with more valid groups than capg keeps its first capg.
//
// Design: one warp per ray. The warp walks the ray's ng groups 32 at a time:
// each lane ORs its group's G validity bytes, a ballot and a popcount of the
// lower lanes give each valid group its slot, and the lane writes its
// group's G depths and validities there; the warp stops once capg slots are
// full. Then the warp fills the pad slots. No sort, no scan in memory.
//
// Bound on an H100 SXM: memory. The validity bytes of the groups walked
// (at most n * s_pad), the depths of the held groups, and the outputs
// (n * capg * (4 + 1 + 8 * G)) are each moved once: ~30 MB, ~9 us, for the
// train step's n = 4096, s_pad = 888, capg = 64, G = 8. Forward only: z_vals
// depends on no parameter.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;

__global__ void __launch_bounds__(THREADS) group_compact_kernel(
    const float* __restrict__ z, long long z_stride, const uint8_t* __restrict__ valid,
    long long v_stride, int n, int ng, int G, int capg, int* __restrict__ idx,
    uint8_t* __restrict__ got, float* __restrict__ z_c, float* __restrict__ vmask) {
    const int lane = threadIdx.x & 31;
    const int ray = blockIdx.x * WARPS + (threadIdx.x >> 5);
    if (ray >= n) return;  // whole warps leave together
    const float* zr = z + (long long)ray * z_stride;
    const uint8_t* vr = valid + (long long)ray * v_stride;
    int* ir = idx + (long long)ray * capg;
    uint8_t* gr = got + (long long)ray * capg;
    float* zo = z_c + (long long)ray * capg * G;
    float* vo = vmask + (long long)ray * capg * G;
    const unsigned lower = (1u << lane) - 1u;

    int held = 0;
    for (int g0 = 0; g0 < ng && held < capg; g0 += 32) {
        const int g = g0 + lane;
        bool any = false;
        if (g < ng) {
            for (int j = 0; j < G; ++j) any |= vr[g * G + j] != 0;
        }
        const unsigned ballot = __ballot_sync(0xffffffffu, any);
        const int slot = held + __popc(ballot & lower);
        if (any && slot < capg) {
            ir[slot] = g;
            gr[slot] = 1;
            for (int j = 0; j < G; ++j) {
                zo[slot * G + j] = zr[g * G + j];
                vo[slot * G + j] = vr[g * G + j] ? 1.0f : 0.0f;
            }
        }
        held += __popc(ballot);
    }
    for (int slot = min(held, capg) + lane; slot < capg; slot += 32) {
        ir[slot] = 0;
        gr[slot] = 0;
        for (int j = 0; j < G; ++j) {
            zo[slot * G + j] = zr[j];
            vo[slot * G + j] = 0.0f;
        }
    }
}

}  // namespace

extern "C" {

// z: (n, s_pad) float32 with rows z_stride elements apart; valid: (n, s_pad)
// bytes (bool) with rows v_stride apart; s_pad = ng * G. Outputs contiguous
// as described above. Launches on `stream` and returns the cudaError_t of the
// launch (0 on success). n, ng, G and capg must be > 0.
int ngf_group_compact(const float* z, long long z_stride, const uint8_t* valid,
                      long long v_stride, int n, int ng, int G, int capg, int* idx, uint8_t* got,
                      float* z_c, float* vmask, void* stream) {
    const int blocks = (n + WARPS - 1) / WARPS;
    group_compact_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        z, z_stride, valid, v_stride, n, ng, G, capg, idx, got, z_c, vmask);
    return (int)cudaGetLastError();
}

const char* ngf_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
