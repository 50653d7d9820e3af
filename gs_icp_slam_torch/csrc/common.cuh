// Shared pieces of the port's CUDA sources (built for sm_90a by
// gs_icp_slam_torch/cuda_build.py, one shared library per .cu file, bound
// with ctypes through plain C entry points).
//
// Every entry point launches on the stream it is given, allocates nothing
// (the Python wrapper passes outputs and scratch), and returns
// cudaGetLastError() so that a refused launch raises in the wrapper.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Additive validity bias of an invalid reference point and the clamp of
// every reported squared distance (the Pallas kernels' _BIG).
#define GS_BIG 3.4e38f

// Squared distance plus bias in the Pallas kernels' order,
// ((dx*dx + dy*dy) + dz*dz) + bias, with each operation rounded on its
// own: no fused multiply-add, so the plain PyTorch version (which rounds
// every elementwise op) gives the same bits and the same neighbour on a
// near tie.
__device__ __forceinline__ float gs_sqdist_bias(float qx, float qy, float qz,
                                                float4 r) {
  const float dx = __fsub_rn(qx, r.x);
  const float dy = __fsub_rn(qy, r.y);
  const float dz = __fsub_rn(qz, r.z);
  return __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                __fmul_rn(dz, dz)),
      r.w);
}

namespace gs {

constexpr unsigned kAllLanes = 0xffffffffu;

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fminf(v, __shfl_xor_sync(kAllLanes, v, off));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kAllLanes, v, off));
  return v;
}

}  // namespace gs

#define GS_EXPORT_ERROR_STRING                                   \
  extern "C" const char* gs_cuda_error_string(int err) {         \
    return cudaGetErrorString(static_cast<cudaError_t>(err));    \
  }
