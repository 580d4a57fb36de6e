// FPGA preprocessing pooling (paper Fig. 7): max - min over each
// non-overlapping window of a [rows, t] float32 signal.
//
// Replaces the TPU kernel repro/kernels/preproc.py::maxmin_pool_pallas
// (body _kernel).  Bound on Hopper: bytes.  Each input sample is read
// once and one float per window is written, so the least time is
// (rows * t + rows * t / window) * 4 bytes over the device memory rate.
// Design: t is a multiple of the window, so the windows of all rows are
// one flat sequence and window w is x[w * window, (w + 1) * window).  A
// group of window / 4 lanes reads one window as float4 loads (8 lanes for
// the FPGA's 32 samples, 4 windows per warp), and each thread issues the
// loads of kUnroll windows (a grid stride apart) before it reduces any of
// them, so that enough bytes are in flight per SM to reach the memory
// rate.  Max and min are reduced inside each group with xor shuffles, and
// the group's first lanes write neighbouring outputs.  Max and min are
// exact, so the result is bit-exact against the plain version.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

// lanes: window / 4 (a power of two <= 32); windows per warp: 32 / lanes
__global__ void __launch_bounds__(kThreads)
maxmin_pool_kernel(const float4* __restrict__ x, float* __restrict__ out,
                   long long total, int lanes) {
  const int lane = threadIdx.x & 31;
  const int sub = lane & (lanes - 1);
  const int per_warp = 32 / lanes;
  const long long warp =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const long long n_warps =
      static_cast<long long>(gridDim.x) * (kThreads / 32);
  const long long slots = (total + per_warp - 1) / per_warp;
  // warp-uniform loop: every lane takes part in every shuffle
  for (long long s0 = warp; s0 < slots; s0 += n_warps * kUnroll) {
    float4 v[kUnroll];
    long long win[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      win[u] = (s0 + u * n_warps) * per_warp + lane / lanes;
      v[u] = win[u] < total ? __ldg(x + win[u] * lanes + sub)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float mx = fmaxf(fmaxf(v[u].x, v[u].y), fmaxf(v[u].z, v[u].w));
      float mn = fminf(fminf(v[u].x, v[u].y), fminf(v[u].z, v[u].w));
      for (int s = lanes >> 1; s > 0; s >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, s));
        mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, s));
      }
      if (sub == 0 && win[u] < total) out[win[u]] = mx - mn;
    }
  }
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (count <= 0) count = 1;
  }
  return count;
}

}  // namespace

// total: rows * (t / window) windows; x 16-byte aligned, t % window == 0
extern "C" int maxmin_pool_launch(const float* x, float* out, long long total,
                                  int window, void* stream) {
  if (total == 0) return 0;
  const int lanes = window / 4;
  if (window % 4 != 0 || lanes < 1 || lanes > 32 || (lanes & (lanes - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long per_block =
      static_cast<long long>(kThreads / lanes) * kUnroll;
  long long blocks = (total + per_block - 1) / per_block;
  // at most a few waves: the grid-stride loop covers the rest
  const long long cap = 16LL * sm_count();
  if (blocks > cap) blocks = cap;
  maxmin_pool_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(x), out, total, lanes);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* maxmin_pool_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
