// FPGA preprocessing pooling (paper Fig. 7): max - min over each
// non-overlapping window of a [rows, t] float32 signal.
//
// Replaces the TPU kernel repro/kernels/preproc.py::maxmin_pool_pallas
// (body _kernel).  Bound on Hopper: bytes.  Each input sample is read
// once and one float per window is written, so the least time is
// (rows * t + rows * t / window) * 4 bytes over the device memory rate.
// Design: one warp per output window.  Lane i reads sample i of the
// window (a 32-sample window is one coalesced 128-byte load), and the
// max and the min are reduced across the warp with shuffles; nothing is
// staged in shared memory.  The ragged edge (126 outputs per ECG row is
// no power of two) is handled by flat indexing over rows * t_out windows
// with a per-warp guard.  max and min are exact, so the result is
// bit-exact against the plain version.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
maxmin_pool_kernel(const float* __restrict__ x, float* __restrict__ out,
                   int rows, int t, int window) {
  const int t_out = t / window;
  const long long total = static_cast<long long>(rows) * t_out;
  const int lane = threadIdx.x & 31;
  const long long win =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (win >= total) return;  // uniform across the warp
  const long long r = win / t_out;
  const long long o = win - r * t_out;
  const float* seg = x + r * t + o * window;
  float mx = -CUDART_INF_F;
  float mn = CUDART_INF_F;
  for (int i = lane; i < window; i += 32) {
    const float v = seg[i];
    mx = fmaxf(mx, v);
    mn = fminf(mn, v);
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, s));
    mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, s));
  }
  if (lane == 0) out[win] = mx - mn;
}

}  // namespace

extern "C" int maxmin_pool_launch(const float* x, float* out, int rows,
                                  int t, int window, void* stream) {
  const long long total = static_cast<long long>(rows) * (t / window);
  if (total == 0) return 0;
  const long long blocks = (total + kWarpsPerBlock - 1) / kWarpsPerBlock;
  maxmin_pool_kernel<<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32,
                       0, static_cast<cudaStream_t>(stream)>>>(
      x, out, rows, t, window);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* maxmin_pool_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
