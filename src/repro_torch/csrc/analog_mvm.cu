// Chunked saturating analog VMM of the BSS-2 datapath (paper Fig. 4):
// for each chunk c of chunk_rows input rows,
//     v_c = (a_c @ w_c) * gain + off[c]
// faithful: y = sum_c clip(rint(v_c), -128, 127)
// fast:     y = clip(rint(sum_c v_c), -128 C, 127 C)
// then the optional ADC epilogue clip(floor(max(y, 0) / 2^shift), 0, 31).
//
// Replaces the TPU kernel repro/kernels/analog_mvm.py::analog_mvm_pallas
// (body _kernel, epilogue _apply_epilogue).  Bound on Hopper: at the
// ECG shapes (K <= 256, N <= 123) the arithmetic intensity is far below
// the fp32 ridge, so bytes bound it (a, w, gain, off read once, y written
// once); at large M, N it becomes fp32 operations on the CUDA cores.
// Design: one block per 64 x 64 output tile, 256 threads, each owning a
// 4 x 4 strided micro-tile.  The chunk loop runs inside the block (it
// replaces the TPU's sequential "arbitrary" grid axis; Hopper blocks
// share nothing), staging 32-deep slices of a and w in shared memory.
// fp32 operands and fp32 accumulation: the dot of each chunk is a
// sequential fmaf chain in ascending row order, the same chain as the
// whole-plan kernel (analog_plan.cu), so the two routes agree bit for
// bit.  The gain/offset step is written with __fmul_rn/__fadd_rn so that
// nvcc cannot contract it into one fma (the reference rounds twice).
// M and N are masked, not padded.
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kThreads = 256;  // 16 x 16
constexpr int kTM = kBM / 16;
constexpr int kTN = kBN / 16;

__device__ __forceinline__ float adc_clip(float v, float lo, float hi) {
  return fminf(fmaxf(rintf(v), lo), hi);
}

__global__ void __launch_bounds__(kThreads)
analog_mvm_kernel(const float* __restrict__ a, const float* __restrict__ w,
                  const float* __restrict__ gain,
                  const float* __restrict__ off, float* __restrict__ out,
                  int m, int k, int n, int chunk_rows, int faithful,
                  int shift) {
  __shared__ float as[kBK][kBM + 1];  // a slice, transposed; +1: no bank
  __shared__ float ws[kBK][kBN];      // conflicts on the transposing store
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int row0 = blockIdx.x * kBM;
  const int col0 = blockIdx.y * kBN;
  const int n_chunks = k / chunk_rows;

  float g[kTN];
#pragma unroll
  for (int j = 0; j < kTN; ++j) {
    const int col = col0 + tx + 16 * j;
    g[j] = col < n ? gain[col] : 0.f;
  }
  float total[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) total[i][j] = 0.f;

  for (int c = 0; c < n_chunks; ++c) {
    float acc[kTM][kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

    for (int k0 = c * chunk_rows; k0 < (c + 1) * chunk_rows; k0 += kBK) {
      for (int e = threadIdx.x; e < kBM * kBK; e += kThreads) {
        const int r = e / kBK;
        const int kk = e - r * kBK;
        const int gr = row0 + r;
        as[kk][r] = gr < m ? a[static_cast<long long>(gr) * k + k0 + kk] : 0.f;
      }
      for (int e = threadIdx.x; e < kBK * kBN; e += kThreads) {
        const int kk = e / kBN;
        const int cc = e - kk * kBN;
        const int gc = col0 + cc;
        ws[kk][cc] =
            gc < n ? w[static_cast<long long>(k0 + kk) * n + gc] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kBK; ++kk) {
        float av[kTM], wv[kTN];
#pragma unroll
        for (int i = 0; i < kTM; ++i) av[i] = as[kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < kTN; ++j) wv[j] = ws[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j)
            acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int col = col0 + tx + 16 * j;
      const float o = col < n ? off[static_cast<long long>(c) * n + col] : 0.f;
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        float v = __fadd_rn(__fmul_rn(acc[i][j], g[j]), o);
        if (faithful) v = adc_clip(v, -128.f, 127.f);
        total[i][j] = __fadd_rn(total[i][j], v);
      }
    }
  }

  const float lo = -128.f * n_chunks;
  const float hi = 127.f * n_chunks;
  const float div = static_cast<float>(1 << (shift > 0 ? shift : 0));
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int col = col0 + tx + 16 * j;
      if (col >= n) continue;
      float y = total[i][j];
      if (!faithful) y = adc_clip(y, lo, hi);
      if (shift >= 0) {
        y = floorf(__fdiv_rn(fmaxf(y, 0.f), div));
        y = fminf(fmaxf(y, 0.f), 31.f);
      }
      out[static_cast<long long>(row) * n + col] = y;
    }
  }
}

}  // namespace

// shift < 0: no epilogue (raw accumulated ADC codes).
extern "C" int analog_mvm_launch(const float* a, const float* w,
                                 const float* gain, const float* off,
                                 float* out, int m, int k, int n,
                                 int chunk_rows, int faithful, int shift,
                                 void* stream) {
  if (m == 0 || n == 0) return 0;
  if (chunk_rows <= 0 || chunk_rows % kBK != 0 || k % chunk_rows != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((m + kBM - 1) / kBM, (n + kBN - 1) / kBN);
  if (grid.y > 65535u) return static_cast<int>(cudaErrorInvalidValue);
  analog_mvm_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, w, gain, off, out, m, k, n, chunk_rows, faithful, shift);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* analog_mvm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
