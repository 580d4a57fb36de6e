// Signed-split chunked saturating analog VMM of the BSS-2 datapath (paper
// Sec. II-A: the positive and the negative parts of a signed activation
// run as two analog passes on the same synapse columns):
//     y = mvm(a_pos) - mvm(a_neg)
// where, per pass and per chunk c of chunk_rows input rows,
//     v_c = (a_c @ w_c) * gain + off[c]
// faithful: mvm(a) = sum_c clip(rint(v_c), -128, 127)
// fast:     mvm(a) = clip(rint(sum_c v_c), -128 C, 127 C)
// then the optional ADC epilogue clip(floor(max(y, 0) / 2^shift), 0, 31).
//
// Replaces the TPU kernel repro/kernels/analog_mvm.py::
// analog_mvm_split_pallas (body _split_kernel).  Bound on Hopper: on the
// language-model path M is the batch (decode) or batch x prompt length
// (prefill), a few to a few dozen rows against K x N weights of up to
// 3072 x 200064, so the fp32 weights dominate the bytes and the kernel is
// bytes-bound: each weight element must be read from device memory once
// per call.  Design: each block owns one BM x 64 output tile and walks all
// chunks itself (the TPU's sequential "arbitrary" grid axis has no Hopper
// counterpart; blocks share nothing).  A 32-row slice of w is staged in
// shared memory once and feeds BOTH passes' dots; the next slice is
// fetched into registers while the current one is consumed.  Each pass
// keeps its own accumulator and its own per-chunk rint (half to even) and
// clip; the difference is formed after the last chunk.  BM is 16 for
// M <= 16 (decode) and 64 otherwise, so decode does not spend four times
// the fmas on masked rows.  The dot of each chunk is a sequential fmaf
// chain in ascending row order, the chain analog_mvm.cu runs, and the
// gain/offset step is __fmul_rn/__fadd_rn (no fma contraction), so the
// kernel is bit-exact against its plain version whenever the dot is exact
// (integer w_eff).  M and N are masked, not padded.
#include <cuda_runtime.h>

namespace {

constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kThreads = 256;  // 16 x 16
constexpr int kTN = kBN / 16;
constexpr int kWLoads = kBK * kBN / kThreads;

__device__ __forceinline__ float adc_clip(float v, float lo, float hi) {
  return fminf(fmaxf(rintf(v), lo), hi);
}

template <int BM>
__global__ void __launch_bounds__(kThreads)
analog_mvm_split_kernel(const float* __restrict__ ap,
                        const float* __restrict__ an,
                        const float* __restrict__ w,
                        const float* __restrict__ gain,
                        const float* __restrict__ off,
                        float* __restrict__ out, int m, int k, int n,
                        int chunk_rows, int faithful, int shift) {
  constexpr int kTM = BM / 16;
  constexpr int kALoads = BM * kBK / kThreads;
  // a slices transposed, +1: no bank conflicts on the transposing store
  __shared__ float as_p[kBK][BM + 1];
  __shared__ float as_n[kBK][BM + 1];
  __shared__ float ws[kBK][kBN];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int col0 = blockIdx.x * kBN;
  const int row0 = blockIdx.y * BM;
  const int n_chunks = k / chunk_rows;
  const int slices_per_chunk = chunk_rows / kBK;
  const int n_slices = k / kBK;

  float g[kTN];
#pragma unroll
  for (int j = 0; j < kTN; ++j) {
    const int col = col0 + tx + 16 * j;
    g[j] = col < n ? gain[col] : 0.f;
  }

  // register copies of the next slice (global -> registers -> shared)
  float rp[kALoads], rn[kALoads], rw[kWLoads];
  auto fetch = [&](int s) {
    const int k0 = s * kBK;
#pragma unroll
    for (int l = 0; l < kALoads; ++l) {
      const int e = threadIdx.x + l * kThreads;
      const int r = e / kBK;
      const int kk = e - r * kBK;
      const int gr = row0 + r;
      const long long idx = static_cast<long long>(gr) * k + k0 + kk;
      rp[l] = gr < m ? ap[idx] : 0.f;
      rn[l] = gr < m ? an[idx] : 0.f;
    }
#pragma unroll
    for (int l = 0; l < kWLoads; ++l) {
      const int e = threadIdx.x + l * kThreads;
      const int kk = e / kBN;
      const int cc = e - kk * kBN;
      const int gc = col0 + cc;
      rw[l] = gc < n ? w[static_cast<long long>(k0 + kk) * n + gc] : 0.f;
    }
  };

  float accp[kTM][kTN], accn[kTM][kTN], totp[kTM][kTN], totn[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      accp[i][j] = accn[i][j] = 0.f;
      totp[i][j] = totn[i][j] = 0.f;
    }

  if (n_slices > 0) fetch(0);
  for (int s = 0; s < n_slices; ++s) {
    __syncthreads();  // the previous slice is consumed
#pragma unroll
    for (int l = 0; l < kALoads; ++l) {
      const int e = threadIdx.x + l * kThreads;
      const int r = e / kBK;
      const int kk = e - r * kBK;
      as_p[kk][r] = rp[l];
      as_n[kk][r] = rn[l];
    }
#pragma unroll
    for (int l = 0; l < kWLoads; ++l) {
      const int e = threadIdx.x + l * kThreads;
      ws[e / kBN][e % kBN] = rw[l];
    }
    __syncthreads();
    if (s + 1 < n_slices) fetch(s + 1);  // in flight during the dots

#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float wv[kTN];
#pragma unroll
      for (int j = 0; j < kTN; ++j) wv[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const float pv = as_p[kk][ty + 16 * i];
        const float nv = as_n[kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          accp[i][j] = fmaf(pv, wv[j], accp[i][j]);
          accn[i][j] = fmaf(nv, wv[j], accn[i][j]);
        }
      }
    }

    if ((s + 1) % slices_per_chunk == 0) {  // the chunk's ADC readout
      const int c = s / slices_per_chunk;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int col = col0 + tx + 16 * j;
        const float o =
            col < n ? off[static_cast<long long>(c) * n + col] : 0.f;
#pragma unroll
        for (int i = 0; i < kTM; ++i) {
          float vp = __fadd_rn(__fmul_rn(accp[i][j], g[j]), o);
          float vn = __fadd_rn(__fmul_rn(accn[i][j], g[j]), o);
          if (faithful) {
            vp = adc_clip(vp, -128.f, 127.f);
            vn = adc_clip(vn, -128.f, 127.f);
          }
          totp[i][j] = __fadd_rn(totp[i][j], vp);
          totn[i][j] = __fadd_rn(totn[i][j], vn);
          accp[i][j] = 0.f;
          accn[i][j] = 0.f;
        }
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
      float yp = totp[i][j];
      float yn = totn[i][j];
      if (!faithful) {
        yp = adc_clip(yp, lo, hi);
        yn = adc_clip(yn, lo, hi);
      }
      float y = __fsub_rn(yp, yn);
      if (shift >= 0) {
        y = floorf(__fdiv_rn(fmaxf(y, 0.f), div));
        y = fminf(fmaxf(y, 0.f), 31.f);
      }
      out[static_cast<long long>(row) * n + col] = y;
    }
  }
}

}  // namespace

// shift < 0: no epilogue (the raw difference of the accumulated ADC codes).
extern "C" int analog_mvm_split_launch(const float* ap, const float* an,
                                       const float* w, const float* gain,
                                       const float* off, float* out, int m,
                                       int k, int n, int chunk_rows,
                                       int faithful, int shift,
                                       void* stream) {
  if (m == 0 || n == 0) return 0;
  if (chunk_rows <= 0 || chunk_rows % kBK != 0 || k % chunk_rows != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned col_tiles = (n + kBN - 1) / kBN;
  if (m <= 16) {
    analog_mvm_split_kernel<16><<<dim3(col_tiles, 1), kThreads, 0, st>>>(
        ap, an, w, gain, off, out, m, k, n, chunk_rows, faithful, shift);
  } else {
    const unsigned row_tiles = (m + 63) / 64;
    if (row_tiles > 65535u) return static_cast<int>(cudaErrorInvalidValue);
    analog_mvm_split_kernel<64>
        <<<dim3(col_tiles, row_tiles), kThreads, 0, st>>>(
            ap, an, w, gain, off, out, m, k, n, chunk_rows, faithful, shift);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* analog_mvm_split_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
