// Chunked saturating analog VMM of the BSS-2 datapath (paper Fig. 4):
// for each chunk c of chunk_rows input rows,
//     v_c = (a_c @ w_c) * gain + off[c]
// faithful: y = sum_c clip(rint(v_c), -128, 127)
// fast:     y = clip(rint(sum_c v_c), -128 C, 127 C)
// then the optional ADC epilogue clip(floor(max(y, 0) / 2^shift), 0, 31).
//
// Replaces the TPU kernel repro/kernels/analog_mvm.py::analog_mvm_pallas
// (body _kernel, epilogue _apply_epilogue).
//
// Bound on Hopper.  At the ECG shapes (K <= 256, N <= 123) the work is
// tiny: at batch 1 a few kB of weights and one dependent load-and-chain
// per output (128 fmaf deep), so the launch and that one round trip are
// the floor; at batch 500 the conv layer's 8.2 MB of fp32 input codes
// bound it (2.4 us at 3.35 TB/s).  Large M, N shapes become fp32
// operations on the CUDA cores.
//
// Design: the launch plan comes from the shapes (kernels/analog_mvm.py::
// mvm_plan): a tile of tm rows x tn columns (a multiple of 4 that fits N,
// 4 to 128) per CTA, as many CTAs as keep one wave on the card's SMs.
// * Each thread owns 4 adjacent columns of one row: one float4 weight load
//   feeds 4 fmaf chains.  Each column's dot of a chunk is one fmaf chain
//   over the chunk's rows in ascending order from 0.f, the chain of the
//   whole-plan kernel (analog_plan.cu), so the per-layer and whole-plan
//   routes agree bit for bit.  The gain/offset step is written with
//   __fmul_rn/__fadd_rn so that nvcc cannot contract it into one fma (the
//   reference rounds twice).
// * Chunks cut over warps: `ways` threads of a CTA take chunks side by
//   side (a step is `ways` consecutive chunks).  Each chunk's v_c (fast)
//   or clipped readout (faithful) goes to a per-chunk slot in shared
//   memory, and the thread that owns the element adds the slots in
//   ascending chunk order with __fadd_rn: ((0 + v_0) + v_1) + ..., the
//   serial sum, bit for bit, in both modes.
// * Staged once, asynchronously: each step's a rows (only the CTA's own
//   rows: one at M = 1), weight rows and offset rows are copied into
//   shared memory by cp.async, each step in its own commit group, so step
//   1 lands while step 0 computes (a ring of `stages` buffers refilled
//   when K holds more steps).  16-byte copies where N is a multiple of 4
//   and the rows are aligned (`vec_w`, `vec_a`), else 4-byte copies;
//   rows past M and columns past N are zero-filled.
// * Dynamic shared memory above 48 KB is allowed once per device.
// M and N are masked, not padded.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;  // per CTA: one per (row, 4 columns, chunk)
constexpr int kSmemLimit = 227 * 1024;
constexpr int kMaxDevices = 64;

// a row of one chunk slice in shared memory: 4 floats of padding spread a
// warp's rows over the banks
__host__ __device__ constexpr int a_stride(int chunk_rows) {
  return chunk_rows + 4;
}
// floats of one chunk in a staging buffer: its offset row, the CTA's a
// rows of the chunk, its weight rows
__host__ __device__ constexpr int part_floats(int tm, int tn, int cr) {
  return tn + tm * a_stride(cr) + cr * tn;
}
// the gain row, the per-chunk slots (ways > 1), then `stages` buffers of
// `ways` chunks each
__host__ __device__ constexpr long long smem_floats(int tm, int tn, int ways,
                                                    int stages, int cr) {
  return tn + (ways > 1 ? static_cast<long long>(ways) * tm * tn : 0) +
         static_cast<long long>(stages) * ways * part_floats(tm, tn, cr);
}

struct Plan {
  int tm, tn, ways, stages, steps, n_chunks;
  int vec_a, vec_w;
};

__device__ __forceinline__ float adc_clip(float v, float lo, float hi) {
  return fminf(fmaxf(rintf(v), lo), hi);
}

// cp.async of `bytes` (0 or the full size: the rest is zero-filled) from
// global memory; src must be a valid address even when bytes is 0
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

// 4 floats of which the first `valid` (0..4) are real: one 16-byte copy
// (vec: valid is 0 or 4) or four 4-byte copies
__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      const float* base, int valid,
                                      bool vec) {
  if (vec) {
    cp_async16(dst, valid > 0 ? src : base, valid > 0 ? 16 : 0);
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    cp_async4(dst + j, j < valid ? src + j : base, j < valid ? 4 : 0);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most `pending` cp.async groups are in flight (a larger
// count waits for more than asked, which is safe)
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::); break;
  }
}

// Issue the copies of step s (chunks s*ways ...) into buffer `buf`: per
// chunk its offset row, the CTA's a rows and its weight rows.  Each warp
// copies whole a rows (lane i the i-th 4 floats); each thread keeps one
// 4-column unit of the weight and offset rows, a row stride apart, so the
// loops divide nothing.
__device__ __forceinline__ void stage_step(
    const float* __restrict__ a, const float* __restrict__ w,
    const float* __restrict__ off, float* buf, int s, const Plan& P, int m,
    int k, int n, int cr, int row0, int col0, int w_row, int w_unit,
    int w_rows_per_pass) {
  const int c0 = s * P.ways;
  const int parts = min(P.ways, P.n_chunks - c0);
  const int pf = part_floats(P.tm, P.tn, cr);
  const int sa = a_stride(cr);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  for (int p = 0; p < parts; ++p) {
    float* part = buf + p * pf;
    const int kc = (c0 + p) * cr;
    for (int r = warp; r < P.tm; r += warps) {
      const int row = row0 + r;
      const float* src = a + static_cast<long long>(row) * k + kc;
      for (int k4 = 4 * lane; k4 < cr; k4 += 128)
        copy4(part + P.tn + r * sa + k4, src + k4, a, row < m ? 4 : 0,
              P.vec_a);
    }
    if (w_row >= w_rows_per_pass) continue;
    const int j = 4 * w_unit, col = col0 + j;
    const int valid = max(0, min(4, n - col));
    // the weight rows, then (kk == cr) the chunk's offset row
    for (int kk = w_row; kk <= cr; kk += w_rows_per_pass) {
      if (kk == cr)
        copy4(part + j, off + static_cast<long long>(c0 + p) * n + col, off,
              valid, P.vec_w);
      else
        copy4(part + P.tn + P.tm * sa + kk * P.tn + j,
              w + static_cast<long long>(kc + kk) * n + col, w, valid,
              P.vec_w);
    }
  }
}

// CR: chunk_rows known at compile time (the datapath's 128), or 0 for any
// other multiple of 32, passed as cr_rt.
template <int CR>
__global__ void __launch_bounds__(kThreads)
analog_mvm_kernel(const float* __restrict__ a, const float* __restrict__ w,
                  const float* __restrict__ gain,
                  const float* __restrict__ off, float* __restrict__ out,
                  int m, int k, int n, int cr_rt, int faithful, int shift,
                  Plan P) {
  const int cr = CR > 0 ? CR : cr_rt;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * P.tm;
  const int col0 = blockIdx.y * P.tn;
  const int groups = P.tn / 4;
  const int owners = P.tm * groups;  // one thread per (row, 4 columns)
  const int pf = part_floats(P.tm, P.tn, cr);
  const int sa = a_stride(cr);
  float* G = smem;
  float* slots = smem + P.tn;
  float* bufs = slots + (P.ways > 1 ? P.ways * P.tm * P.tn : 0);

  // this thread's unit of the weight and offset rows
  const int w_row = tid / groups;
  const int w_unit = tid - w_row * groups;
  const int w_rows_per_pass = blockDim.x / groups;
  // the gain row joins step 0's group; one group per step in flight
  if (tid < groups)
    copy4(G + 4 * tid, gain + col0 + 4 * tid, gain,
          max(0, min(4, n - col0 - 4 * tid)), P.vec_w);
  for (int s = 0; s < P.stages; ++s) {
    if (s < P.steps)
      stage_step(a, w, off, bufs + s * P.ways * pf, s, P, m, k, n, cr, row0,
                 col0, w_row, w_unit, w_rows_per_pass);
    cp_async_commit();
  }

  // this thread's element: part p (a chunk of each step), row r, 4 columns
  const int p = tid / owners;
  const int loc = tid - p * owners;
  const int r = loc / groups;
  const int j0 = 4 * (loc - r * groups);
  const bool active = p < P.ways;
  float tot[4] = {0.f, 0.f, 0.f, 0.f};

  for (int s = 0; s < P.steps; ++s) {
    cp_async_wait(P.stages - 1);  // step s landed (this thread's copies)
    __syncthreads();              // ... and every thread's
    const float* buf = bufs + (s % P.stages) * P.ways * pf;
    const int c = s * P.ways + p;
    if (active && c < P.n_chunks) {
      const float* part = buf + p * pf;
      const float* ar = part + P.tn + r * sa;
      const float* wc = part + P.tn + P.tm * sa + j0;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int kk = 0; kk < cr; kk += 4) {
        const float4 a4 = *reinterpret_cast<const float4*>(ar + kk);
        const float av[4] = {a4.x, a4.y, a4.z, a4.w};
        float4 w4[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          w4[i] = *reinterpret_cast<const float4*>(wc + (kk + i) * P.tn);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float wv[4] = {w4[i].x, w4[i].y, w4[i].z, w4[i].w};
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[q] = fmaf(av[i], wv[q], acc[q]);
        }
      }
      const float4 g4 = *reinterpret_cast<const float4*>(G + j0);
      const float4 o4 = *reinterpret_cast<const float4*>(part + j0);
      const float gv[4] = {g4.x, g4.y, g4.z, g4.w};
      const float ov[4] = {o4.x, o4.y, o4.z, o4.w};
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        v[q] = __fadd_rn(__fmul_rn(acc[q], gv[q]), ov[q]);
        if (faithful) v[q] = adc_clip(v[q], -128.f, 127.f);
      }
      if (p == 0) {
#pragma unroll
        for (int q = 0; q < 4; ++q) tot[q] = __fadd_rn(tot[q], v[q]);
      } else {
        *reinterpret_cast<float4*>(slots + (p * P.tm + r) * P.tn + j0) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
    }
    if (P.ways > 1) {
      __syncthreads();  // the slots of this step are written
      if (p == 0) {
        // the owner adds the other chunks of the step in ascending order
        for (int pp = 1; pp < P.ways && s * P.ways + pp < P.n_chunks; ++pp) {
          const float4 s4 = *reinterpret_cast<const float4*>(
              slots + (pp * P.tm + r) * P.tn + j0);
          tot[0] = __fadd_rn(tot[0], s4.x);
          tot[1] = __fadd_rn(tot[1], s4.y);
          tot[2] = __fadd_rn(tot[2], s4.z);
          tot[3] = __fadd_rn(tot[3], s4.w);
        }
      }
    }
    if (s + P.stages < P.steps) {
      if (P.ways == 1) __syncthreads();  // every thread is done with buf
      stage_step(a, w, off, bufs + (s % P.stages) * P.ways * pf,
                 s + P.stages, P, m, k, n, cr, row0, col0, w_row, w_unit,
                 w_rows_per_pass);
    }
    cp_async_commit();
  }
  cp_async_wait(0);

  if (p != 0) return;
  const float lo = -128.f * P.n_chunks;
  const float hi = 127.f * P.n_chunks;
  const float div = static_cast<float>(1 << (shift > 0 ? shift : 0));
  const int row = row0 + r;
  if (row >= m) return;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int col = col0 + j0 + q;
    if (col >= n) continue;
    float y = tot[q];
    if (!faithful) y = adc_clip(y, lo, hi);
    if (shift >= 0) {
      y = floorf(__fdiv_rn(fmaxf(y, 0.f), div));
      y = fminf(fmaxf(y, 0.f), 31.f);
    }
    out[static_cast<long long>(row) * n + col] = y;
  }
}

template <int CR>
int launch(dim3 grid, long long smem, cudaStream_t st,
           const float* a, const float* w, const float* gain,
           const float* off, float* out, int m, int k, int n,
           int chunk_rows, int faithful, int shift, const Plan& P) {
  if (smem > 48 * 1024) {
    // allow the whole limit once per device: the attribute call costs
    // more host time than a batch-1 launch
    static bool allowed[kMaxDevices] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev >= kMaxDevices || !allowed[dev]) {
      e = cudaFuncSetAttribute(analog_mvm_kernel<CR>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemLimit);
      if (e != cudaSuccess) return static_cast<int>(e);
      if (dev < kMaxDevices) allowed[dev] = true;
    }
  }
  analog_mvm_kernel<CR><<<grid, kThreads, static_cast<size_t>(smem), st>>>(
      a, w, gain, off, out, m, k, n, chunk_rows, faithful, shift, P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The plan (kernels/analog_mvm.py::mvm_plan): tm rows x tn columns per CTA
// (tn a multiple of 4, 4..128), `ways` chunks side by side per step,
// `stages` staging buffers; tm * tn / 4 * ways <= 256 threads per CTA.
// vec_a: a's rows start on 16-byte boundaries; vec_w: so do the rows of w,
// off and gain (N a multiple of 4).  shift < 0: no epilogue (raw
// accumulated ADC codes).
extern "C" int analog_mvm_launch(const float* a, const float* w,
                                 const float* gain, const float* off,
                                 float* out, int m, int k, int n,
                                 int chunk_rows, int faithful, int shift,
                                 int tm, int tn, int ways, int stages,
                                 int vec_a, int vec_w, void* stream) {
  if (m == 0 || n == 0) return 0;
  if (chunk_rows <= 0 || chunk_rows % 4 != 0 || k % chunk_rows != 0 ||
      tn < 4 || tn > 128 || tn % 4 != 0 || tm < 1 || ways < 1 ||
      stages < 1 || stages > 4 ||
      static_cast<long long>(tm) * (tn / 4) * ways > kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  Plan P{tm, tn, ways, stages, 0, k / chunk_rows, vec_a != 0, vec_w != 0};
  P.steps = (P.n_chunks + ways - 1) / ways;
  const long long smem = 4 * smem_floats(tm, tn, ways, stages, chunk_rows);
  const long long row_groups = (m + tm - 1LL) / tm;
  const long long col_tiles = (n + tn - 1LL) / tn;
  if (smem > kSmemLimit || row_groups > 0x7fffffffLL || col_tiles > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(row_groups),
                  static_cast<unsigned>(col_tiles));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return chunk_rows == 128
             ? launch<128>(grid, smem, st, a, w, gain, off, out, m, k, n,
                           chunk_rows, faithful, shift, P)
             : launch<0>(grid, smem, st, a, w, gain, off, out, m, k, n,
                         chunk_rows, faithful, shift, P);
}

extern "C" const char* analog_mvm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
