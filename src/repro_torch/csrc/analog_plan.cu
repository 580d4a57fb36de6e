// Whole-plan analog chain in one launch.  Per layer, the input is encoded
// at the layer's baked LSB (encode):
//   codes:    5-bit codes arrive as they are,
//   unsigned: float features h -> clip(rint(h / scale), 0, 31),
//   split:    the codes of h and of -h as two passes against the same
//             weight elements, subtracted after the ADC;
// then per chunk c, the arithmetic of analog_mvm.cu: v_c = (a_c @ w_c) *
// gain + off[c], rounded and clipped per chunk (faithful) or once at the
// end to C * [-128, 127] (fast), each split pass on its own.  Between
// layers (hand-off):
//   codes: the ADC epilogue clip(floor(max(y, 0) / 2^shift), 0, 31),
//   relu:  the float glue max(acc * deq[j] + bias[j], 0) (dequantized at
//          a_scale * w_scale / gain, run_layer's expression),
// both optionally merging `flatten` position rows into the next layer's
// contraction axis (the ECG conv -> fc1 im2col hand-off); the last layer
// writes its raw accumulated ADC codes.
//
// Replaces the TPU kernel repro/kernels/analog_plan.py::analog_plan_pallas
// (body _plan_kernel) for layer chains; the transformer-block hand-offs
// run in analog_plan_block.cu.  Bound on Hopper: launch latency and
// bytes.  The ECG chain moves about 1 MB (its input, the 512 x 256 fp32
// packed weights, 10 floats out per record) and does 0.13 MFLOP per
// record.  Design: the grid runs over batch elements; each block owns
// per_block records end to end.  The inter-layer activations (32
// positions x 8 channels and fc1's 123 features per ECG record, codes or
// floats) stay in shared memory, in two ping-pong buffers; the flatten
// is a row-major relabel of that block.  The packed weights exceed a
// block's 227 KB of shared memory, so unlike the TPU kernel they are not
// kept resident: they are read from global memory, where they stay
// L2-resident.  Each thread computes whole output elements: the dot of
// each chunk is a sequential fmaf chain in ascending row order (identical
// to analog_mvm.cu, so the per-layer and the whole-plan routes agree bit
// for bit); float inputs are encoded as they are read, with an IEEE
// divide (__fdiv_rn) and rintf (half to even); the gain/offset step and
// the dequant step are __fmul_rn/__fadd_rn, never one contracted fma.
// The next layer's input block is zeroed before it is written, so
// columns n..k_pad of its chunk padding read as 0.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLayers = 8;
constexpr int kThreads = 256;
constexpr int kFields = 11;  // row0, c0, k, k_pad, n, n_chunks, shift,
                             // flatten, m_mult, encode, handoff
constexpr int kEncCodes = 0, kEncUnsigned = 1, kEncSplit = 2;
constexpr int kHandCodes = 0, kHandRelu = 1;

struct PlanLayer {
  int row0, c0, k, k_pad, n, n_chunks, shift, flatten, m_mult, encode,
      handoff;
};

struct PlanSchedule {
  int n_layers;
  PlanLayer layer[kMaxLayers];
};

__device__ __forceinline__ float adc_clip(float v, float lo, float hi) {
  return fminf(fmaxf(rintf(v), lo), hi);
}

__device__ __forceinline__ float encode5(float h, float scale) {
  return fminf(fmaxf(rintf(__fdiv_rn(h, scale)), 0.f), 31.f);
}

__global__ void __launch_bounds__(kThreads)
analog_plan_kernel(const float* __restrict__ x,
                   const float* __restrict__ w_cat,
                   const float* __restrict__ gain,
                   const float* __restrict__ off,
                   const float* __restrict__ deq,
                   const float* __restrict__ bias,
                   const float* __restrict__ enc, float* __restrict__ out,
                   int batch, int x_cols, int n_max, int chunk_rows,
                   int faithful, int per_block, int buf_floats,
                   PlanSchedule s) {
  extern __shared__ float smem[];
  const int b0 = blockIdx.x * per_block;
  const int nb = min(per_block, batch - b0);
  const float* h = x + static_cast<long long>(b0) * s.layer[0].m_mult * x_cols;
  int h_stride = x_cols;

  for (int l = 0; l < s.n_layers; ++l) {
    const PlanLayer L = s.layer[l];
    const bool last = l == s.n_layers - 1;
    // valid input columns: layer 0 reads x_cols of global memory (k_pad
    // codes or k floats); later layers read their zero-padded block
    const int k_in = l == 0 ? x_cols : L.k_pad;
    const float scale = L.encode == kEncCodes ? 1.f : enc[l];
    const bool split = L.encode == kEncSplit;
    float* nxt = smem + (l & 1) * buf_floats;
    int nxt_stride = 0;
    if (!last) {
      // the buffer was last read by layer l - 1, which ended in a barrier
      nxt_stride = s.layer[l + 1].k_pad;
      const int fill = nb * s.layer[l + 1].m_mult * nxt_stride;
      for (int e = threadIdx.x; e < fill; e += blockDim.x) nxt[e] = 0.f;
      __syncthreads();
    }
    const int rows = nb * L.m_mult;
    const float g_lo = -128.f * L.n_chunks;
    const float g_hi = 127.f * L.n_chunks;
    for (int e = threadIdx.x; e < rows * L.n; e += blockDim.x) {
      const int r = e / L.n;
      const int j = e - r * L.n;
      const float* hr = h + static_cast<long long>(r) * h_stride;
      const float g = gain[l * n_max + j];
      float tp = 0.f, tn = 0.f;
      for (int c = 0; c < L.n_chunks; ++c) {
        const float* hc = hr + c * chunk_rows;
        const float* wc =
            w_cat + static_cast<long long>(L.row0 + c * chunk_rows) * n_max + j;
        const int kk_end = min(chunk_rows, k_in - c * chunk_rows);
        float ap = 0.f, an = 0.f;
        if (L.encode == kEncCodes) {
#pragma unroll 8
          for (int kk = 0; kk < kk_end; ++kk)
            ap = fmaf(hc[kk], wc[static_cast<long long>(kk) * n_max], ap);
        } else {
          for (int kk = 0; kk < kk_end; ++kk) {
            const float hv = hc[kk];
            const float wv = wc[static_cast<long long>(kk) * n_max];
            ap = fmaf(encode5(hv, scale), wv, ap);
            if (split) an = fmaf(encode5(-hv, scale), wv, an);
          }
        }
        const float o = off[(L.c0 + c) * n_max + j];
        float vp = __fadd_rn(__fmul_rn(ap, g), o);
        if (faithful) vp = adc_clip(vp, -128.f, 127.f);
        tp = __fadd_rn(tp, vp);
        if (split) {
          float vn = __fadd_rn(__fmul_rn(an, g), o);
          if (faithful) vn = adc_clip(vn, -128.f, 127.f);
          tn = __fadd_rn(tn, vn);
        }
      }
      if (!faithful) {
        tp = adc_clip(tp, g_lo, g_hi);
        tn = adc_clip(tn, g_lo, g_hi);
      }
      const float total = split ? __fsub_rn(tp, tn) : tp;
      if (last) {
        out[(static_cast<long long>(b0) * L.m_mult + r) * L.n + j] = total;
      } else {
        float v;
        if (L.handoff == kHandCodes) {
          v = floorf(__fdiv_rn(fmaxf(total, 0.f),
                               static_cast<float>(1 << L.shift)));
          v = fminf(fmaxf(v, 0.f), 31.f);
        } else {
          v = fmaxf(__fadd_rn(__fmul_rn(total, deq[l * n_max + j]),
                              bias[l * n_max + j]),
                    0.f);
        }
        const int f = L.flatten;
        nxt[(r / f) * nxt_stride + (r % f) * L.n + j] = v;
      }
    }
    __syncthreads();
    h = nxt;
    h_stride = nxt_stride;
  }
}

}  // namespace

// sched: n_layers * 11 host ints (row0, c0, k, k_pad, n, n_chunks, shift,
// flatten, m_mult, encode, handoff per layer), copied into a by-value
// struct.  deq, bias and enc may be null for a pure code chain.
extern "C" int analog_plan_launch(const float* x, const float* w_cat,
                                  const float* gain, const float* off,
                                  const float* deq, const float* bias,
                                  const float* enc, float* out, int batch,
                                  int x_cols, int n_max, const int* sched,
                                  int n_layers, int chunk_rows, int faithful,
                                  int per_block, void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || per_block < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  PlanSchedule s{};
  s.n_layers = n_layers;
  int buf_floats = 1;
  for (int l = 0; l < n_layers; ++l) {
    const int* f = sched + l * kFields;
    s.layer[l] = PlanLayer{f[0], f[1], f[2], f[3], f[4], f[5],
                           f[6], f[7], f[8], f[9], f[10]};
    if (s.layer[l].encode != kEncCodes && enc == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    if (l + 1 < n_layers && s.layer[l].handoff == kHandRelu &&
        (deq == nullptr || bias == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
    if (l > 0) {
      const int need = per_block * s.layer[l].m_mult * s.layer[l].k_pad;
      if (need > buf_floats) buf_floats = need;
    }
  }
  const size_t smem = 2 * static_cast<size_t>(buf_floats) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        analog_plan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int blocks = (batch + per_block - 1) / per_block;
  analog_plan_kernel<<<blocks, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      x, w_cat, gain, off, deq, bias, enc, out, batch, x_cols, n_max,
      chunk_rows, faithful, per_block, buf_floats, s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* analog_plan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
