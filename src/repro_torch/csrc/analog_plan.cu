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
// bytes.  The ECG chain moves about 0.6 MB (its input, the real columns
// of its weights, 10 floats out per record) and does 0.13 MFLOP per
// record; at batch 1 the dependent chain of three layers is the floor.
// Design: the grid runs over batch elements, each block owning per_block
// records end to end (as many as keep one wave of blocks on the card and
// fit its shared memory).
// * Weights in shared memory.  At the start every layer's segment - its
//   real weight columns (k_pad rows x n, row stride n rounded up to 4),
//   gain, chunk offsets and, for a float hand-off, dequant and bias rows -
//   is copied from the packed operands with 16-byte cp.async, one commit
//   group per layer after one for the chain input's rows, so a later
//   layer's segment lands while the earlier layers compute (the ECG
//   chain's 137 KB fit beside the activations; a layer that does not fit
//   is read from global memory).
// * Encode once.  Before its dot, a layer encodes its input block - the
//   chain input (copied in by cp.async where its rows are 16-byte
//   aligned), else the previous layer's hand-off - in shared memory, once
//   per element: the codes of h and, for split, of -h (__fdiv_rn and
//   rintf, half to even), or the codes as they are.  Columns past the
//   input's width (the chunk padding) read as code 0.
// * Each thread computes 4 adjacent output columns of one row: one float4
//   weight load feeds 4 fmaf chains, each column's dot of a chunk one
//   chain in ascending row order (identical to analog_mvm.cu, so the
//   per-layer and the whole-plan routes agree bit for bit; a padding code
//   0 adds an exact +0), and the gain/offset and dequant steps are
//   __fmul_rn/__fadd_rn, never one contracted fma.
// * Batch 1 leaves most of a block idle: in faithful mode a layer whose
//   items use less than half the block cuts each dot's chunks over up to
//   blockDim / items threads.  The per-chunk ADC readouts are integers,
//   so the partial totals sum exactly in a fixed order.  (A cluster
//   cutting the columns over SMs would also split the weight staging,
//   which one SM does at its share of L2 bandwidth, for a distributed
//   shared-memory exchange and a cluster barrier per layer; not built.)
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kMaxLayers = 8;
constexpr int kThreads = 256;
constexpr int kFields = 11;  // row0, c0, k, k_pad, n, n_chunks, shift,
                             // flatten, m_mult, encode, handoff
constexpr int kEncCodes = 0, kEncUnsigned = 1, kEncSplit = 2;
constexpr int kHandCodes = 0, kHandRelu = 1;
constexpr int kSmemLimit = 227 * 1024;
constexpr int kMaxDevices = 64;
constexpr int kCols = 4;  // output columns per thread (one float4)

struct PlanLayer {
  int row0, c0, k, k_pad, n, n_chunks, shift, flatten, m_mult, encode,
      handoff;
};

struct PlanSchedule {
  int n_layers;
  PlanLayer layer[kMaxLayers];
};

// Shared memory of one block, in floats: each staged layer's segment
// (wofs < 0: read from global memory) - its weights, gains, chunk offsets
// and, for a float hand-off, dequant and bias rows, each row n rounded up
// to 4 - the encoded operands A (codes of h) and B (codes of -h), the
// hand-off block H (the next layer's input) and the chunk partials P.
struct Layout {
  int wofs[kMaxLayers];
  int a, b, h, p, floats, per_block;
  int x_async;  // layer 0's input rows are 16-byte aligned: cp.async them
};

__host__ __device__ constexpr int round4(int v) { return (v + 3) / 4 * 4; }
// operand row stride: 4 floats of padding spread a warp's rows over the
// shared-memory banks
__host__ __device__ constexpr int a_stride(int k_pad) { return k_pad + 4; }

__device__ __forceinline__ float adc_clip(float v, float lo, float hi) {
  return fminf(fmaxf(rintf(v), lo), hi);
}

__device__ __forceinline__ float encode5(float h, float scale) {
  return fminf(fmaxf(rintf(__fdiv_rn(h, scale)), 0.f), 31.f);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

// wait until at most `pending` cp.async groups are in flight
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::); break;
  }
}

// Rows of a staged layer's segment: k_pad weight rows, the gain row,
// n_chunks offset rows, then the dequant and bias rows when `tables`.
__host__ __device__ constexpr int seg_rows(int k_pad, int n_chunks,
                                           bool tables) {
  return k_pad + 1 + n_chunks + (tables ? 2 : 0);
}

// Encode rows x k_pad of a layer's input block into A (codes of h, or h
// itself for encode "codes") and, for split, B (codes of -h).  Columns at
// or past `valid` are chunk padding: code 0.  kU loads in flight per
// thread.
template <int kU>
__device__ __forceinline__ void encode_block(const float* src,
                                             int src_stride, int valid,
                                             int rows, const PlanLayer& L,
                                             float scale, float* A,
                                             float* B) {
  const int total = rows * L.k_pad;
  const int sa = a_stride(L.k_pad);
  for (int e0 = threadIdx.x; e0 < total; e0 += kThreads * kU) {
    float v[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int e = e0 + u * kThreads;
      const int r = e / L.k_pad, k = e - r * L.k_pad;
      v[u] = e < total && k < valid ? src[r * src_stride + k] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int e = e0 + u * kThreads;
      if (e >= total) break;
      const int r = e / L.k_pad, k = e - r * L.k_pad;
      A[r * sa + k] = L.encode == kEncCodes ? v[u] : encode5(v[u], scale);
      if (L.encode == kEncSplit) B[r * sa + k] = encode5(-v[u], scale);
    }
  }
}

// The dots of chunks [c0, c1) for kCols output columns j0.. of one row:
// a (and, split, b) is the row's encoded operand, w the layer's weights
// at column j0 (row stride ws).  Each column's dot of a chunk is one fmaf
// chain in ascending row order; the kCols chains interleave.  The ADC
// readout of each chunk adds to tp (and tn).
template <bool SPLIT>
__device__ __forceinline__ void dot_chunks(
    const float* a, const float* b, const float* w, int ws, int c0, int c1,
    int chunk_rows, const float4 g, const float* off, int off_stride,
    bool faithful, float (&tp)[kCols], float (&tn)[kCols]) {
  const float gv[kCols] = {g.x, g.y, g.z, g.w};
  for (int c = c0; c < c1; ++c) {
    const float* ac = a + c * chunk_rows;
    const float* bc = b + c * chunk_rows;
    const float* wc = w + c * chunk_rows * ws;
    float ap[kCols] = {0.f, 0.f, 0.f, 0.f}, an[kCols] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
    for (int kk = 0; kk < chunk_rows; kk += 4) {
      const float4 a4 = *reinterpret_cast<const float4*>(ac + kk);
      float4 b4 = a4;
      if (SPLIT) b4 = *reinterpret_cast<const float4*>(bc + kk);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
      const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
      float4 w4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        w4[i] = *reinterpret_cast<const float4*>(wc + (kk + i) * ws);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float wv[kCols] = {w4[i].x, w4[i].y, w4[i].z, w4[i].w};
#pragma unroll
        for (int q = 0; q < kCols; ++q) {
          ap[q] = fmaf(av[i], wv[q], ap[q]);
          if (SPLIT) an[q] = fmaf(bv[i], wv[q], an[q]);
        }
      }
    }
    const float4 o4 =
        *reinterpret_cast<const float4*>(off + c * off_stride);
    const float ov[kCols] = {o4.x, o4.y, o4.z, o4.w};
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
      float vp = __fadd_rn(__fmul_rn(ap[q], gv[q]), ov[q]);
      if (faithful) vp = adc_clip(vp, -128.f, 127.f);
      tp[q] = __fadd_rn(tp[q], vp);
      if (SPLIT) {
        float vn = __fadd_rn(__fmul_rn(an[q], gv[q]), ov[q]);
        if (faithful) vn = adc_clip(vn, -128.f, 127.f);
        tn[q] = __fadd_rn(tn[q], vn);
      }
    }
  }
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
                   int faithful, PlanSchedule s, Layout lay) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * lay.per_block;
  const int nb = min(lay.per_block, batch - b0);

  float* A = smem + lay.a;
  float* B = smem + lay.b;
  float* H = smem + lay.h;
  float* P = smem + lay.p;
  const bool tables = deq != nullptr;
  // layer 0's input rows (one cp.async group), then each staged layer's
  // segment (one group per layer)
  {
    const PlanLayer& L = s.layer[0];
    const int q4 = x_cols / 4;
    const float* src = x + static_cast<long long>(b0) * L.m_mult * x_cols;
    if (lay.x_async)
      for (int e = tid; e < nb * L.m_mult * q4; e += kThreads) {
        const int r = e / q4, c = 4 * (e - r * q4);
        cp_async16(A + r * a_stride(L.k_pad) + c, src + r * x_cols + c);
      }
    asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int l = 0; l < s.n_layers; ++l) {
    if (lay.wofs[l] >= 0) {
      const PlanLayer& L = s.layer[l];
      const int q4 = round4(L.n) / 4;
      float* dst = smem + lay.wofs[l];
      const int rows = seg_rows(L.k_pad, L.n_chunks, tables);
      for (int e = tid; e < rows * q4; e += kThreads) {
        const int r = e / q4, c = 4 * (e - r * q4);
        const int t = r - L.k_pad;  // rows past the weights: the tables
        const float* row =
            t < 0 ? w_cat + static_cast<long long>(L.row0 + r) * n_max
            : t == 0 ? gain + l * n_max
            : t <= L.n_chunks ? off + (L.c0 + t - 1) * n_max
            : t == L.n_chunks + 1 ? deq + l * n_max : bias + l * n_max;
        cp_async16(dst + r * 4 * q4 + c, row + c);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  }

  for (int l = 0; l < s.n_layers; ++l) {
    const PlanLayer L = s.layer[l];
    const bool last = l == s.n_layers - 1;
    const bool split = L.encode == kEncSplit;
    const int rows = nb * L.m_mult;
    const int sa = a_stride(L.k_pad);
    // encode the input block once: layer 0 reads the chain input, later
    // layers the hand-off block; columns past its width are padding
    const float scale = L.encode == kEncCodes ? 1.f : enc[l];
    if (l == 0 && lay.x_async) {
      cp_async_wait(s.n_layers);  // the input rows landed in A
      __syncthreads();
      encode_block<8>(A, sa, x_cols, rows, L, scale, A, B);
    } else if (l == 0) {
      encode_block<8>(x + static_cast<long long>(b0) * L.m_mult * x_cols,
                      x_cols, x_cols, rows, L, scale, A, B);
    } else {
      encode_block<4>(H, L.k_pad,
                      s.layer[l - 1].flatten * s.layer[l - 1].n, rows, L,
                      scale, A, B);
    }
    cp_async_wait(s.n_layers - 1 - l);  // this layer's segment landed
    __syncthreads();
    const bool staged = lay.wofs[l] >= 0;
    const int n4 = round4(L.n);
    // the layer's gain, offset, dequant and bias rows: staged, or in place
    const float* seg = smem + lay.wofs[l] + L.k_pad * n4;
    const float* g_row = staged ? seg : gain + l * n_max;
    const float* off_rows = staged ? seg + n4 : off + L.c0 * n_max;
    const int off_stride = staged ? n4 : n_max;
    const float* deq_row =
        staged ? seg + (1 + L.n_chunks) * n4 : deq + l * n_max;
    const float* bias_row = staged ? deq_row + n4 : bias + l * n_max;

    const int ng = (L.n + kCols - 1) / kCols;
    const int outs = rows * ng;
    int ways = 1;
    if (faithful && L.n_chunks > 1)
      ways = max(1, min(L.n_chunks, kThreads / outs));
    const int cpw = (L.n_chunks + ways - 1) / ways;
    const float g_lo = -128.f * L.n_chunks;
    const float g_hi = 127.f * L.n_chunks;
    const int nxt_stride = last ? 0 : s.layer[l + 1].k_pad;

    // the hand-off of output (r, j)
    auto emit = [&](int r, int j, float total) {
      if (last) {
        out[(static_cast<long long>(b0) * L.m_mult + r) * L.n + j] = total;
        return;
      }
      float v;
      if (L.handoff == kHandCodes) {
        v = floorf(__fdiv_rn(fmaxf(total, 0.f),
                             static_cast<float>(1 << L.shift)));
        v = fminf(fmaxf(v, 0.f), 31.f);
      } else {
        v = fmaxf(__fadd_rn(__fmul_rn(total, deq_row[j]), bias_row[j]),
                  0.f);
      }
      const int f = L.flatten;
      H[(r / f) * nxt_stride + (r % f) * L.n + j] = v;
    };

    for (int e = tid; e < outs * ways; e += kThreads) {
      const int part = e / outs;
      const int rg = e - part * outs;
      const int r = rg / ng, j0 = kCols * (rg - r * ng);
      const float4 g = *reinterpret_cast<const float4*>(g_row + j0);
      const float* offc = off_rows + j0;
      const int c0 = part * cpw, c1 = min(L.n_chunks, c0 + cpw);
      float tp[kCols] = {0.f, 0.f, 0.f, 0.f}, tn[kCols] = {0.f, 0.f, 0.f, 0.f};
      const float* a = A + r * sa;
      const float* b = B + r * sa;
      // the weights: staged (row stride n4; two branches, so that the
      // staged loads compile to shared-memory loads), or in place
      if (staged) {
        const float* w = smem + lay.wofs[l] + j0;
        if (split)
          dot_chunks<true>(a, b, w, n4, c0, c1, chunk_rows, g, offc,
                           off_stride, faithful, tp, tn);
        else
          dot_chunks<false>(a, b, w, n4, c0, c1, chunk_rows, g, offc,
                            off_stride, faithful, tp, tn);
      } else {
        const float* w =
            w_cat + static_cast<long long>(L.row0) * n_max + j0;
        if (split)
          dot_chunks<true>(a, b, w, n_max, c0, c1, chunk_rows, g, offc,
                           off_stride, faithful, tp, tn);
        else
          dot_chunks<false>(a, b, w, n_max, c0, c1, chunk_rows, g, offc,
                            off_stride, faithful, tp, tn);
      }
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        if (!faithful) {
          tp[q] = adc_clip(tp[q], g_lo, g_hi);
          tn[q] = adc_clip(tn[q], g_lo, g_hi);
        }
        const float total = split ? __fsub_rn(tp[q], tn[q]) : tp[q];
        if (ways > 1)
          P[e * kCols + q] = total;  // an integer partial total (faithful)
        else if (j0 + q < L.n)
          emit(r, j0 + q, total);
      }
    }
    if (ways > 1) {
      __syncthreads();
      for (int o = tid; o < outs * kCols; o += kThreads) {
        const int rg = o / kCols, q = o - rg * kCols;
        const int r = rg / ng, j = kCols * (rg - r * ng) + q;
        if (j >= L.n) continue;
        float total = 0.f;
        for (int part = 0; part < ways; ++part)
          total = __fadd_rn(total, P[(part * outs + rg) * kCols + q]);
        emit(r, j, total);
      }
    }
    __syncthreads();
  }
}

// the shared-memory layout for per_block records, or floats < 0 when the
// activations alone do not fit
Layout layout(const PlanSchedule& s, int per_block, bool stage_all,
              bool tables) {
  Layout lay{};
  int act = 0, h = 1;
  bool any_split = false;
  for (int l = 0; l < s.n_layers; ++l) {
    const PlanLayer& L = s.layer[l];
    const int rows = per_block * L.m_mult;
    act = max(act, rows * a_stride(L.k_pad));
    if (l > 0) h = max(h, rows * L.k_pad);
    any_split |= L.encode == kEncSplit;
  }
  lay.a = 0;
  lay.b = round4(act);
  lay.h = lay.b + (any_split ? round4(act) : 0);
  lay.p = lay.h + round4(h);
  int used = lay.p + kCols * kThreads;
  lay.per_block = per_block;
  lay.floats = -1;
  if (4LL * used > kSmemLimit) return lay;
  for (int l = 0; l < s.n_layers; ++l) {
    const PlanLayer& L = s.layer[l];
    const int w = seg_rows(L.k_pad, L.n_chunks, tables) * round4(L.n);
    if (4LL * (used + w) <= kSmemLimit) {
      lay.wofs[l] = used;
      used += w;
    } else if (stage_all) {
      return lay;
    } else {
      lay.wofs[l] = -1;
    }
  }
  lay.floats = used;
  return lay;
}

// copy the host schedule (n_layers * kFields ints) into s and check it;
// false when it is malformed
bool read_schedule(const int* sched, int n_layers, int chunk_rows,
                   int x_cols, int n_max, PlanSchedule& s) {
  if (n_layers < 1 || n_layers > kMaxLayers || chunk_rows < 4 ||
      chunk_rows % 4 != 0 || n_max % 4 != 0)
    return false;
  s = PlanSchedule{};
  s.n_layers = n_layers;
  for (int l = 0; l < n_layers; ++l) {
    const int* f = sched + l * kFields;
    s.layer[l] = PlanLayer{f[0], f[1], f[2], f[3], f[4], f[5],
                           f[6], f[7], f[8], f[9], f[10]};
    const PlanLayer& L = s.layer[l];
    if (L.k_pad != L.n_chunks * chunk_rows || L.flatten < 1 ||
        (l == 0 && x_cols > L.k_pad) || round4(L.n) > n_max)
      return false;
  }
  return true;
}

// records per block at most per_block; fewer when the shared memory asks
// for it: every layer's segment staged first, then down to one record
// with as many layers staged as fit (floats < 0: nothing fits)
Layout choose_layout(const PlanSchedule& s, int per_block, bool tables) {
  Layout lay{};
  lay.floats = -1;
  for (int pb = per_block; pb >= 1 && lay.floats < 0; --pb)
    lay = layout(s, pb, true, tables);
  if (lay.floats < 0) lay = layout(s, 1, false, tables);
  return lay;
}

}  // namespace

// sched: n_layers * 11 host ints (row0, c0, k, k_pad, n, n_chunks, shift,
// flatten, m_mult, encode, handoff per layer), copied into a by-value
// struct.  deq, bias and enc may be null for a pure code chain.
// per_block: records per block at most (choose_layout).
extern "C" int analog_plan_launch(const float* x, const float* w_cat,
                                  const float* gain, const float* off,
                                  const float* deq, const float* bias,
                                  const float* enc, float* out, int batch,
                                  int x_cols, int n_max, const int* sched,
                                  int n_layers, int chunk_rows, int faithful,
                                  int per_block, void* stream) {
  // 16-byte rows: the bulk weight copies and the float4 loads of the
  // weights, gains and offsets
  const auto aligned = [](const void* p) {
    return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  PlanSchedule s;
  if (per_block < 1 || !aligned(w_cat) || !aligned(gain) || !aligned(off) ||
      !aligned(deq) || !aligned(bias) ||
      !read_schedule(sched, n_layers, chunk_rows, x_cols, n_max, s))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int l = 0; l < n_layers; ++l) {
    const PlanLayer& L = s.layer[l];
    if (L.encode != kEncCodes && enc == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    if (l + 1 < n_layers && L.handoff == kHandRelu &&
        (deq == nullptr || bias == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0) return 0;
  Layout lay = choose_layout(s, per_block, deq != nullptr);
  if (lay.floats < 0) return static_cast<int>(cudaErrorInvalidValue);
  lay.x_async = x_cols % 4 == 0 && aligned(x);
  const size_t smem = 4 * static_cast<size_t>(lay.floats);
  if (smem > 48 * 1024) {
    // allow the whole limit once per device: the attribute call costs
    // more host time than a batch-1 launch
    static bool allowed[kMaxDevices] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev >= kMaxDevices || !allowed[dev]) {
      e = cudaFuncSetAttribute(analog_plan_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemLimit);
      if (e != cudaSuccess) return static_cast<int>(e);
      if (dev < kMaxDevices) allowed[dev] = true;
    }
  }
  const int blocks = (batch + lay.per_block - 1) / lay.per_block;
  analog_plan_kernel<<<blocks, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      x, w_cat, gain, off, deq, bias, enc, out, batch, x_cols, n_max,
      chunk_rows, faithful, s, lay);
  return static_cast<int>(cudaGetLastError());
}

// The layout a launch with these arguments takes: out[0] the records per
// block, out[1 + l] 1 where layer l's segment is staged in shared memory
// and 0 where its weights are read in place.  tables: the chain has float
// hand-offs (deq and bias rows staged).
extern "C" int analog_plan_layout(const int* sched, int n_layers,
                                  int chunk_rows, int x_cols, int n_max,
                                  int tables, int per_block, int* out) {
  PlanSchedule s;
  if (per_block < 1 ||
      !read_schedule(sched, n_layers, chunk_rows, x_cols, n_max, s))
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout lay = choose_layout(s, per_block, tables != 0);
  if (lay.floats < 0) return static_cast<int>(cudaErrorInvalidValue);
  out[0] = lay.per_block;
  for (int l = 0; l < n_layers; ++l) out[1 + l] = lay.wofs[l] >= 0;
  return 0;
}

extern "C" const char* analog_plan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
