// One attention+MLP transformer block of an analog LM in ONE launch: the
// four analog layers (fused QKV, o, fused up|gate, down), each a chunked
// saturating analog VMM of float features encoded at the layer's baked
// LSB, and the digital glue between them.  Stages, each spread over the
// whole grid and separated by grid-wide barriers:
//   1. n1     = RMSNorm(x; ln1), and its codes
//   2. acc_qkv = VMM_0(codes(n1))
//   3. attn   = causal attention of RoPE(q), RoPE(k), v, where
//               [q k v] = acc_qkv * deq_0 + bias_0 (positions 0..seq-1),
//               and its codes
//   4. acc_o  = VMM_1(codes(attn))
//   5. res2   = x + (acc_o * deq_1 + bias_1);  n2 = RMSNorm(res2; ln2),
//               and its codes
//   6. acc_ug = VMM_2(codes(n2))
//   7. sw     = silu(gate) * up, [up gate] = acc_ug * deq_2 + bias_2, and
//               its codes
//   8. acc_dn = VMM_3(codes(sw))
//   9. out    = res2 + (acc_dn * deq_3 + bias_3)
// VMM_l(a): per chunk c of chunk_rows rows, v_c = (a_c @ w_c) * gain +
// off[c], rounded and clipped per chunk (faithful) or once at the end to
// C * [-128, 127] (fast); a "split" layer runs the codes of h and of -h
// as two passes against the same weights and subtracts them; codes(h) =
// clip(rint(h / scale), 0, 31).
//
// Replaces the TPU kernel repro/kernels/analog_plan.py::analog_plan_pallas
// (body _plan_kernel) for a schedule with the block hand-offs attn,
// res_ln, swiglu and res_out.
//
// Bound on Hopper: at phi4-mini width and 48 rows (4 x 12 prefill tokens)
// the split pairs do 19.3 GFLOP against 101 MB of int8 weight codes (403
// MB as fp32): the bytes of the codes and their tables bound it (0.031
// ms); the products, each counted once at the bf16 tensor-core peak, take
// 0.020 ms (0.288 ms at the fp32 CUDA-core rate).  Design:
// * One cooperative launch of as many 128-thread CTAs as fit on the card
//   at once, every stage spread over all of them, grid.sync() between
//   stages (at these shapes one row of the widest hand-off is 64 KiB: the
//   TPU kernel's grid over batch elements would leave most SMs idle).
// * Each VMM stage runs analog_split_tile.cuh's split_tile(), the CTA work
//   item of the split kernel: per layer the store's int8 codes rebuilt
//   into fp32 weights with one __fmul_rn per gain table - rank-1 (form
//   0), and a calibrated bake's per-(chunk, column) table too (form 2) -
//   or an fp32 w_eff for a store with a full gain map (form 1); three
//   exact bf16 pieces per weight on mma.sync; a cp.async ring; the
//   per-chunk ADC readout.
// * Encode once: the glue stage before a VMM writes the 5-bit codes of h
//   and of -h (the tile's fp32 code operands) once, with the same
//   rintf(__fdiv_rn(h, scale)) and clip as the plain version.
// * Split-K over chunk ranges (faithful mode): a VMM stage's work items
//   are (column tile, chunk range, row group), the ranges sized on the
//   host so that the items fill the grid once (split_plan's rule).  Each
//   item writes its integer partial totals pos - neg to its own slot of a
//   workspace; after the stage's grid.sync the consuming glue stage sums
//   the slots in ascending order as it reads them (integer totals add
//   exactly in any order) and writes the sum to the stage's acc region.
//   Fast mode sums floats before one rounding: one range per tile, walked
//   in ascending chunk order, its clip applied before the store to slot 0.
// The activations between stages live in a global scratch the wrapper
// allocates, one region per stage (L2-resident), so every stage can be
// checked on its own.  The gain/offset, dequant, RoPE and residual steps
// are __fmul_rn / __fadd_rn, never contracted, so on integer effective
// weights the VMM stages are bit-exact against the plain version.  Glue
// reductions (RMSNorm, softmax) and transcendentals (rsqrtf, expf) round
// unlike PyTorch's by an ulp or two; RoPE's cos/sin come from a table the
// wrapper builds with the model's own arithmetic.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "analog_split_tile.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace analog_split;

constexpr int kLayers = 4;
// per layer: c0, k, k_pad, n, n_chunks, split, form, n_blocks,
// block_end[4], chunks_per_cta, n_splits, vec
constexpr int kFields = 15;
// scratch regions, in BLOCK_STAGES order (kernels/analog_plan.py)
enum Region {
  kN1, kN1Pos, kN1Neg, kAccQkv, kAttn, kAttnPos, kAttnNeg, kAccO, kRes2,
  kN2, kN2Pos, kN2Neg, kAccUg, kSw, kSwPos, kSwNeg, kAccDn, kRegions
};
// the float input region of layer l's VMM (its two code regions follow)
__host__ __device__ constexpr int input_region(int l) {
  return l == 0 ? kN1 : l == 1 ? kAttn : l == 2 ? kN2 : kSw;
}

struct BlockArgs {
  const float* x;
  Params vmm[kLayers];  // each layer's split_tile operands
  int form[kLayers];
  int k[kLayers];       // logical input widths
  const float* deq;
  const float* bias;
  const float* enc;
  const float* ln;
  const float* rope;
  float* out;
  float* reg[kRegions];
  int m, n_max;
  int n_heads, n_kv_heads, head_dim, seq, d_ff;
  float eps, attn_scale;
};

__device__ __forceinline__ float encode5(float h, float scale) {
  return fminf(fmaxf(rintf(__fdiv_rn(h, scale)), 0.f), 31.f);
}

__device__ __forceinline__ float dequant(float acc, float deq, float bias) {
  return __fadd_rn(__fmul_rn(acc, deq), bias);
}

// the float feature v of column j of row r of layer l's input: written to
// its float region and, encoded, to the layer's two code regions
__device__ __forceinline__ void put_input(const BlockArgs& p, int l,
                                          long long r, int j, float v) {
  const int f = input_region(l);
  p.reg[f][r * p.k[l] + j] = v;
  const float s = p.enc[l];
  const long long o = r * p.vmm[l].k + j;
  p.reg[f + 1][o] = encode5(v, s);
  p.reg[f + 2][o] = p.vmm[l].neg ? encode5(-v, s) : 0.f;
}

// the accumulated ADC codes of (row r, column c) of layer l: the sum of
// the stage's partial-total slots in ascending order (written by other
// CTAs before the last grid.sync: read through L2)
__device__ __forceinline__ float vmm_total(const BlockArgs& p, int l,
                                           long long r, int c) {
  const Params& q = p.vmm[l];
  const long long mn = static_cast<long long>(q.m) * q.n;
  const float* s = q.part + r * q.n + c;
  float sum = 0.f;
  for (int sp = 0; sp < q.n_splits; ++sp)
    sum = __fadd_rn(sum, __ldcg(s + sp * mn));
  return sum;
}

// sum over the block; every thread gets the total
__device__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  __syncthreads();  // red may still be read by a previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.f;
  for (int i = 0; i < kThreads / 32; ++i) t += red[i];
  return t;
}

// row r of layer l's input = src * rsqrt(mean(src^2) + eps) * scale, the
// op order of models.layers.norm_apply
__device__ void rmsnorm_row(const BlockArgs& p, int l, long long r,
                            const float* src, const float* scale,
                            float* red) {
  const int d = p.k[l];
  float s = 0.f;
  for (int j = threadIdx.x; j < d; j += kThreads)
    s = __fadd_rn(s, __fmul_rn(src[j], src[j]));
  s = block_sum(s, red);
  const float inv =
      rsqrtf(__fadd_rn(__fdiv_rn(s, static_cast<float>(d)), p.eps));
  for (int j = threadIdx.x; j < d; j += kThreads)
    put_input(p, l, r, j, __fmul_rn(__fmul_rn(src[j], inv), scale[j]));
}

// One analog layer over the grid: each work item's partial totals to its
// workspace slot.  CG: the launch holds a layer in form 2 (a chunk_gain
// table), so the stage dispatches all three forms; without one it
// compiles only forms 0 and 1, and a launch of rank-1 stores runs no
// code (and no registers) of the third.
template <int MT, bool CG>
__device__ void vmm_stage(const BlockArgs& p, int l, unsigned char* smem) {
  const Params& q = p.vmm[l];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int col_tiles = (q.n + kBN - 1) / kBN;
  const int groups = (q.m + 8 * MT - 1) / (8 * MT);
  const int items = col_tiles * q.n_splits * groups;
  const long long mn = static_cast<long long>(q.m) * q.n;
  const float lo = -128.f * (q.k / q.chunk_rows);
  const float hi = 127.f * (q.k / q.chunk_rows);
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int tile = item % col_tiles;
    const int split = (item / col_tiles) % q.n_splits;
    const int group = item / (col_tiles * q.n_splits);
    const float* tot;
    if constexpr (CG)
      tot = p.form[l] == 0   ? split_tile<0, MT>(q, tile, split, group, smem)
            : p.form[l] == 2 ? split_tile<2, MT>(q, tile, split, group, smem)
                             : split_tile<1, MT>(q, tile, split, group, smem);
    else
      tot = p.form[l] == 0 ? split_tile<0, MT>(q, tile, split, group, smem)
                           : split_tile<1, MT>(q, tile, split, group, smem);
    float* slot = q.part + split * mn;
    const int row0 = group * 8 * MT;
    const int wcol = tile * kBN + warp * 32;
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row0 + 8 * i + g, c = wcol + 8 * t + 4 * h + j;
          if (r >= q.m || c >= q.n) continue;
          float y;
          if (q.faithful) {
            y = tot[tot_index(i, j, h, 2) * kThreads];
          } else {
            const int e = tot_index(i, j, h, 4);
            y = __fsub_rn(adc_clip(tot[e * kThreads], lo, hi),
                          adc_clip(tot[(e + 2) * kThreads], lo, hi));
          }
          slot[static_cast<long long>(r) * q.n + c] = y;
        }
  }
}

// one (batch element, query head) per work item: dequant, RoPE, causal
// softmax attention over the seq positions, written to the attn regions
__device__ void attention_stage(const BlockArgs& p, float* smem) {
  const int dh = p.head_dim;
  const int half = dh / 2;
  const int S = p.seq;
  const int G = p.n_heads / p.n_kv_heads;
  const int nq = p.n_heads * dh;
  const int nkv = p.n_kv_heads * dh;
  const int nqkv = p.vmm[0].n;
  float* acc = p.reg[kAccQkv];
  float* q = smem;
  float* k = q + S * dh;
  float* v = k + S * dh;
  float* pr = v + S * dh;
  const float* cosb = p.rope;
  const float* sinb = p.rope + S * half;
  const int items = (p.m / S) * p.n_heads;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int b = item / p.n_heads;
    const int h = item % p.n_heads;
    const int kvh = h / G;
    // the first query head of a group also stores its k and v columns
    const int n_store = h % G == 0 ? 3 : 1;
    __syncthreads();  // the previous item (or stage) is done with smem
    for (int e = threadIdx.x; e < S * half; e += kThreads) {
      const int s = e / half;
      const int d = e - s * half;
      const long long row = b * S + s;
      const float c = cosb[s * half + d];
      const float sn = sinb[s * half + d];
      const int cols[3] = {h * dh + d, nq + kvh * dh + d,
                           nq + nkv + kvh * dh + d};
      float* dst[3] = {q, k, v};
#pragma unroll
      for (int t = 0; t < 3; ++t) {
        const int c1 = cols[t];
        const int c2 = c1 + half;
        const float a1 = vmm_total(p, 0, row, c1);
        const float a2 = vmm_total(p, 0, row, c2);
        if (t < n_store) {
          acc[row * nqkv + c1] = a1;
          acc[row * nqkv + c2] = a2;
        }
        const float x1 = dequant(a1, p.deq[c1], p.bias[c1]);
        const float x2 = dequant(a2, p.deq[c2], p.bias[c2]);
        if (t < 2) {  // RoPE on q and k
          dst[t][s * dh + d] = __fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, sn));
          dst[t][s * dh + d + half] =
              __fadd_rn(__fmul_rn(x1, sn), __fmul_rn(x2, c));
        } else {
          dst[t][s * dh + d] = x1;
          dst[t][s * dh + d + half] = x2;
        }
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < S * S; e += kThreads) {
      const int i = e / S;
      const int j = e - i * S;
      float sc = -1e30f;  // masked: models.attention.NEG_INF
      if (j <= i) {
        float a = 0.f;
        for (int d = 0; d < dh; ++d) a = fmaf(q[i * dh + d], k[j * dh + d], a);
        sc = __fmul_rn(a, p.attn_scale);
      }
      pr[e] = sc;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < S; i += kThreads) {
      float mx = pr[i * S];  // j = 0 is never masked
      for (int j = 1; j < S; ++j) mx = fmaxf(mx, pr[i * S + j]);
      float sum = 0.f;
      for (int j = 0; j < S; ++j) {
        const float ex = expf(__fsub_rn(pr[i * S + j], mx));
        pr[i * S + j] = ex;
        sum = __fadd_rn(sum, ex);
      }
      for (int j = 0; j < S; ++j) pr[i * S + j] = __fdiv_rn(pr[i * S + j], sum);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < S * dh; e += kThreads) {
      const int i = e / dh;
      const int d = e - i * dh;
      float a = 0.f;
      for (int j = 0; j < S; ++j) a = fmaf(pr[i * S + j], v[j * dh + d], a);
      put_input(p, 1, b * S + i, h * dh + d, a);
    }
  }
}

template <int MT, bool CG>
__global__ void __launch_bounds__(kThreads, MT == 1 ? 4 : MT == 2 ? 3 : 2)
analog_plan_block_kernel(const __grid_constant__ BlockArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* fsmem = reinterpret_cast<float*>(smem);
  cg::grid_group grid = cg::this_grid();
  const int d = p.k[0];
  const int dff = p.d_ff;
  const int nm = p.n_max;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first = blockIdx.x * static_cast<long long>(kThreads) +
                          threadIdx.x;

  // the chunk padding of every code region: columns k..k_pad read as 0
  for (int l = 0; l < kLayers; ++l) {
    const int pad = p.vmm[l].k - p.k[l];
    for (long long e = first; e < static_cast<long long>(p.m) * pad;
         e += stride) {
      const long long o = (e / pad) * p.vmm[l].k + p.k[l] + e % pad;
      p.reg[input_region(l) + 1][o] = 0.f;
      p.reg[input_region(l) + 2][o] = 0.f;
    }
  }
  for (int l = 0; l < kLayers; ++l) {
    // the glue stage that feeds layer l
    if (l == 0) {  // RMSNorm(ln1) of the residual stream
      for (int r = blockIdx.x; r < p.m; r += gridDim.x)
        rmsnorm_row(p, 0, r, p.x + static_cast<long long>(r) * d, p.ln,
                    fsmem);
    } else if (l == 1) {  // dequant + RoPE + causal attention
      attention_stage(p, fsmem);
    } else if (l == 2) {  // residual add + RMSNorm(ln2)
      for (int r = blockIdx.x; r < p.m; r += gridDim.x) {
        const long long o = static_cast<long long>(r) * d;
        for (int j = threadIdx.x; j < d; j += kThreads) {
          const float a = vmm_total(p, 1, r, j);
          p.reg[kAccO][o + j] = a;
          p.reg[kRes2][o + j] =
              __fadd_rn(p.x[o + j], dequant(a, p.deq[nm + j], p.bias[nm + j]));
        }
        // each thread reads back only the elements it wrote
        rmsnorm_row(p, 2, r, p.reg[kRes2] + o, p.ln + nm, fsmem);
      }
    } else {  // SwiGLU: silu(gate) * up, silu(g) = g / (1 + exp(-g))
      for (long long e = first; e < static_cast<long long>(p.m) * dff;
           e += stride) {
        const long long r = e / dff;
        const int j = static_cast<int>(e - r * dff);
        const float au = vmm_total(p, 2, r, j);
        const float ag = vmm_total(p, 2, r, dff + j);
        p.reg[kAccUg][r * 2 * dff + j] = au;
        p.reg[kAccUg][r * 2 * dff + dff + j] = ag;
        const float up = dequant(au, p.deq[2 * nm + j], p.bias[2 * nm + j]);
        const float g = dequant(ag, p.deq[2 * nm + dff + j],
                                p.bias[2 * nm + dff + j]);
        const float silu = __fdiv_rn(g, __fadd_rn(1.f, expf(-g)));
        put_input(p, 3, r, j, __fmul_rn(silu, up));
      }
    }
    grid.sync();
    vmm_stage<MT, CG>(p, l, smem);
    grid.sync();
  }
  // residual output
  for (long long e = first; e < static_cast<long long>(p.m) * d; e += stride) {
    const long long r = e / d;
    const int j = static_cast<int>(e - r * d);
    const float a = vmm_total(p, 3, r, j);
    p.reg[kAccDn][e] = a;
    p.out[e] = __fadd_rn(p.reg[kRes2][e],
                         dequant(a, p.deq[3 * nm + j], p.bias[3 * nm + j]));
  }
}

// dynamic shared memory of one launch: the largest VMM tile of the forms
// it runs, or the attention stage's q, k, v and scores
int smem_for(int mt, int faithful, int forms, int seq, int head_dim) {
  int bytes = 4 * (kThreads / 32);
  for (int form = 0; form < 3; ++form)
    if (forms & (1 << form)) {
      const int b = smem_bytes(form, mt, faithful);
      if (b > bytes) bytes = b;
    }
  const long long attn = 4LL * (3LL * seq * head_dim + 1LL * seq * seq);
  return attn > bytes ? static_cast<int>(attn) : bytes;
}

template <int MT>
const void* kernel_fn(bool cg) {
  return cg ? reinterpret_cast<const void*>(analog_plan_block_kernel<MT, true>)
            : reinterpret_cast<const void*>(analog_plan_block_kernel<MT, false>);
}

// the kernel of a launch geometry: forms bit 2 set when a layer has a
// chunk_gain table
const void* kernel_for(int mt, int forms) {
  const bool cg = (forms & 4) != 0;
  switch (mt) {
    case 1: return kernel_fn<1>(cg);
    case 2: return kernel_fn<2>(cg);
    case 3: return kernel_fn<3>(cg);
    case 6: return kernel_fn<6>(cg);
    default: return nullptr;
  }
}

// the cooperative grid of one launch geometry: SMs x resident CTAs
int grid_size(int mt, int faithful, int forms, int seq, int head_dim,
              int* grid) {
  const void* fn = kernel_for(mt, forms);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = smem_for(mt, faithful, forms, seq, head_dim);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(e);
  if ((e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) !=
      cudaSuccess)
    return static_cast<int>(e);
  if (!coop) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return static_cast<int>(e);
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, fn, kThreads, smem)) != cudaSuccess)
    return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  *grid = per_sm * sms;
  return 0;
}

}  // namespace

// The cooperative grid a launch of this geometry uses (forms: bit f set
// when a layer reads its weights in form f: 0 int8 codes, 1 fp32 w_eff,
// 2 int8 codes with a chunk_gain table); the
// wrapper sizes the chunk ranges of each VMM stage from it.
extern "C" int analog_plan_block_grid(int mt, int faithful, int forms,
                                      int seq, int head_dim, int* grid) {
  return grid_size(mt, faithful, forms, seq, head_dim, grid);
}

// wptrs: 4 x 4 device pointers (host array): per layer the weights (int8
// codes for forms 0 and 2, fp32 w_eff for form 1), col_gain and row_gain
// (forms 0 and 2, each may be null) and chunk_gain (form 2 only).  sched: 4 x 15 host ints per layer: c0, k, k_pad,
// n, n_chunks, split, form, n_blocks, block_end[4], chunks_per_cta,
// n_splits, vec.  regions: 17 device pointers (host array), the scratch
// regions in BLOCK_STAGES order.  work: the partial-total slots, at least
// n_splits * m * n floats for every layer.  mt: m16 tiles per CTA (1, 2,
// 3 or 6).  The grid size the launch used is written to *grid_out.
extern "C" int analog_plan_block_launch(
    const float* x, const void* const* wptrs, const float* gain,
    const float* off, const float* deq, const float* bias, const float* enc,
    const float* ln, const float* rope, float* out, float* const* regions,
    float* work, const int* sched, int m, int n_max, int chunk_rows,
    int faithful, int mt, int n_heads, int n_kv_heads, int head_dim, int seq,
    int d_ff, float eps, float attn_scale, int* grid_out, void* stream) {
  if (m <= 0 || seq <= 0 || m % seq != 0 || chunk_rows <= 0 ||
      chunk_rows % kBK != 0 || n_kv_heads <= 0 || n_heads % n_kv_heads != 0 ||
      head_dim % 2 != 0 || kernel_for(mt, 0) == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  BlockArgs p{};
  p.x = x;
  int forms = 0;
  for (int l = 0; l < kLayers; ++l) {
    const int* f = sched + l * kFields;
    const int c0 = f[0], k_pad = f[2], n = f[3], n_chunks = f[4];
    const int n_blocks = f[7], cps = f[12], n_splits = f[13];
    if (k_pad != n_chunks * chunk_rows || n_chunks < 1 || f[1] > k_pad ||
        n_blocks < 1 || n_blocks > kMaxBlocks || cps < 1 ||
        (n_chunks + cps - 1) / cps != n_splits ||
        (n_splits > 1 && !faithful) || f[6] < 0 || f[6] > 2 ||
        (f[6] == 2) != (wptrs[4 * l + 3] != nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
    const void* const* w = wptrs + 4 * l;
    Params& q = p.vmm[l];
    q.ap = regions[input_region(l) + 1];
    q.an = regions[input_region(l) + 2];
    q.w = w[0];
    q.col_gain = static_cast<const float*>(w[1]);
    q.row_gain = static_cast<const float*>(w[2]);
    q.chunk_gain = static_cast<const float*>(w[3]);
    q.gain = gain + static_cast<long long>(l) * n_max;
    q.off = off + static_cast<long long>(c0) * n_max;
    q.out = nullptr;
    q.part = work;
    q.counters = nullptr;
    q.m = m;
    q.k = k_pad;
    q.n = n;
    q.chunk_rows = chunk_rows;
    q.chunks_per_cta = cps;
    q.n_splits = n_splits;
    q.n_blocks = n_blocks;
    for (int b = 0; b < kMaxBlocks; ++b)
      q.block_end[b] = b < n_blocks ? f[8 + b] : n;
    q.faithful = faithful;
    q.shift = -1;
    q.vec = f[14];
    q.off_stride = n_max;
    q.neg = f[5];
    p.form[l] = f[6];
    p.k[l] = f[1];
    forms |= 1 << f[6];
  }
  p.deq = deq;
  p.bias = bias;
  p.enc = enc;
  p.ln = ln;
  p.rope = rope;
  p.out = out;
  for (int r = 0; r < kRegions; ++r) p.reg[r] = regions[r];
  p.m = m;
  p.n_max = n_max;
  p.n_heads = n_heads;
  p.n_kv_heads = n_kv_heads;
  p.head_dim = head_dim;
  p.seq = seq;
  p.d_ff = d_ff;
  p.eps = eps;
  p.attn_scale = attn_scale;
  int grid = 0;
  if (const int e = grid_size(mt, faithful, forms, seq, head_dim, &grid))
    return e;
  *grid_out = grid;
  void* args[] = {&p};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      kernel_for(mt, forms), dim3(grid), dim3(kThreads), args,
      smem_for(mt, faithful, forms, seq, head_dim),
      static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* analog_plan_block_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
