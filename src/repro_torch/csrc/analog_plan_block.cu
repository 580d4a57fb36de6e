// One attention+MLP transformer block of an analog LM in ONE launch: the
// four analog layers (fused QKV, o, fused up|gate, down), each a chunked
// saturating analog VMM of float features encoded at the layer's baked
// LSB, and the digital glue between them.  Stages, each spread over the
// whole grid and separated by grid-wide barriers:
//   1. n1     = RMSNorm(x; ln1)
//   2. acc_qkv = VMM_0(encode(n1))
//   3. attn   = causal attention of RoPE(q), RoPE(k), v, where
//               [q k v] = acc_qkv * deq_0 + bias_0 (positions 0..seq-1)
//   4. acc_o  = VMM_1(encode(attn))
//   5. res2   = x + (acc_o * deq_1 + bias_1);  n2 = RMSNorm(res2; ln2)
//   6. acc_ug = VMM_2(encode(n2))
//   7. sw     = silu(gate) * up, [up gate] = acc_ug * deq_2 + bias_2
//   8. acc_dn = VMM_3(encode(sw))
//   9. out    = res2 + (acc_dn * deq_3 + bias_3)
// VMM_l(a): per chunk c of chunk_rows rows, v_c = (a_c @ w_c) * gain +
// off[c], rounded and clipped per chunk (faithful) or once at the end to
// C * [-128, 127] (fast); a "split" layer runs the codes of h and of -h
// as two passes against the same weights and subtracts them; encode(h) =
// clip(rint(h / scale), 0, 31).
//
// Replaces the TPU kernel repro/kernels/analog_plan.py::analog_plan_pallas
// (body _plan_kernel) for a schedule with the block hand-offs attn,
// res_ln, swiglu and res_out.  Bound on Hopper: at phi4-mini width and 48
// rows (4 x 12 prefill tokens) the split pair does 19.3 GFLOP of fp32 fma
// against 403 MB of fp32 weights, so the fp32 operations bound it (0.288
// ms against 0.120 ms for the bytes).  Design: the TPU kernel keeps a
// batch element's rows and the residual stream in VMEM and runs the grid
// over batch elements; here one row of the widest hand-off is 64 KiB and
// 4 batch elements would leave 128 of 132 SMs idle, so the kernel is one
// cooperative launch of as many blocks as fit on the card at once, every
// stage spread over all of them, with grid.sync() between stages.  The
// activations between stages live in a global scratch the wrapper
// allocates, one region per stage (9.2 MB at these shapes, L2-resident),
// so every stage can be checked on its own.  A VMM stage walks output
// tiles of up to 64 rows x 64 columns; each tile walks all chunks (blocks
// share nothing), staging 32-row slices of both passes' codes - encoded
// as they are loaded - and of the weights in shared memory, each weight
// element feeding both passes.  The weights are read in place, one
// pointer per layer (no column-padded copy).  Each chunk's dot is a
// sequential fmaf chain in ascending row order, as in analog_mvm_split.cu,
// and the gain/offset, dequant, RoPE and residual steps are __fmul_rn /
// __fadd_rn, never contracted, so on integer effective weights the VMM
// stages are bit-exact against the plain version.  Glue reductions
// (RMSNorm, softmax) and transcendentals (rsqrtf, expf) round unlike
// PyTorch's by an ulp or two; RoPE's cos/sin come from a table the
// wrapper builds with the model's own arithmetic.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kTN = kBN / 16;
constexpr int kWLoads = kBK * kBN / kThreads;
constexpr int kLayers = 4;
constexpr int kFields = 6;  // c0, k, k_pad, n, n_chunks, split

struct BlockLayer {
  int c0, k, k_pad, n, n_chunks, split;
};

struct BlockArgs {
  const float* x;
  const float* w[kLayers];
  const float* gain;
  const float* off;
  const float* deq;
  const float* bias;
  const float* enc;
  const float* ln;
  const float* rope;
  float* out;
  float* n1;
  float* acc_qkv;
  float* attn;
  float* acc_o;
  float* res2;
  float* n2;
  float* acc_ug;
  float* sw;
  float* acc_dn;
  BlockLayer layer[kLayers];
  int m, n_max, chunk_rows, faithful;
  int n_heads, n_kv_heads, head_dim, seq, d_ff;
  float eps, attn_scale;
};

__device__ __forceinline__ float adc_clip(float v, float lo, float hi) {
  return fminf(fmaxf(rintf(v), lo), hi);
}

__device__ __forceinline__ float encode5(float h, float scale) {
  return fminf(fmaxf(rintf(__fdiv_rn(h, scale)), 0.f), 31.f);
}

__device__ __forceinline__ float dequant(float acc, float deq, float bias) {
  return __fadd_rn(__fmul_rn(acc, deq), bias);
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

// dst[r] = src[r] * rsqrt(mean(src[r]^2) + eps) * scale, the op order of
// models.layers.norm_apply
__device__ void rmsnorm_row(const float* src, int d, const float* scale,
                            float eps, float* dst, float* red) {
  float s = 0.f;
  for (int j = threadIdx.x; j < d; j += kThreads)
    s = __fadd_rn(s, __fmul_rn(src[j], src[j]));
  s = block_sum(s, red);
  const float inv =
      rsqrtf(__fadd_rn(__fdiv_rn(s, static_cast<float>(d)), eps));
  for (int j = threadIdx.x; j < d; j += kThreads)
    dst[j] = __fmul_rn(__fmul_rn(src[j], inv), scale[j]);
}

// One analog layer over the grid: out[m, n] = accumulated ADC codes of
// the layer's encoded input in[m, k] (row stride k).
template <int TM, bool SPLIT>
__device__ void vmm_stage(const BlockArgs& p, int l, const float* in,
                          float* acc_out, float* smem) {
  constexpr int BM = 16 * TM;
  constexpr int kALoads = BM * kBK / kThreads;
  const BlockLayer L = p.layer[l];
  float(*as_p)[BM + 1] = reinterpret_cast<float(*)[BM + 1]>(smem);
  float(*as_n)[BM + 1] =
      reinterpret_cast<float(*)[BM + 1]>(smem + kBK * (BM + 1));
  float(*ws)[kBN] =
      reinterpret_cast<float(*)[kBN]>(smem + 2 * kBK * (BM + 1));
  const float* __restrict__ w = p.w[l];
  const float scale = p.enc[l];
  const float* gain = p.gain + l * p.n_max;
  const float* off = p.off + static_cast<long long>(L.c0) * p.n_max;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int col_tiles = (L.n + kBN - 1) / kBN;
  const int row_tiles = (p.m + BM - 1) / BM;
  const int slices_per_chunk = p.chunk_rows / kBK;
  const int n_slices = L.k_pad / kBK;
  const float lo = -128.f * L.n_chunks;
  const float hi = 127.f * L.n_chunks;

  for (int t = blockIdx.x; t < col_tiles * row_tiles; t += gridDim.x) {
    const int col0 = (t % col_tiles) * kBN;
    const int row0 = (t / col_tiles) * BM;
    float g[kTN];
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int col = col0 + tx + 16 * j;
      g[j] = col < L.n ? gain[col] : 0.f;
    }
    float rp[kALoads], rn[kALoads], rw[kWLoads];
    auto fetch = [&](int s) {
      const int k0 = s * kBK;
#pragma unroll
      for (int q = 0; q < kALoads; ++q) {
        const int e = threadIdx.x + q * kThreads;
        const int r = e / kBK;
        const int kk = k0 + e - r * kBK;
        const int gr = row0 + r;
        const float hv = (gr < p.m && kk < L.k)
                             ? in[static_cast<long long>(gr) * L.k + kk]
                             : 0.f;
        rp[q] = encode5(hv, scale);
        rn[q] = SPLIT ? encode5(-hv, scale) : 0.f;
      }
#pragma unroll
      for (int q = 0; q < kWLoads; ++q) {
        const int e = threadIdx.x + q * kThreads;
        const int kk = e / kBN;
        const int gc = col0 + e - kk * kBN;
        rw[q] = gc < L.n ? w[static_cast<long long>(k0 + kk) * L.n + gc]
                         : 0.f;
      }
    };

    float accp[TM][kTN], accn[TM][kTN], totp[TM][kTN], totn[TM][kTN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        accp[i][j] = accn[i][j] = 0.f;
        totp[i][j] = totn[i][j] = 0.f;
      }

    if (n_slices > 0) fetch(0);
    for (int s = 0; s < n_slices; ++s) {
      __syncthreads();  // the previous slice (or stage) is consumed
#pragma unroll
      for (int q = 0; q < kALoads; ++q) {
        const int e = threadIdx.x + q * kThreads;
        const int r = e / kBK;
        const int kk = e - r * kBK;
        as_p[kk][r] = rp[q];
        if (SPLIT) as_n[kk][r] = rn[q];
      }
#pragma unroll
      for (int q = 0; q < kWLoads; ++q) {
        const int e = threadIdx.x + q * kThreads;
        ws[e / kBN][e % kBN] = rw[q];
      }
      __syncthreads();
      if (s + 1 < n_slices) fetch(s + 1);  // in flight during the dots

#pragma unroll 8
      for (int kk = 0; kk < kBK; ++kk) {
        float wv[kTN];
#pragma unroll
        for (int j = 0; j < kTN; ++j) wv[j] = ws[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float pv = as_p[kk][ty + 16 * i];
#pragma unroll
          for (int j = 0; j < kTN; ++j) accp[i][j] = fmaf(pv, wv[j], accp[i][j]);
          if (SPLIT) {
            const float nv = as_n[kk][ty + 16 * i];
#pragma unroll
            for (int j = 0; j < kTN; ++j)
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
              col < L.n ? off[static_cast<long long>(c) * p.n_max + col] : 0.f;
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            float vp = __fadd_rn(__fmul_rn(accp[i][j], g[j]), o);
            if (p.faithful) vp = adc_clip(vp, -128.f, 127.f);
            totp[i][j] = __fadd_rn(totp[i][j], vp);
            accp[i][j] = 0.f;
            if (SPLIT) {
              float vn = __fadd_rn(__fmul_rn(accn[i][j], g[j]), o);
              if (p.faithful) vn = adc_clip(vn, -128.f, 127.f);
              totn[i][j] = __fadd_rn(totn[i][j], vn);
              accn[i][j] = 0.f;
            }
          }
        }
      }
    }

#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = row0 + ty + 16 * i;
      if (row >= p.m) continue;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int col = col0 + tx + 16 * j;
        if (col >= L.n) continue;
        float yp = totp[i][j];
        float yn = totn[i][j];
        if (!p.faithful) {
          yp = adc_clip(yp, lo, hi);
          yn = adc_clip(yn, lo, hi);
        }
        acc_out[static_cast<long long>(row) * L.n + col] =
            SPLIT ? __fsub_rn(yp, yn) : yp;
      }
    }
  }
}

template <int TM>
__device__ void vmm(const BlockArgs& p, int l, const float* in, float* out,
                    float* smem) {
  if (p.layer[l].split)
    vmm_stage<TM, true>(p, l, in, out, smem);
  else
    vmm_stage<TM, false>(p, l, in, out, smem);
}

// one (batch element, query head) per work item: dequant, RoPE, causal
// softmax attention over the seq positions, written to p.attn
__device__ void attention_stage(const BlockArgs& p, float* smem) {
  const int dh = p.head_dim;
  const int half = dh / 2;
  const int S = p.seq;
  const int G = p.n_heads / p.n_kv_heads;
  const int nq = p.n_heads * dh;
  const int nkv = p.n_kv_heads * dh;
  const int nqkv = p.layer[0].n;
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
    __syncthreads();  // the previous item (or stage) is done with smem
    for (int e = threadIdx.x; e < S * half; e += kThreads) {
      const int s = e / half;
      const int d = e - s * half;
      const float* row = p.acc_qkv + static_cast<long long>(b * S + s) * nqkv;
      const float c = cosb[s * half + d];
      const float sn = sinb[s * half + d];
      const int cols[3] = {h * dh + d, nq + kvh * dh + d,
                           nq + nkv + kvh * dh + d};
      float* dst[3] = {q, k, v};
#pragma unroll
      for (int t = 0; t < 3; ++t) {
        const int c1 = cols[t];
        const int c2 = c1 + half;
        const float x1 = dequant(row[c1], p.deq[c1], p.bias[c1]);
        const float x2 = dequant(row[c2], p.deq[c2], p.bias[c2]);
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
        float acc = 0.f;
        for (int d = 0; d < dh; ++d) acc = fmaf(q[i * dh + d], k[j * dh + d], acc);
        sc = __fmul_rn(acc, p.attn_scale);
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
      float acc = 0.f;
      for (int j = 0; j < S; ++j) acc = fmaf(pr[i * S + j], v[j * dh + d], acc);
      p.attn[static_cast<long long>(b * S + i) * nq + h * dh + d] = acc;
    }
  }
}

template <int TM>
__global__ void __launch_bounds__(kThreads)
analog_plan_block_kernel(BlockArgs p) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  const int d = p.layer[0].k;
  const int dff = p.d_ff;
  const int nm = p.n_max;

  // 1. RMSNorm(ln1) of the residual stream
  for (int r = blockIdx.x; r < p.m; r += gridDim.x)
    rmsnorm_row(p.x + static_cast<long long>(r) * d, d, p.ln, p.eps,
                p.n1 + static_cast<long long>(r) * d, smem);
  grid.sync();
  // 2. fused QKV
  vmm<TM>(p, 0, p.n1, p.acc_qkv, smem);
  grid.sync();
  // 3. dequant + RoPE + causal attention
  attention_stage(p, smem);
  grid.sync();
  // 4. o
  vmm<TM>(p, 1, p.attn, p.acc_o, smem);
  grid.sync();
  // 5. residual add + RMSNorm(ln2)
  for (int r = blockIdx.x; r < p.m; r += gridDim.x) {
    const long long o = static_cast<long long>(r) * d;
    for (int j = threadIdx.x; j < d; j += kThreads)
      p.res2[o + j] = __fadd_rn(
          p.x[o + j], dequant(p.acc_o[o + j], p.deq[nm + j], p.bias[nm + j]));
    // each thread reads back only the elements it wrote
    rmsnorm_row(p.res2 + o, d, p.ln + nm, p.eps, p.n2 + o, smem);
  }
  grid.sync();
  // 6. fused up|gate
  vmm<TM>(p, 2, p.n2, p.acc_ug, smem);
  grid.sync();
  // 7. SwiGLU: silu(gate) * up, silu(g) = g / (1 + exp(-g))
  for (long long e = blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       e < static_cast<long long>(p.m) * dff;
       e += static_cast<long long>(gridDim.x) * kThreads) {
    const long long r = e / dff;
    const int j = static_cast<int>(e - r * dff);
    const float* row = p.acc_ug + r * 2 * dff;
    const float up = dequant(row[j], p.deq[2 * nm + j], p.bias[2 * nm + j]);
    const float g = dequant(row[dff + j], p.deq[2 * nm + dff + j],
                            p.bias[2 * nm + dff + j]);
    const float silu = __fdiv_rn(g, __fadd_rn(1.f, expf(-g)));
    p.sw[e] = __fmul_rn(silu, up);
  }
  grid.sync();
  // 8. down
  vmm<TM>(p, 3, p.sw, p.acc_dn, smem);
  grid.sync();
  // 9. residual output
  for (long long e = blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       e < static_cast<long long>(p.m) * d;
       e += static_cast<long long>(gridDim.x) * kThreads) {
    const int j = static_cast<int>(e % d);
    p.out[e] = __fadd_rn(
        p.res2[e], dequant(p.acc_dn[e], p.deq[3 * nm + j], p.bias[3 * nm + j]));
  }
}

template <int TM>
int launch_tm(BlockArgs& p, int* grid_out, cudaStream_t stream) {
  constexpr int BM = 16 * TM;
  const size_t vmm_floats = 2 * kBK * (BM + 1) + kBK * kBN;
  const size_t attn_floats = 3 * static_cast<size_t>(p.seq) * p.head_dim +
                             static_cast<size_t>(p.seq) * p.seq;
  size_t smem = vmm_floats > attn_floats ? vmm_floats : attn_floats;
  if (smem < kThreads / 32) smem = kThreads / 32;
  smem *= sizeof(float);
  const void* fn = reinterpret_cast<const void*>(analog_plan_block_kernel<TM>);
  cudaError_t e;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
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
  const int grid = per_sm * sms;
  *grid_out = grid;
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(kThreads), args, smem,
                                  stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// w: 4 device pointers (host array); sched: 4 x 6 host ints (c0, k,
// k_pad, n, n_chunks, split per layer); scratch: the stage regions back
// to back in execution order (n1, acc_qkv, attn, acc_o, res2, n2, acc_ug,
// sw, acc_dn); rope: [2, seq, head_dim / 2] cos then sin.  The grid size
// the launch used is written to *grid_out.
extern "C" int analog_plan_block_launch(
    const float* x, const float* const* w, const float* gain,
    const float* off, const float* deq, const float* bias, const float* enc,
    const float* ln, const float* rope, float* out, float* scratch,
    const int* sched, int m, int n_max, int chunk_rows, int faithful,
    int n_heads, int n_kv_heads, int head_dim, int seq, int d_ff, float eps,
    float attn_scale, int* grid_out, void* stream) {
  if (m <= 0 || seq <= 0 || m % seq != 0 || chunk_rows <= 0 ||
      chunk_rows % kBK != 0 || n_kv_heads <= 0 || n_heads % n_kv_heads != 0 ||
      head_dim % 2 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  BlockArgs p{};
  p.x = x;
  for (int l = 0; l < kLayers; ++l) {
    p.w[l] = w[l];
    const int* f = sched + l * kFields;
    p.layer[l] = BlockLayer{f[0], f[1], f[2], f[3], f[4], f[5]};
    if (p.layer[l].k_pad != p.layer[l].n_chunks * chunk_rows)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  p.gain = gain;
  p.off = off;
  p.deq = deq;
  p.bias = bias;
  p.enc = enc;
  p.ln = ln;
  p.rope = rope;
  p.out = out;
  const long long rows = m;
  float* s = scratch;
  p.n1 = s;      s += rows * p.layer[0].k;
  p.acc_qkv = s; s += rows * p.layer[0].n;
  p.attn = s;    s += rows * p.layer[1].k;
  p.acc_o = s;   s += rows * p.layer[1].n;
  p.res2 = s;    s += rows * p.layer[1].n;
  p.n2 = s;      s += rows * p.layer[2].k;
  p.acc_ug = s;  s += rows * p.layer[2].n;
  p.sw = s;      s += rows * p.layer[3].k;
  p.acc_dn = s;
  p.m = m;
  p.n_max = n_max;
  p.chunk_rows = chunk_rows;
  p.faithful = faithful;
  p.n_heads = n_heads;
  p.n_kv_heads = n_kv_heads;
  p.head_dim = head_dim;
  p.seq = seq;
  p.d_ff = d_ff;
  p.eps = eps;
  p.attn_scale = attn_scale;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m <= 16) return launch_tm<1>(p, grid_out, st);
  if (m <= 32) return launch_tm<2>(p, grid_out, st);
  if (m <= 48) return launch_tm<3>(p, grid_out, st);
  return launch_tm<4>(p, grid_out, st);
}

extern "C" const char* analog_plan_block_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
