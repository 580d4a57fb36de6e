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
// analog_mvm_split_pallas (body _split_kernel).
//
// Bound on Hopper.  On the language-model path M is the batch (decode) or
// batch x prompt length (prefill), a few to a few dozen rows, against
// K x N weights of up to 3072 x 200064: the weights dominate the bytes.
// Decode is bytes-bound; prefill, at fp32 on the CUDA cores, was
// operations-bound.  The design attacks both.  The CTA work item - the
// int8 code operand rebuilt into fp32 weights, three exact bf16 pieces per
// weight on mma.sync with both passes stacked in one m16 tile, the
// cp.async ring and the per-chunk ADC readout - is analog_split_tile.cuh's
// split_tile(), shared with the transformer-block kernel.  A CTA holds 1,
// 2, 3 or 6 m16 tiles (8 to 48 activation rows, chosen from M by the
// wrapper), so a 4 x 12 prefill rebuilds each weight once.  With integer
// w_eff the kernel is bit-exact against the plain version; with float
// gains only the order of the fp32 sums differs (within 1 LSB at an ADC
// rounding tie).  This file adds:
//
// * Split-K over chunks (faithful mode).  After the ADC readout each
//   chunk adds an integer in [-255, 255] to pos - neg, so partial totals
//   over any range of chunks combine exactly in any order.  The grid is
//   (column tiles, chunk ranges, row groups), the ranges sized by the
//   wrapper so that one wave of resident CTAs covers the launch (this
//   file's occupancy query).  Each CTA of a split tile stores its partial
//   totals to its own slot of a workspace, then counts itself in at the
//   tile's counter (after a __threadfence); the last to arrive sums the
//   slots and runs the epilogue.  One launch per call.  Fast mode sums
//   floats before its single rounding, so one CTA walks all of K in
//   ascending chunk order, as the plain version's arithmetic needs.
// * A stack axis.  One launch runs E stacked matrices, each against its
//   own activations, cut the same way.  An MoE expert stack (the expert
//   axis) shares one table-free operand form; the members of an RWKV
//   r/k/v/g batch_concat group (the member axis) each read their own
//   rank-1 gains, chunk offsets and measured chunk gains, so one launch
//   gives each member what its own 2-D launch would, bit for bit.
#include <cuda_runtime.h>
#include <cstdint>

#include "analog_split_tile.cuh"

namespace {

using namespace analog_split;

constexpr int kMaxDevices = 64;

// FORM 0: int8 codes + rank-1 gain tables; FORM 2: the same + chunk_gain;
// FORM 1: fp32 w_eff.
// MT: m16 tiles per CTA, each 8 activation rows x {pos, neg}.
template <int FORM, int MT>
__global__ void __launch_bounds__(kThreads, MT == 1 ? 4 : MT == 2 ? 3 : 2)
split_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_last;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // grid z: (expert, row group), the groups of one expert adjacent
  const int groups = (p.m + 8 * MT - 1) / (8 * MT);
  const int expert = blockIdx.z / groups, group = blockIdx.z % groups;
  const int row0 = group * 8 * MT;
  const int wcol = blockIdx.x * kBN + warp * 32;
  const int n_chunks = p.k / p.chunk_rows;
  const int n_tot = p.faithful ? 2 : 4;
  const long long mn = static_cast<long long>(p.m) * p.n;
  float* s_tot =
      split_tile<FORM, MT>(p, blockIdx.x, blockIdx.y, group, smem, expert);

  if (p.n_splits > 1) {  // faithful split-K: the last CTA of the tile ends it
    // the expert's slots: part [E, n_splits, m, n]
    float* const slots = p.part + static_cast<long long>(expert) *
                                      p.n_splits * mn;
    float* part = slots + blockIdx.y * mn;
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row0 + 8 * i + g, c = wcol + 8 * t + 4 * h + j;
          if (r < p.m && c < p.n)
            part[static_cast<long long>(r) * p.n + c] =
                s_tot[tot_index(i, j, h, 2) * kThreads];
        }
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      const int prev =
          atomicAdd(&p.counters[blockIdx.z * gridDim.x + blockIdx.x], 1);
      s_last = prev == p.n_splits - 1;
    }
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row0 + 8 * i + g, c = wcol + 8 * t + 4 * h + j;
          if (r >= p.m || c >= p.n) continue;
          const float* src = slots + static_cast<long long>(r) * p.n + c;
          float sum = 0.f;
          for (int sp = 0; sp < p.n_splits; ++sp)
            sum = __fadd_rn(sum, __ldcg(src + sp * mn));
          s_tot[tot_index(i, j, h, 2) * kThreads] = sum;
        }
  }

  const float lo = -128.f * n_chunks;
  const float hi = 127.f * n_chunks;
  const float div = static_cast<float>(1 << (p.shift > 0 ? p.shift : 0));
  const float* const post =
      p.post_gain == nullptr ? nullptr : p.post_gain + expert * p.n_stride;
  float* const out = p.out + expert * mn;
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + 8 * i + g, c = wcol + 8 * t + 4 * h + j;
        if (r >= p.m || c >= p.n) continue;
        const int e = tot_index(i, j, h, n_tot);
        float y;
        if (p.faithful) {
          y = s_tot[e * kThreads];
        } else {
          float tp = s_tot[e * kThreads], tn = s_tot[(e + 2) * kThreads];
          if (post != nullptr) {
            tp = __fmul_rn(tp, post[c]);
            tn = __fmul_rn(tn, post[c]);
          }
          y = __fsub_rn(adc_clip(tp, lo, hi), adc_clip(tn, lo, hi));
        }
        if (p.shift >= 0) {
          y = floorf(__fdiv_rn(fmaxf(y, 0.f), div));
          y = fminf(fmaxf(y, 0.f), 31.f);
        }
        out[static_cast<long long>(r) * p.n + c] = y;
      }
}

// The tile takes more than 48 KB of dynamic shared memory: allow it once
// per device (the attribute is a property of the kernel on one device).
template <int FORM, int MT>
int configure() {
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < kMaxDevices && configured[dev]) return 0;
  e = cudaFuncSetAttribute(split_kernel<FORM, MT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_bytes(FORM, MT, 0));
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < kMaxDevices) configured[dev] = true;
  return 0;
}

template <int FORM, int MT>
int launch_form(const Params& p, dim3 grid, cudaStream_t st) {
  if (const int e = configure<FORM, MT>()) return e;
  split_kernel<FORM, MT><<<grid, kThreads, smem_bytes(FORM, MT, p.faithful),
                           st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int FORM, int MT>
int occupancy(int faithful, int* blocks) {
  if (const int e = configure<FORM, MT>()) return e;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, split_kernel<FORM, MT>, kThreads,
      smem_bytes(FORM, MT, faithful)));
}

template <int FORM>
int launch_mt(const Params& p, int mt, dim3 grid, cudaStream_t st) {
  switch (mt) {
    case 1: return launch_form<FORM, 1>(p, grid, st);
    case 2: return launch_form<FORM, 2>(p, grid, st);
    case 3: return launch_form<FORM, 3>(p, grid, st);
    case 6: return launch_form<FORM, 6>(p, grid, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int FORM>
int occupancy_mt(int mt, int faithful, int* blocks) {
  switch (mt) {
    case 1: return occupancy<FORM, 1>(faithful, blocks);
    case 2: return occupancy<FORM, 2>(faithful, blocks);
    case 3: return occupancy<FORM, 3>(faithful, blocks);
    case 6: return occupancy<FORM, 6>(faithful, blocks);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// experts > 1 (the expert axis): one launch runs `experts` stacked
//         matrices, ap / an [E, m, k], w [E, k, n], gain / post_gain
//         [E, n], out [E, m, n], part [E, n_splits, m, n], counters [E x
//         row groups x column tiles].  The grid's z walks (expert, row
//         group).  tables == 0 (an expert stack): off [k / chunk_rows, n]
//         is shared, col_gain, row_gain and chunk_gain absent.
// tables: 1 (the member axis of a batch_concat group, any form): each
//         member reads its own off [E, k / chunk_rows, n] and, where
//         given, col_gain [E, n], row_gain [E, n_blocks, k] and
//         chunk_gain [E, k / chunk_rows, n].
// post_gain (fast mode only, else null): [E, n] gain applied to each
//         pass's total before its rounding, with the chunks run at the
//         gain passed as `gain` (1.0 for the expert products).
// form 0: w is int8 codes [k, n] with optional col_gain [n] and row_gain
//         [n_blocks, k] (block b covers columns [block_ends[b-1],
//         block_ends[b]), each end a multiple of 4); form 2: the same
//         with chunk_gain [k / chunk_rows, n] (a measured per-(chunk,
//         column) gain table), null in every other form; form 1: w is
//         fp32.
// mt: m16 tiles per CTA (8 activation rows each: 1, 2, 3 or 6); the grid is
// (ceil(n / 128), n_splits, experts x ceil(m / (8 mt))).  n_splits > 1
// (faithful only) needs part [E, n_splits, m, n] and zeroed counters
// [E x row groups x column tiles].  shift < 0: no epilogue.  vec: every operand row starts
// on a 16-byte boundary (cp.async staging).
extern "C" int analog_mvm_split_launch(
    const float* ap, const float* an, const void* w, int form,
    const float* col_gain, const float* row_gain, const float* chunk_gain,
    int n_blocks, const int* block_ends, const float* gain, const float* off, float* out,
    float* part, int* counters, int m, int k, int n, int chunk_rows,
    int chunks_per_cta, int n_splits, int mt, int faithful, int shift,
    int vec, int experts, const float* post_gain, int tables,
    void* stream) {
  if (m == 0 || n == 0 || experts == 0) return 0;
  if (chunk_rows <= 0 || chunk_rows % kBK != 0 || k % chunk_rows != 0 ||
      k == 0 || n_blocks < 1 || n_blocks > kMaxBlocks ||
      chunks_per_cta < 1 || (n_splits > 1 && (!faithful || !part || !counters)) ||
      form < 0 || form > 2 || (form == 2) != (chunk_gain != nullptr) ||
      experts < 1 ||
      (experts > 1 && !tables &&
       (col_gain != nullptr || row_gain != nullptr ||
        chunk_gain != nullptr)) ||
      (post_gain != nullptr && faithful))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_chunks = k / chunk_rows;
  if ((n_chunks + chunks_per_cta - 1) / chunks_per_cta != n_splits)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{ap, an, w, col_gain, row_gain, chunk_gain, gain, off, out, part,
           counters, m, k, n, chunk_rows, chunks_per_cta, n_splits, n_blocks, {},
           faithful, shift, vec, n, 1};
  for (int b = 0; b < kMaxBlocks; ++b)
    p.block_end[b] = b < n_blocks ? block_ends[b] : n;
  p.experts = experts;
  p.post_gain = post_gain;
  if (experts > 1) {
    p.x_stride = static_cast<long long>(m) * k;
    p.w_stride = static_cast<long long>(k) * n;
    p.n_stride = n;
  }
  if (tables) {
    p.cg_stride = n;
    p.rg_stride = static_cast<long long>(n_blocks) * k;
    p.off_estride = static_cast<long long>(n_chunks) * n;
    p.chg_stride = static_cast<long long>(n_chunks) * n;
  }
  const long long groups = (m + 8LL * mt - 1) / (8LL * mt) * experts;
  if (groups > 65535 || n_splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kBN - 1) / kBN, n_splits, static_cast<unsigned>(groups));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return form == 0   ? launch_mt<0>(p, mt, grid, st)
         : form == 2 ? launch_mt<2>(p, mt, grid, st)
                     : launch_mt<1>(p, mt, grid, st);
}

// CTAs of one (form, mt, mode) instantiation resident per SM at once
extern "C" int analog_mvm_split_occupancy(int form, int mt, int faithful,
                                          int* blocks) {
  return form == 0   ? occupancy_mt<0>(mt, faithful, blocks)
         : form == 2 ? occupancy_mt<2>(mt, faithful, blocks)
                     : occupancy_mt<1>(mt, faithful, blocks);
}

extern "C" const char* analog_mvm_split_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
