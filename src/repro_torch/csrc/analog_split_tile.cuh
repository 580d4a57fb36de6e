// One CTA work item of the signed-split chunked saturating analog VMM:
// a (column tile, chunk range, row group) of
//     y = mvm(a_pos) - mvm(a_neg)
// where, per pass and per chunk c of chunk_rows input rows,
//     v_c = (a_c @ w_c) * gain + off[c]
// read out per chunk at the ADC: faithful mode sums clip(rint(v_c)) of the
// positive pass minus that of the negative pass (integers), fast mode sums
// the floats v_c of each pass on its own.  The routine leaves each
// thread's running totals in shared memory; its callers finish them: the
// split kernel (analog_mvm_split.cu, one launch per layer) and the VMM
// stages of the transformer-block kernel (analog_plan_block.cu).
//
// * Weight operand.  Forms 0 and 2 read the plan's int8 6-bit codes (1
//   byte per weight instead of 4) and rebuild each effective weight in
//   registers as (code * col_gain[n]) * row_gain[block(n)][k] (form 0),
//   times chunk_gain[c][n] (form 2), with one __fmul_rn per factor (an
//   absent rank-1 factor is 1.0f, exact), in the order WeightStore
//   derives its w_eff: bit for bit the fp32 w_eff of the plan's store.
//   chunk_gain is the measured per-(chunk, column) gain table of a
//   calibrated bake; it is constant over a chunk, so form 2 stages its
//   kBN-column row once per chunk beside the chunk's offsets.  Form 0 is
//   compiled without it, so the rank-1 path stages and multiplies nothing
//   more for it.  Form 1 reads an fp32 w_eff (stores with a full gain
//   map).
// * Tensor cores.  The activation codes are integers 0..31, exact in
//   bf16.  Each rebuilt fp32 weight is cut into three bf16 pieces by
//   truncation, w = w1 + w2 + w3 exactly (24 significand bits = 3 x 8), so
//   every product a * wi is exact and mma.sync m16n8k16 sums them in fp32.
//   Each m16 tile stacks 8 activation rows of the positive pass over the
//   same 8 rows of the negative pass, so both passes share every B
//   fragment and a thread holds the pos and neg sums of one (row, column)
//   pair.  A CTA holds 1, 2, 3 or 6 m16 tiles (8 to 48 activation rows).
//   With integer w_eff every chunk sum is an integer below 2^24, exact in
//   any order.  With float gains only the order of the fp32 sums differs
//   from a sequential dot (within 1 LSB at an ADC rounding tie).
// * Asynchronous loads.  A ring of 3-4 shared-memory stages of kBK weight
//   rows each (plus the activation and row-gain slices of those rows and
//   each chunk's offsets) is fed with 16-byte cp.async, one stage fewer
//   than the ring ahead.  Operands whose rows are not 16-byte aligned
//   (Params::vec == 0) are staged with plain loads instead (same stages,
//   no overlap).  Each thread's running totals live in shared memory
//   (read and written once per chunk), leaving the registers to the
//   accumulators.
//
// CTA: 4 warps, kBN = 128 output columns (32 per warp).  Lane (g, t) =
// (lane / 4, lane % 4) builds the B fragment of column 4g + j of its warp
// for n8 tile j, so one 32-bit shared load gives it the codes of its four
// tiles at one weight row; output column q of n8 tile j is 4q + j.  The
// totals of accumulator (i, j, h) of thread (warp, g, t) belong to row
// row0 + 8 i + g and column col0 + 32 warp + 8 t + 4 h + j.
#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace analog_split {

constexpr int kThreads = 128;
constexpr int kBN = 128;
constexpr int kBK = 32;
constexpr int kMaxBlocks = 4;
constexpr int kActStride = kBK + 8;  // floats per staged activation row

struct Params {
  const float* ap;        // [m, k] codes of max(x, 0)
  const float* an;        // [m, k] codes of max(-x, 0)
  const void* w;          // form 0: int8 codes [k, n]; form 1: fp32 [k, n]
  const float* col_gain;  // [n] or null (form 0)
  const float* row_gain;  // [n_blocks, k] or null (form 0)
  const float* chunk_gain;  // [k / chunk_rows, n] (form 2 only)
  const float* gain;      // [n]
  const float* off;       // [k / chunk_rows, off_stride]
  float* out;             // [m, n]
  float* part;            // [n_splits, m, n] partial totals (n_splits > 1)
  int* counters;          // [row groups * column tiles], zeroed
  int m, k, n, chunk_rows, chunks_per_cta, n_splits;
  int n_blocks;
  int block_end[kMaxBlocks];  // cumulative column-block ends
  int faithful, shift, vec;
  int off_stride;  // floats per row of off
  int neg;         // 0: the negative pass is absent (an is not read out)
  // The expert axis (analog_mvm_split.cu only): `experts` stacked
  // matrices in one launch, ap / an [E, m, k], w [E, k, n], gain [E, n],
  // out [E, m, n].  Element strides per expert (0 with one expert).
  int experts = 1;
  long long x_stride = 0;  // ap, an: m * k
  long long w_stride = 0;  // w: k * n weights
  long long n_stride = 0;  // gain, post_gain: n
  // The member axis of a batch_concat group: each expert (member) reads
  // its own tables, col_gain [E, n], row_gain [E, n_blocks, k], off and
  // chunk_gain [E, k / chunk_rows, n].  Element strides per expert; 0
  // shares one table (or none) across the experts.
  long long cg_stride = 0;   // col_gain: n
  long long rg_stride = 0;   // row_gain: n_blocks * k
  long long off_estride = 0; // off: (k / chunk_rows) * off_stride
  long long chg_stride = 0;  // chunk_gain: (k / chunk_rows) * n
  // fast mode: [E, n] gain applied to each pass's total before its single
  // rounding (the expert products, whose chunks run at gain 1), or null
  const float* post_gain = nullptr;
};

// pipeline depth: 3 stages for the 48-row tile (its activations are the
// largest slice), 4 otherwise
__host__ __device__ constexpr int n_stages(int mt) { return mt == 6 ? 3 : 4; }
// forms 0 and 2 read int8 codes, form 1 fp32 w_eff
__host__ __device__ constexpr bool reads_codes(int form) { return form != 1; }
__host__ __device__ constexpr int w_row_bytes(int form) {
  return reads_codes(form) ? kBN + 16 : kBN * 4 + 16;
}
__host__ __device__ constexpr int act_bytes(int mt) {
  return 2 * 8 * mt * kActStride * 4;
}
__host__ __device__ constexpr int stage_bytes(int form, int mt) {
  return kBK * w_row_bytes(form) + act_bytes(mt) +
         (reads_codes(form) ? kMaxBlocks * kBK * 4 : 0);
}
// after the ring: the tile's gains, a ring of n_stages chunks' offsets (a
// slot is refilled n_stages chunks later, after its readout), form 2 a
// ring of n_stages chunks' chunk-gain rows beside it, then each thread's
// running totals (2 per accumulator pair faithful, 4 fast)
__host__ __device__ constexpr int chunk_rings(int form, int mt) {
  return form == 2 ? 2 * n_stages(mt) : n_stages(mt);
}
__host__ __device__ constexpr int tot_offset(int form, int mt) {
  return n_stages(mt) * stage_bytes(form, mt) +
         (1 + chunk_rings(form, mt)) * kBN * 4;
}
__host__ __device__ constexpr int smem_bytes(int form, int mt, int faithful) {
  return tot_offset(form, mt) + mt * 4 * (faithful ? 2 : 4) * kThreads * 4;
}

__device__ __forceinline__ float adc_clip(float v, float lo, float hi) {
  return fminf(fmaxf(rintf(v), lo), hi);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// two fp32 values -> one bf16x2 register of their high halves (the first
// in the low half): exact for values whose low 16 bits are zero
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}
__device__ __forceinline__ float trunc_bf16(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xffff0000u);
}
// signed byte j of a word whose bytes were biased by 0x80, as a float:
// the bits 0x4B0000bb are 2^23 + bb, exactly
__device__ __forceinline__ float code_to_float(uint32_t biased, int j) {
  return __fsub_rn(
      __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7540 + j)),
      8388736.0f);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Index of the running total of accumulator (i, j, pass h) in a thread's
// totals (faithful: the pos - neg total at h; fast: pos at h, neg at h + 2).
__device__ __forceinline__ int tot_index(int i, int j, int h, int n_tot) {
  return (i * 4 + j) * n_tot + h;
}

// One work item: column tile `tile` (kBN columns), chunk range `split`
// (chunks [split * chunks_per_cta, + chunks_per_cta), clipped to k), row
// group `group` (8 * MT rows).  Every thread of the CTA calls it; `smem`
// holds smem_bytes(FORM, MT, faithful) bytes.  Returns the thread's
// totals: element tot_index(i, j, h, n_tot) * kThreads of the pointer,
// n_tot = faithful ? 2 : 4.  The routine begins with a barrier, so a CTA
// may call it for one item after another on the same shared memory once
// it has read its totals.
// FORM 0: int8 codes + rank-1 gain tables; FORM 2: the same + chunk_gain;
// FORM 1: fp32 w_eff.
// MT: m16 tiles per CTA, each 8 activation rows x {pos, neg}.
template <int FORM, int MT>
__device__ __forceinline__ float* split_tile(const Params& p, int tile,
                                             int split, int group,
                                             unsigned char* smem,
                                             int expert = 0) {
  constexpr int kStages = n_stages(MT);
  constexpr bool kCodes = reads_codes(FORM);
  constexpr bool kCG = FORM == 2;  // a chunk_gain table to multiply in
  constexpr int kE = kCodes ? 1 : 4;  // bytes per weight
  constexpr int kWRow = w_row_bytes(FORM);
  constexpr int kWBytes = kBK * kWRow;
  constexpr int kRows = 8 * MT;  // activation rows per CTA
  constexpr int kStage = stage_bytes(FORM, MT);
  // 16-byte pieces of one stage's weight and activation slices
  constexpr int kWPieceRow = kBN * kE / 16;
  constexpr int kWPer = kBK * kWPieceRow / kThreads;
  constexpr int kAPer = 2 * kRows * (kBK / 4) / kThreads;
  static_assert(kWPer * kThreads == kBK * kWPieceRow, "weight pieces");
  static_assert(kAPer * kThreads == 2 * kRows * (kBK / 4), "act pieces");

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int col0 = tile * kBN;
  const int row0 = group * kRows;
  const int n_chunks = p.k / p.chunk_rows;
  const int c_begin = split * p.chunks_per_cta;
  const int c_end = min(n_chunks, c_begin + p.chunks_per_cta);
  const int spc = p.chunk_rows / kBK;
  const int n_st = (c_end - c_begin) * spc;
  const int k_begin = c_begin * p.chunk_rows;
  const int wcol = col0 + warp * 32;  // the warp's first column
  const int n_tot = p.faithful ? 2 : 4;
  // the expert's operands; its tables at their strides (0: shared)
  const long long ex = expert;
  const float* const ap = p.ap + ex * p.x_stride;
  const float* const an = p.an + ex * p.x_stride;
  const unsigned char* const wsrc =
      static_cast<const unsigned char*>(p.w) + ex * p.w_stride * kE;
  const float* const gain = p.gain + ex * p.n_stride;
  const float* const off = p.off + ex * p.off_estride;
  const float* const col_gain =
      p.col_gain == nullptr ? nullptr : p.col_gain + ex * p.cg_stride;
  const float* const row_gain =
      p.row_gain == nullptr ? nullptr : p.row_gain + ex * p.rg_stride;
  const float* const chunk_gain =
      p.chunk_gain == nullptr ? nullptr : p.chunk_gain + ex * p.chg_stride;

  float* s_gain = reinterpret_cast<float*>(smem + kStages * kStage);
  float* s_off = s_gain + kBN;  // [kStages][kBN]
  float* s_cg = s_off + kStages * kBN;  // form 2: [kStages][kBN]
  float* s_tot = reinterpret_cast<float*>(smem + tot_offset(FORM, MT)) + tid;
  __syncthreads();  // a previous item is done with the shared memory
  for (int e = tid; e < kBN; e += kThreads)
    s_gain[e] = col0 + e < p.n ? gain[col0 + e] : 0.f;
  for (int e = 0; e < MT * 4 * n_tot; ++e) s_tot[e * kThreads] = 0.f;
  // the B fragment columns of this lane: 4g + j
  const int bcol = wcol + 4 * g;
  const bool has_row = kCodes && p.row_gain != nullptr;
  float cg[4];  // an absent gain factor is 1.0f: x * 1.0f is exact
  int blk = 0;
  if constexpr (kCodes) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      cg[j] = (col_gain != nullptr && bcol + j < p.n)
                  ? col_gain[bcol + j] : 1.f;
    for (int b = 0; b + 1 < p.n_blocks; ++b) blk += p.block_end[b] <= bcol;
  }

  // the next stage to load: its first weight row, chunk, place in the
  // chunk and ring slot (running counters: no division in the loop)
  int ld_kr = k_begin, ld_chunk = c_begin, ld_sub = 0, ld_buf = 0;
  auto load_next = [&]() {
    unsigned char* base = smem + ld_buf * kStage;
    float* act = reinterpret_cast<float*>(base + kWBytes);
    float* rg = reinterpret_cast<float*>(base + kWBytes + act_bytes(MT));
    const int kr = ld_kr;
    const bool first = ld_sub == 0;  // the chunk's offsets come with it
    const int chunk = ld_chunk;
    ld_kr += kBK;
    if (++ld_sub == spc) {
      ld_sub = 0;
      ++ld_chunk;
    }
    ld_buf = ld_buf + 1 == kStages ? 0 : ld_buf + 1;
    float* so = s_off + (chunk % kStages) * kBN;
    const float* osrc = off + static_cast<long long>(chunk) * p.off_stride;
    float* scg = s_cg + (chunk % kStages) * kBN;
    const float* cgsrc =
        kCG ? chunk_gain + static_cast<long long>(chunk) * p.n : nullptr;
    if (p.vec) {
      // n * kE is a multiple of 16: a piece is wholly in or out of range
      const unsigned char* w = wsrc;
#pragma unroll
      for (int q = 0; q < kWPer; ++q) {
        const int e = tid + q * kThreads;
        const int r = e / kWPieceRow, cb = (e % kWPieceRow) * 16;
        const bool in = (col0 * kE + cb) < p.n * kE;
        cp_async16(base + r * kWRow + cb,
                   in ? w + (static_cast<long long>(kr + r) * p.n + col0) * kE
                            + cb : w,
                   in ? 16 : 0);
      }
#pragma unroll
      for (int q = 0; q < kAPer; ++q) {
        const int e = tid + q * kThreads;
        const int pr = e / (kBK / 4), cc = (e % (kBK / 4)) * 4;
        const int r = row0 + pr % kRows;
        const float* src = pr < kRows ? ap : an;
        cp_async16(act + pr * kActStride + cc,
                   r < p.m ? src + static_cast<long long>(r) * p.k + kr + cc
                           : p.ap,
                   r < p.m ? 16 : 0);
      }
      if (first && tid < kBN / 4) {
        const int gc = col0 + 4 * tid;
        cp_async16(so + 4 * tid, gc < p.n ? osrc + gc : p.off,
                   gc < p.n ? 16 : 0);
      }
      if (kCG && first && tid >= kBN / 4 && tid < kBN / 2) {
        const int e = tid - kBN / 4, gc = col0 + 4 * e;
        cp_async16(scg + 4 * e, gc < p.n ? cgsrc + gc : p.chunk_gain,
                   gc < p.n ? 16 : 0);
      }
      if (has_row && tid < p.n_blocks * (kBK / 4)) {
        const int b = tid / (kBK / 4), cc = (tid % (kBK / 4)) * 4;
        cp_async16(rg + b * kBK + cc,
                   row_gain + static_cast<long long>(b) * p.k + kr + cc, 16);
      }
      return;
    }
    // rows that are not 16-byte aligned: plain loads
    for (int e = tid; e < kBK * kBN; e += kThreads) {
      const int r = e / kBN, c = e % kBN;
      const long long idx = static_cast<long long>(kr + r) * p.n + col0 + c;
      const bool in = col0 + c < p.n;
      if constexpr (kCodes) {
        base[r * kWRow + c] = in ? wsrc[idx] : 0;
      } else {
        reinterpret_cast<float*>(base + r * kWRow)[c] =
            in ? reinterpret_cast<const float*>(wsrc)[idx] : 0.f;
      }
    }
    for (int e = tid; e < 2 * kRows * kBK; e += kThreads) {
      const int pr = e / kBK, c = e % kBK;
      const int r = row0 + pr % kRows;
      const float* src = pr < kRows ? ap : an;
      act[pr * kActStride + c] =
          r < p.m ? src[static_cast<long long>(r) * p.k + kr + c] : 0.f;
    }
    if (first)
      for (int e = tid; e < kBN; e += kThreads)
        so[e] = col0 + e < p.n ? osrc[col0 + e] : 0.f;
    if (kCG && first)
      for (int e = tid; e < kBN; e += kThreads)
        scg[e] = col0 + e < p.n ? cgsrc[col0 + e] : 0.f;
    if (has_row)
      for (int e = tid; e < p.n_blocks * kBK; e += kThreads) {
        const int b = e / kBK, c = e % kBK;
        rg[b * kBK + c] = row_gain[static_cast<long long>(b) * p.k + kr + c];
      }
  };

  float acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_st) load_next();
    cp_async_commit();
  }

  // the stage computed now: its chunk, place in the chunk and ring slot
  int chunk = c_begin, sub = 0, buf = 0;
  for (int s = 0; s < n_st; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage s landed; stage s - 1's buffer is free
    if (s + kStages - 1 < n_st) load_next();
    cp_async_commit();
    const unsigned char* base = smem + buf * kStage;
    buf = buf + 1 == kStages ? 0 : buf + 1;
    const float* act = reinterpret_cast<const float*>(base + kWBytes);
    const float* rg =
        reinterpret_cast<const float*>(base + kWBytes + act_bytes(MT)) +
        blk * kBK;
    // the chunk's gain at the lane's four B fragment columns 4g + j
    [[maybe_unused]] float4 ccg;  // form 2 only
    if constexpr (kCG)
      ccg = *reinterpret_cast<const float4*>(s_cg + (chunk % kStages) * kBN +
                                             warp * 32 + 4 * g);
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      const int kk = ks * 16 + 2 * t;  // rows kk, kk + 1, kk + 8, kk + 9
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const float* pr = act + (8 * i + g) * kActStride + kk;
        const float* nr = pr + kRows * kActStride;
        const float2 p0 = *reinterpret_cast<const float2*>(pr);
        const float2 p8 = *reinterpret_cast<const float2*>(pr + 8);
        const float2 n0 = *reinterpret_cast<const float2*>(nr);
        const float2 n8 = *reinterpret_cast<const float2*>(nr + 8);
        a[i][0] = pack_bf16(p0.x, p0.y);
        a[i][1] = pack_bf16(n0.x, n0.y);
        a[i][2] = pack_bf16(p8.x, p8.y);
        a[i][3] = pack_bf16(n8.x, n8.y);
      }
      const int rows[4] = {kk, kk + 1, kk + 8, kk + 9};
      uint32_t wd[4];
      float4 wf[4];
      float rgv[4] = {1.f, 1.f, 1.f, 1.f};
      if (has_row) {
        const float2 r0 = *reinterpret_cast<const float2*>(rg + kk);
        const float2 r8 = *reinterpret_cast<const float2*>(rg + kk + 8);
        rgv[0] = r0.x;
        rgv[1] = r0.y;
        rgv[2] = r8.x;
        rgv[3] = r8.y;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if constexpr (kCodes) {
          wd[r] = *reinterpret_cast<const uint32_t*>(
                      base + rows[r] * kWRow + warp * 32 + 4 * g) ^
                  0x80808080u;
        } else {
          wf[r] = *reinterpret_cast<const float4*>(
              base + rows[r] * kWRow + (warp * 32 + 4 * g) * 4);
        }
      }
      uint32_t bfr[3][4][2];  // [piece lo, mid, hi][n8 tile][register]
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float w[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if constexpr (kCodes) {
            w[r] = __fmul_rn(__fmul_rn(code_to_float(wd[r], j), cg[j]),
                             rgv[r]);
            if constexpr (kCG)
              w[r] = __fmul_rn(w[r], j == 0 ? ccg.x : j == 1 ? ccg.y
                                      : j == 2 ? ccg.z : ccg.w);
          } else {
            w[r] = j == 0 ? wf[r].x : j == 1 ? wf[r].y : j == 2 ? wf[r].z
                                                                : wf[r].w;
          }
        }
        // w = hi + mid + lo, each exactly a bf16 value
        float hi[4], mid[4], lo[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          hi[r] = trunc_bf16(w[r]);
          const float r1 = __fsub_rn(w[r], hi[r]);
          mid[r] = trunc_bf16(r1);
          lo[r] = __fsub_rn(r1, mid[r]);
        }
        bfr[0][j][0] = pack_bf16(lo[0], lo[1]);
        bfr[0][j][1] = pack_bf16(lo[2], lo[3]);
        bfr[1][j][0] = pack_bf16(mid[0], mid[1]);
        bfr[1][j][1] = pack_bf16(mid[2], mid[3]);
        bfr[2][j][0] = pack_bf16(w[0], w[1]);
        bfr[2][j][1] = pack_bf16(w[2], w[3]);
      }
      // pieces outermost: consecutive MMAs feed different accumulators
#pragma unroll
      for (int pc = 0; pc < 3; ++pc)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int i = 0; i < MT; ++i)
            mma_bf16(acc[i][j], a[i], bfr[pc][j][0], bfr[pc][j][1]);
    }

    if (++sub == spc) {  // the chunk's ADC readout
      sub = 0;
      const float* so = s_off + (chunk % kStages) * kBN;
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int cl = warp * 32 + 8 * t + 4 * h + j;
            const float gv = s_gain[cl], ov = so[cl];
            const float vp = __fadd_rn(__fmul_rn(acc[i][j][h], gv), ov);
            const float vn = __fadd_rn(__fmul_rn(acc[i][j][2 + h], gv), ov);
            const int e = tot_index(i, j, h, n_tot);
            if (p.faithful) {
              const float cn = p.neg ? adc_clip(vn, -128.f, 127.f) : 0.f;
              s_tot[e * kThreads] = __fadd_rn(
                  s_tot[e * kThreads],
                  __fsub_rn(adc_clip(vp, -128.f, 127.f), cn));
            } else {
              s_tot[e * kThreads] = __fadd_rn(s_tot[e * kThreads], vp);
              if (p.neg)
                s_tot[(e + 2) * kThreads] =
                    __fadd_rn(s_tot[(e + 2) * kThreads], vn);
            }
            acc[i][j][h] = acc[i][j][2 + h] = 0.f;
          }
      ++chunk;
    }
  }
  cp_async_wait<0>();
  return s_tot;
}

}  // namespace analog_split
