// Non-causal attention over (B, H, S, D) fp32 or bf16 tensors with an online
// softmax:
//
//   o[bh, i, :] = sum_j softmax_j(scale * q[bh, i, :] . k[bh, j, :]) v[bh, j, :]
//
// for j < Skv, Sq != Skv allowed, D from 1 to 256. Running max, denominator
// and accumulator are fp32 registers; the Sq x Skv score matrix never reaches
// device memory.
//
// Replaces the Pallas TPU kernel tmdiff_tpu/ops/pallas/flash_attention.py
// `flash_attention` (_kernel). That kernel pads D to 128 lanes and S to the
// block size in device memory and walks the K/V blocks as a sequential third
// grid axis, carrying (m, l, acc) in VMEM scratch. Here a block owns a
// (batch*head, query tile[, key range]) and loops over the key tiles itself;
// the ragged edges (keys at or past Skv, queries past Sq, columns past D) are
// masked or zero-filled, so nothing is padded in the caller's tensors.
//
// What bounds it on an H100: operations. Each query row does 4 * Skv * D
// FLOPs (two products) against 8 * D bytes of q and o, and each K/V row is
// reused by every query tile: at S = 1024..4096 that is 0.5-2 kFLOP per byte,
// far above the ridge of any rate. Only cross-attention to a short context
// (Skv of 1 to a few tokens) is bound by bytes (reading q, writing o).
//
// Three kernels, chosen by the caller's plan (ops/cuda/flash_attention.py
// `plan`), a function of D and the dtype:
//
// 3xTF32 tensor cores (flash_attention_tf32x3_kernel), fp32, D % 4 == 0. fp32
// accuracy costs three TF32 products per multiply-add (hi*lo + lo*hi +
// hi*hi with hi = rna_tf32(v), lo = rna_tf32(v - hi)), on both products, so
// the bound is the TF32 rate over three, 165 TFLOP/s.
//   * A first pass (attention_kv_split_kernel) writes K and V^T of every
//     (batch*head, key tile) into the workspace, split into hi and lo and in
//     wgmma's no-swizzle K-major core-matrix layout: one contiguous image
//     [K hi | K lo | V^T hi | V^T lo] per tile, keys past Skv and columns
//     past D zero. It reads K and V once; the main loop stages a tile with
//     two bulk copies. Inside each k8 group the k order is permuted to
//     0 2 4 6 1 3 5 7 (K over d, V^T over keys), so that an A fragment's
//     columns t and t + 4 are neighbouring elements: Q's come from one
//     float2 load, and P's are the S accumulator's own pair (2t, 2t + 1)
//     without a shuffle.
//   * S = Q.K^T: wgmma.m64nBKk8 with A = Q from registers (split once per
//     block where D <= 64; else Q stays fp32 in shared memory, rows padded
//     by 8 floats against bank conflicts, and is split per k8 step), B = the
//     K tile. O += P.V: A = P built from S's fragment (mask, exp2, split),
//     B = the V^T tile. Each tile's P.V goes into a fresh accumulator that
//     is folded into O as O = O * alpha + tile in fp32: the tensor cores'
//     truncating accumulation then spans one tile (at most 8 k8 steps x 3
//     products), not the whole key range.
//   * Block: two consumer warpgroups and one producer warpgroup (setmaxnreg
//     40 / 232). The producer keeps a ring of 2-4 stages in flight on
//     full/empty mbarriers. D <= 128: each consumer owns 64 query rows (128
//     per block) and all D columns. D <= 256: both consumers take the same
//     64 rows and each owns half of the output columns (n128 each), which
//     keeps O and the fresh tile accumulator in registers at 64 each; each
//     computes S over its half of d and the halves are swapped through
//     shared memory, so S is issued once. D <= 64: the two consumers take
//     turns to issue S (named barriers 2 and 3), so that one's softmax runs
//     under the other's products (5 % at self-attention, 4096 x 64).
//   * Key tile: 8, 16, 32 or 64 keys (the smallest that covers Skv, at most
//     64 / 32 / 16 for D <= 64 / 128 / 256): cross-attention to one key does
//     8 keys of work.
//   * Split-KV: where the query tiles underfill the card the plan splits
//     the key tiles over blocks; each split writes its unnormalised O and
//     (m, l) to the workspace and attention_merge_kernel combines them in
//     split order (no atomics: one input gives one output).
//   * Softmax in exp2 with scale * log2(e) folded into the scores; row max
//     over the 4 lanes of a quad by shuffles; keys past Skv at -inf.
//
// fp32 FMA (flash_attention_ffma_kernel), D % 4 != 0: 256 threads as 16 x
// 16, thread (ty, tx) owns query rows 4ty..4ty+3; 64-query by 64-key tiles in
// dynamic shared memory (217 KB at D = 256), rows padded to an odd multiple
// of 4 floats; P goes through shared memory to the P.V product.
//
// bf16 (the entry's dtype 1): the Pallas kernel's function for bf16 q, k, v
// (flash_attention.py:43-66), which casts each tile to fp32, accumulates
// both products in fp32, keeps p, m, l and acc in fp32 and writes q.dtype
// once. The FMA kernel has a bf16 instance (bf16 loads widened exactly, o
// rounded to nearest even once) for D % 8 != 0; D % 8 == 0 (16-byte bf16
// rows) takes a kernel of its own:
//
// bf16 tensor cores (flash_attention_bf16_kernel). A product of two bf16
// values is exact in fp32, so S = Q.K^T is one bf16 wgmma (m64nBKk16, fp32
// accumulate), the same S as a TF32 product at twice the rate. p stays fp32
// for the softmax and the row sums; for P.V it enters as two bf16 parts,
// p_hi = rn_bf16(p) and p_lo = rn_bf16(p - p_hi), two wgmmas per k16 step
// against the bf16 V. That keeps 16 of p's 24 bits: the error is at most
// 2^-18 of sum_j p_j |v_j|, about 26x inside the bf16 bar's 1e-4 of the
// output's scale (tests/test_torch_flash_plan.py emulates it against
// float64; the card's largest errors are in PERF.md), so no third part.
// Bound: operations, one bf16 product for S and two for P.V, 989 / 1.5 =
// 659 TFLOP/s for the work of both.
//   * K and V read in place: TMA copies (K, V and Q) through 3-D tensor
//     maps over the caller's (B*H, S, D) tensors with the 128-byte swizzle,
//     one box of 64 columns x rows per 64-column chunk of the head tile.
//     Key rows past Skv, query rows past Sq and columns past D read as zero
//     (never the next head's); keys past Skv are still masked to -inf. K
//     and Q are K-major wgmma operands, V the MN-major B operand of P.V
//     (the transpose bit; sw128_desc in hopper.cuh). No workspace and one
//     launch when unsplit; the maps are encoded per call on the host.
//   * P without a shuffle: the S accumulator's fragment of two neighbouring
//     n8 column blocks is the A fragment of one k16 step, so p's parts pack
//     into bf16x2 registers in the accumulator's own order.
//   * Key tile 16, 32, 64 or 128 keys (the smallest that covers Skv, at
//     most 128 / 64 / 32 for head tiles 64 / 128 / 256), four stages of K
//     and V; each tile's P.V goes into a fresh accumulator folded into O in
//     fp32, as in the fp32 kernel.
//   * Overlap: a consumer issues S of tile i + 1 and P.V of tile i in one
//     group and waits for both; at head tiles 64 and 128 the two consumers
//     take turns to issue (named barriers 2 and 3), so one's softmax runs
//     under the other's products. Head tile 256: both consumers take the
//     same 64 rows, each owns 128 output columns and computes S over its
//     half of d, and the halves are swapped through shared memory.
//   * The softmax is the critical path (PERF.md): 2^x on the MUFU without
//     exp2f's range fix-ups, the row max of a tile inside Skv taken on the
//     raw scores and p = 2^(s c - m) as one FMA, row max and sum as trees.
//   * Split-KV and the merge as in the fp32 kernel (the partials only when
//     split).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace hopper;

int cdiv(long long a, long long b) { return static_cast<int>((a + b - 1) / b); }

using bf16 = __nv_bfloat16;

// Device-memory access by element type: fp32 as is; bf16 widened to fp32
// (exact) on load and rounded to nearest even on store.
template <typename T>
struct Io;

template <>
struct Io<float> {
  __device__ static float load(const float* p) { return *p; }
  __device__ static float2 load2(const float* p) { return *reinterpret_cast<const float2*>(p); }
  __device__ static float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }
  __device__ static void store(float* p, float a) { *p = a; }
  __device__ static void store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
  __device__ static void store4(float* p, float4 a) { *reinterpret_cast<float4*>(p) = a; }
};

template <>
struct Io<bf16> {
  __device__ static float load(const bf16* p) { return __bfloat162float(*p); }
  __device__ static float2 load2(const bf16* p) {
    const uint32_t v = *reinterpret_cast<const uint32_t*>(p);
    return make_float2(bf16_lo(v), bf16_hi(v));
  }
  __device__ static float4 load4(const bf16* p) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    return make_float4(bf16_lo(v.x), bf16_hi(v.x), bf16_lo(v.y), bf16_hi(v.y));
  }
  __device__ static void store(bf16* p, float a) { *p = __float2bfloat16_rn(a); }
  __device__ static void store2(bf16* p, float a, float b) {
    *reinterpret_cast<uint32_t*>(p) = pack_bf16x2(a, b);
  }
  __device__ static void store4(bf16* p, float4 a) {
    *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16x2(a.x, a.y), pack_bf16x2(a.z, a.w));
  }
};

// ---------------------------------------------------------------------------
// fp32 FMA variant: D % 4 != 0.
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per K/V tile
constexpr int kLDP = kBK + 4;  // row stride of P
constexpr float kNegInf = -1e30f;

template <int NQ, typename T>  // value-column chunks of 64: D <= 64 * NQ
__global__ void __launch_bounds__(kThreads)
flash_attention_ffma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, T* __restrict__ o, int Sq, int Skv,
                            int D, int DP, int LD, float scale) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kBQ][LD]
  float* ks = qs + kBQ * LD;                    // [kBK][LD]
  float* vs = ks + kBK * LD;                    // [kBK][LD]
  float* ps = vs + kBK * LD;                    // [kBQ][kLDP]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const long long bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const T* qb = q + (bh * Sq + q0) * D;
  const T* kb = k + bh * Skv * D;
  const T* vb = v + bh * Skv * D;

  for (int e = tid; e < kBQ * DP; e += kThreads) {
    const int r = e / DP, c = e % DP;
    qs[r * LD + c] = (q0 + r < Sq && c < D) ? Io<T>::load(qb + (long long)r * D + c) : 0.f;
  }

  float m[4], l[4], acc[4][4 * NQ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NQ; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < Skv; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < kBK * DP; e += kThreads) {
      const int r = e / DP, c = e % DP;
      const bool in = k0 + r < Skv && c < D;
      const long long g = (long long)(k0 + r) * D + c;
      ks[r * LD + c] = in ? Io<T>::load(kb + g) : 0.f;
      vs[r * LD + c] = in ? Io<T>::load(vb + g) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < DP; d += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(qs + (ty * 4 + i) * LD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float t = fmaf(a[i].x, b[j].x, s[i][j]);
          t = fmaf(a[i].y, b[j].y, t);
          t = fmaf(a[i].z, b[j].z, t);
          s[i][j] = fmaf(a[i].w, b[j].w, t);
        }
    }

    // Online softmax: keys at or past Skv are masked; the 16 threads of a
    // row are 16 consecutive lanes of one warp.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mt = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = (k0 + tx + 16 * j < Skv) ? s[i][j] * scale : kNegInf;
        mt = fmaxf(mt, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float alpha = expf(m[i] - mt);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - mt);
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = mt;
#pragma unroll
      for (int c = 0; c < 4 * NQ; ++c) acc[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) ps[(ty * 4 + i) * kLDP + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

    for (int kk = 0; kk < kBK; kk += 4) {
      float4 p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = *reinterpret_cast<const float4*>(ps + (ty * 4 + i) * kLDP + kk);
#pragma unroll
      for (int cq = 0; cq < NQ; ++cq) {
        const int c = 64 * cq + 4 * tx;
        if (c >= DP) continue;
        const float4 v0 = *reinterpret_cast<const float4*>(vs + (kk + 0) * LD + c);
        const float4 v1 = *reinterpret_cast<const float4*>(vs + (kk + 1) * LD + c);
        const float4 v2 = *reinterpret_cast<const float4*>(vs + (kk + 2) * LD + c);
        const float4 v3 = *reinterpret_cast<const float4*>(vs + (kk + 3) * LD + c);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 pi = p[i];
          float& a0 = acc[i][4 * cq];
          float& a1 = acc[i][4 * cq + 1];
          float& a2 = acc[i][4 * cq + 2];
          float& a3 = acc[i][4 * cq + 3];
          a0 = fmaf(pi.w, v3.x, fmaf(pi.z, v2.x, fmaf(pi.y, v1.x, fmaf(pi.x, v0.x, a0))));
          a1 = fmaf(pi.w, v3.y, fmaf(pi.z, v2.y, fmaf(pi.y, v1.y, fmaf(pi.x, v0.y, a1))));
          a2 = fmaf(pi.w, v3.z, fmaf(pi.z, v2.z, fmaf(pi.y, v1.z, fmaf(pi.x, v0.z, a2))));
          a3 = fmaf(pi.w, v3.w, fmaf(pi.z, v2.w, fmaf(pi.y, v1.w, fmaf(pi.x, v0.w, a3))));
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= Sq) continue;
    T* orow = o + (bh * Sq + r) * D;
#pragma unroll
    for (int cq = 0; cq < NQ; ++cq)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 64 * cq + 4 * tx + e;
        if (c < D) Io<T>::store(orow + c, acc[i][4 * cq + e] / l[i]);
      }
  }
}

template <int NQ, typename T>
int launch_ffma(const T* q, const T* k, const T* v, T* o, int BH, int Sq, int Skv, int D,
                float scale, cudaStream_t stream) {
  const int DP = (D + 3) / 4 * 4;
  const int LD = DP % 8 == 0 ? DP + 4 : DP;  // an odd multiple of 4
  const int smem = ((kBQ + 2 * kBK) * LD + kBQ * kLDP) * 4;
  auto kernel = flash_attention_ffma_kernel<NQ, T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Sq + kBQ - 1) / kBQ, BH);
  kernel<<<grid, kThreads, smem, stream>>>(q, k, v, o, Sq, Skv, D, DP, LD, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_ffma_entry(const T* q, const T* k, const T* v, T* o, int BH, int Sq, int Skv, int D,
                      float scale, cudaStream_t s) {
  if (D <= 64) return launch_ffma<1, T>(q, k, v, o, BH, Sq, Skv, D, scale, s);
  if (D <= 128) return launch_ffma<2, T>(q, k, v, o, BH, Sq, Skv, D, scale, s);
  if (D <= 192) return launch_ffma<3, T>(q, k, v, o, BH, Sq, Skv, D, scale, s);
  return launch_ffma<4, T>(q, k, v, o, BH, Sq, Skv, D, scale, s);
}

// ---------------------------------------------------------------------------
// 3xTF32 tensor-core variant: fp32, D % 4 == 0.
// ---------------------------------------------------------------------------

constexpr int kConsumers = 256;               // two consumer warpgroups
constexpr int kTcThreads = kConsumers + 128;  // and one producer warpgroup
constexpr int kConsumerRegs = 232, kProducerRegs = 40;
constexpr int kSmemBudget = 227 * 1024;

// The head-dim tile (D padded up to it in the staged operands) and the
// longest key tile it fits in shared memory; the plan in
// ops/cuda/flash_attention.py mirrors both.
__host__ __device__ constexpr int head_tile(int d) { return d <= 64 ? 64 : d <= 128 ? 128 : 256; }
__host__ __device__ constexpr int max_key_tile(int dt) { return dt == 64 ? 64 : dt == 128 ? 32 : 16; }

template <int DT, int BK>
struct TcCfg {
  static constexpr int DSPLIT = DT == 256 ? 2 : 1;  // consumers sharing one 64-row block
  static constexpr int DN = DT / DSPLIT;            // output columns per consumer
  static constexpr int ROWS = 128 / DSPLIT;         // query rows per block
  static constexpr bool QREG = DT <= 64;            // Q split once, kept in registers
  static constexpr int KS = DT / 8 / DSPLIT;       // k8 steps of Q.K^T per consumer
  static constexpr int QC = 16;                     // k8 steps per Q chunk from shared memory
  static constexpr int PJ = BK / 8 < 4 ? BK / 8 : 4;  // key steps per P.V chunk
  static constexpr int LDQ = DT + 8;                // Q row stride in shared memory (floats)
  static constexpr int Q_BYTES = QREG ? 0 : ROWS * LDQ * 4;
  static constexpr int PART = DT * BK;              // floats of one hi or lo operand
  static constexpr int HALF_BYTES = 2 * PART * 4;   // K hi + lo, or V^T hi + lo
  static constexpr int STAGE_BYTES = 2 * HALF_BYTES;
  // DSPLIT = 2: each consumer's half of S, two tiles deep, [tile % 2][dh][BK / 2][128]
  static constexpr int X_BYTES = DSPLIT == 2 ? 2 * 2 * (BK / 2) * 128 * 4 : 0;
  static constexpr int FIT = (kSmemBudget - Q_BYTES - X_BYTES - 64) / STAGE_BYTES;
  static constexpr int NSTAGE = FIT < 4 ? FIT : 4;
  static constexpr int SMEM_BYTES = NSTAGE * STAGE_BYTES + Q_BYTES + X_BYTES + 2 * NSTAGE * 8;
  static_assert(NSTAGE >= 2, "fewer than two stages fit");
  static_assert(BK <= max_key_tile(DT) && DT == head_tile(DT), "unsupported tile");
  static_assert(QREG || KS % QC == 0, "Q chunks");
};

// K and V^T of every (batch*head, key tile) as the main kernel stages them:
// per tile [K hi | K lo | V^T hi | V^T lo], each part dt * bk floats. K is
// the B operand of S = Q.K^T (N = keys, K = d), V^T that of O = P.V (N = d,
// K = keys); within a k8 step position c holds element 0 2 4 6 1 3 5 7 [c].
// One block per tile: K and V come in through shared memory four floats a
// load (D % 4 == 0), and the image goes out in order.
__global__ void __launch_bounds__(256)
attention_kv_split_kernel(const float* __restrict__ k, const float* __restrict__ v,
                          float* __restrict__ img, int Skv, int D, int n_tiles, int dt, int bk) {
  extern __shared__ float4 kv4[];
  float* kv = reinterpret_cast<float*>(kv4);  // [2][bk][ld]: K, then V
  const int ld = dt + 4;
  const long long tile = blockIdx.x;  // bh * n_tiles + key tile
  const int k0 = static_cast<int>(tile % n_tiles) * bk;
  const long long row0 = tile / n_tiles * Skv + k0;  // first key's row in k and v
  const int q4 = dt / 4;
  for (int e = threadIdx.x; e < 2 * bk * q4; e += blockDim.x) {
    const int c = (e % q4) * 4, r = (e / q4) % bk, is_v = e / (q4 * bk);
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (k0 + r < Skv && c < D) val = Io<float>::load4((is_v ? v : k) + (row0 + r) * D + c);
    *reinterpret_cast<float4*>(kv + (is_v * bk + r) * ld + c) = val;
  }
  __syncthreads();
  const int part = dt * bk;
  float* dst = img + tile * 4 * part;
  for (int e = threadIdx.x; e < 2 * part; e += blockDim.x) {
    const int is_v = e / part, idx = e % part;
    const int nrows = is_v ? dt : bk;
    const int s = idx / (8 * nrows), f = idx % (8 * nrows);
    const int n = (f >> 6) * 8 + ((f >> 2) & 7);  // core-matrix row
    const int c = ((f >> 5) & 1) * 4 + (f & 3);   // K half, then column in it
    const int pc = c < 4 ? 2 * c : 2 * c - 7;
    const float val = is_v ? kv[(bk + 8 * s + pc) * ld + n] : kv[n * ld + 8 * s + pc];
    uint32_t hi, lo;
    split_tf32(val, hi, lo);
    dst[is_v * 2 * part + idx] = __uint_as_float(hi);
    dst[is_v * 2 * part + part + idx] = __uint_as_float(lo);
  }
}

// Epilogue of a consumer's 64 rows (row0, row0 + 8 in this lane) and DN
// columns from col0: o = acc / l in o's type, or, split (part_o), the
// split's unnormalised fp32 acc and (m, l) (write_ml: one consumer of the
// rows writes them). acc is the accumulator fragment of Wgmma; l is summed
// over the quad already.
template <int DN, typename T>
__device__ __forceinline__ void store_rows(const float* acc, float m0, float m1, float l0,
                                           float l1, T* __restrict__ o,
                                           float* __restrict__ part_o,
                                           float* __restrict__ part_ml, int bh, int row0,
                                           int Sq, int D, int col0, int t, bool write_ml) {
  const int row1 = row0 + 8;
  const long long rows = (long long)gridDim.y * Sq;
  float* part = part_o ? part_o + blockIdx.z * rows * D : nullptr;
  const long long r0 = (long long)bh * Sq + row0, r1 = r0 + 8;
#pragma unroll
  for (int j = 0; j < DN / 8; ++j) {
    const int d = col0 + 8 * j + 2 * t;
    if (d >= D) continue;
    const float* a = &acc[4 * j];
    if (part) {
      if (row0 < Sq) Io<float>::store2(part + r0 * D + d, a[0], a[1]);
      if (row1 < Sq) Io<float>::store2(part + r1 * D + d, a[2], a[3]);
    } else {
      if (row0 < Sq) Io<T>::store2(o + r0 * D + d, a[0] / l0, a[1] / l0);
      if (row1 < Sq) Io<T>::store2(o + r1 * D + d, a[2] / l1, a[3] / l1);
    }
  }
  if (part_o && write_ml && t == 0) {
    float2* ml = reinterpret_cast<float2*>(part_ml) + blockIdx.z * rows;
    if (row0 < Sq) ml[r0] = make_float2(m0, l0);
    if (row1 < Sq) ml[r1] = make_float2(m1, l1);
  }
}

// The consumer warpgroups: S, the online softmax, P.V and the epilogue.
template <int DT, int BK>
__device__ __forceinline__ void consume(const unsigned char* stages, const float* qs,
                                        float* xch, uint64_t* full, uint64_t* empty,
                                        const float* __restrict__ q, float* __restrict__ o,
                                        float* __restrict__ part_o, float* __restrict__ part_ml,
                                        int bh, int q0, int Sq, int Skv, int D, int t_begin,
                                        int t_end, float scale_log2) {
  using C = TcCfg<DT, BK>;
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int dh = wg % C::DSPLIT;                        // which output columns
  const int lrow = 64 * (wg / C::DSPLIT) + 16 * warp + g;  // rows lrow and lrow + 8
  const int row0 = q0 + lrow, row1 = row0 + 8;

  // Q fragment of k8 step s: {(g, 8s + 2t), (g + 8, 8s + 2t), (g, 8s + 2t + 1),
  // (g + 8, 8s + 2t + 1)}, the k order of the staged K.
  uint32_t qhi[C::QREG ? C::KS : 1][4], qlo[C::QREG ? C::KS : 1][4];
  if constexpr (C::QREG) {
    const float* qb = q + (long long)bh * Sq * D;
#pragma unroll
    for (int s = 0; s < C::KS; ++s) {
      const int d = 8 * s + 2 * t;
      float2 a = make_float2(0.f, 0.f), b = make_float2(0.f, 0.f);
      if (d < D) {
        if (row0 < Sq) a = Io<float>::load2(qb + (long long)row0 * D + d);
        if (row1 < Sq) b = Io<float>::load2(qb + (long long)row1 * D + d);
      }
      split_tf32(a.x, qhi[s][0], qlo[s][0]);
      split_tf32(b.x, qhi[s][1], qlo[s][1]);
      split_tf32(a.y, qhi[s][2], qlo[s][2]);
      split_tf32(b.y, qhi[s][3], qlo[s][3]);
    }
  }

  float acc[C::DN / 2];
#pragma unroll
  for (int c = 0; c < C::DN / 2; ++c) acc[c] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  // Q in registers: the two consumers take turns to issue S, so that one's
  // softmax overlaps the other's products. Consumer wg waits on named
  // barrier 2 + wg before issuing and, once it has, arrives on the other's;
  // consumer 0 goes first.
  if (C::QREG && wg == 1) asm volatile("bar.arrive 2, %0;" ::"n"(kConsumers) : "memory");

  for (int i = 0; i < t_end - t_begin; ++i) {
    const int st = i % C::NSTAGE;
    mbar_wait(&full[st], (i / C::NSTAGE) & 1);
    const uint32_t kb = smem_u32(stages + st * C::STAGE_BYTES);
    const uint32_t vb = kb + C::HALF_BYTES;

    // S = Q.K^T, three products per k8 step, smallest first.
    float s[BK / 2];
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) s[j] = 0.f;
    if constexpr (C::QREG) {
      if (wg == 0) asm volatile("bar.sync 2, %0;" ::"n"(kConsumers) : "memory");
      else asm volatile("bar.sync 3, %0;" ::"n"(kConsumers) : "memory");
      fence_regs<BK / 2>(s);
      fence_regs<4 * C::KS>(&qhi[0][0]);
      fence_regs<4 * C::KS>(&qlo[0][0]);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < C::KS; ++ks) {
        const uint64_t dhi = b_desc(kb + ks * BK * 32);
        const uint64_t dlo = b_desc(kb + C::PART * 4 + ks * BK * 32);
        Wgmma<BK>::mma(s, qhi[ks], dlo);
        Wgmma<BK>::mma(s, qlo[ks], dhi);
        Wgmma<BK>::mma(s, qhi[ks], dhi);
      }
      wgmma_commit();
      if (wg == 0) asm volatile("bar.arrive 3, %0;" ::"n"(kConsumers) : "memory");
      else if (i + 1 < t_end - t_begin) asm volatile("bar.arrive 2, %0;" ::"n"(kConsumers) : "memory");
      wgmma_wait_all();
      fence_regs<BK / 2>(s);
    } else {
#pragma unroll 1
      for (int c0 = dh * C::KS; c0 < (dh + 1) * C::KS; c0 += C::QC) {
        uint32_t ahi[C::QC][4], alo[C::QC][4];
#pragma unroll
        for (int j = 0; j < C::QC; ++j) {
          const float* qr = qs + lrow * C::LDQ + 8 * (c0 + j) + 2 * t;
          const float2 a = *reinterpret_cast<const float2*>(qr);
          const float2 b = *reinterpret_cast<const float2*>(qr + 8 * C::LDQ);
          split_tf32(a.x, ahi[j][0], alo[j][0]);
          split_tf32(b.x, ahi[j][1], alo[j][1]);
          split_tf32(a.y, ahi[j][2], alo[j][2]);
          split_tf32(b.y, ahi[j][3], alo[j][3]);
        }
        fence_regs<BK / 2>(s);
        fence_regs<4 * C::QC>(&ahi[0][0]);
        fence_regs<4 * C::QC>(&alo[0][0]);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < C::QC; ++j) {
          const int ks = c0 + j;
          const uint64_t dhi = b_desc(kb + ks * BK * 32);
          const uint64_t dlo = b_desc(kb + C::PART * 4 + ks * BK * 32);
          Wgmma<BK>::mma(s, ahi[j], dlo);
          Wgmma<BK>::mma(s, alo[j], dhi);
          Wgmma<BK>::mma(s, ahi[j], dhi);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs<BK / 2>(s);
      }
      if constexpr (C::DSPLIT == 2) {
        // S = the two consumers' halves over d, swapped through shared
        // memory; a + b == b + a, so both hold the same bits. The buffers
        // alternate by tile: a consumer can reach tile i + 2's writes only
        // after the other has passed tile i + 1's barrier, past its reads.
        const int ti = threadIdx.x & 127;
        float* mine = xch + ((i & 1) * 2 + dh) * (BK / 2) * 128;
        const float* theirs = xch + ((i & 1) * 2 + (dh ^ 1)) * (BK / 2) * 128;
#pragma unroll
        for (int c = 0; c < BK / 2; ++c) mine[c * 128 + ti] = s[c];
        asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
#pragma unroll
        for (int c = 0; c < BK / 2; ++c) s[c] += theirs[c * 128 + ti];
      }
    }

    // Online softmax in log2 units. s[4j + e]: row g (e < 2) or g + 8, key
    // 8j + 2t + (e & 1) of the tile.
    const int kbase = (t_begin + i) * BK;
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = kbase + 8 * j + 2 * t + (e & 1) < Skv ? s[4 * j + e] * scale_log2 : -INFINITY;
        s[4 * j + e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
      }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float alpha0 = exp2f(m0 - mx0), alpha1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[4 * j + e] = exp2f(s[4 * j + e] - (e < 2 ? m0 : m1));
        if (e < 2) ps0 += s[4 * j + e]; else ps1 += s[4 * j + e];
      }
    l0 = l0 * alpha0 + ps0;  // this lane's columns; the quad is summed at the end
    l1 = l1 * alpha1 + ps1;

    // This tile's P.V in a fresh accumulator, PJ key steps at a time so that
    // only one chunk's split P is live. P as the A fragment of key step j:
    // {(g, 2t), (g + 8, 2t), (g, 2t + 1), (g + 8, 2t + 1)} = s[4j + {0, 2, 1, 3}],
    // the k order of the staged V^T.
    float tile[C::DN / 2];
#pragma unroll
    for (int c = 0; c < C::DN / 2; ++c) tile[c] = 0.f;
#pragma unroll
    for (int j0 = 0; j0 < BK / 8; j0 += C::PJ) {
      uint32_t phi[4 * C::PJ], plo[4 * C::PJ];
#pragma unroll
      for (int jj = 0; jj < C::PJ; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int slot = 4 * jj + (((e & 1) << 1) | (e >> 1));
          split_tf32(s[4 * (j0 + jj) + e], phi[slot], plo[slot]);
        }
      fence_regs<C::DN / 2>(tile);
      fence_regs<4 * C::PJ>(phi);
      fence_regs<4 * C::PJ>(plo);
      wgmma_fence();
#pragma unroll
      for (int jj = 0; jj < C::PJ; ++jj) {
        const uint32_t vs = vb + (j0 + jj) * DT * 32 + dh * (C::DN / 8) * 256;
        const uint64_t dhi = b_desc(vs);
        Wgmma<C::DN>::mma(tile, &phi[4 * jj], b_desc(vs + C::PART * 4));
        Wgmma<C::DN>::mma(tile, &plo[4 * jj], dhi);
        Wgmma<C::DN>::mma(tile, &phi[4 * jj], dhi);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<C::DN / 2>(tile);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
#pragma unroll
    for (int c = 0; c < C::DN / 2; ++c) acc[c] = fmaf(acc[c], (c & 2) ? alpha1 : alpha0, tile[c]);
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  store_rows<C::DN>(acc, m0, m1, l0, l1, o, part_o, part_ml, bh, row0, Sq, D, dh * C::DN, t,
                    dh == 0);
}

template <int DT, int BK>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_attention_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ img,
                              float* __restrict__ o, float* __restrict__ part_o,
                              float* __restrict__ part_ml, int Sq, int Skv, int D, int n_tiles,
                              int tiles_per_split, float scale_log2) {
  using C = TcCfg<DT, BK>;
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* stages = smem;  // [NSTAGE][STAGE_BYTES]
  float* qs = reinterpret_cast<float*>(smem + C::NSTAGE * C::STAGE_BYTES);  // [ROWS][LDQ]
  float* xch = qs + C::Q_BYTES / 4;                                        // X_BYTES
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::NSTAGE * C::STAGE_BYTES + C::Q_BYTES +
                                               C::X_BYTES);
  uint64_t* empty = full + C::NSTAGE;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * C::ROWS;
  const int t_begin = blockIdx.z * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);

  if (threadIdx.x == 0) {
    for (int i = 0; i < C::NSTAGE; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if constexpr (!C::QREG) {
    // Q's rows once as fp32, zero past Sq and D (D % 4 == 0: whole groups of 4).
    const float* qb = q + (long long)bh * Sq * D;
    for (int e = threadIdx.x; e < C::ROWS * (DT / 4); e += kTcThreads) {
      const int r = e / (DT / 4), c = (e % (DT / 4)) * 4;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q0 + r < Sq && c < D) val = Io<float>::load4(qb + (long long)(q0 + r) * D + c);
      *reinterpret_cast<float4*>(qs + r * C::LDQ + c) = val;
    }
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // Producer: one thread keeps the K / V^T stages in flight.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x != kConsumers) return;
    const float* base = img + (long long)bh * n_tiles * (C::STAGE_BYTES / 4);
    for (int i = 0; i < t_end - t_begin; ++i) {
      const int st = i % C::NSTAGE;
      mbar_wait(&empty[st], ((i / C::NSTAGE) & 1) ^ 1);
      mbar_expect_tx(&full[st], C::STAGE_BYTES);
      const float* src = base + (long long)(t_begin + i) * (C::STAGE_BYTES / 4);
      unsigned char* dst = stages + st * C::STAGE_BYTES;
      bulk_load(dst, src, C::HALF_BYTES, &full[st]);
      bulk_load(dst + C::HALF_BYTES, src + C::HALF_BYTES / 4, C::HALF_BYTES, &full[st]);
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    consume<DT, BK>(stages, qs, xch, full, empty, q, o, part_o, part_ml, bh, q0, Sq, Skv, D,
                    t_begin, t_end, scale_log2);
  }
}

// o = sum_s 2^(m_s - M) O_s / sum_s 2^(m_s - M) l_s with M = max_s m_s, the
// splits in order: the result is the same from run to run. o in its type.
template <typename T>
__global__ void attention_merge_kernel(const float* __restrict__ part_o,
                                       const float* __restrict__ part_ml, T* __restrict__ o,
                                       long long rows, int D, int splits) {
  const float2* ml = reinterpret_cast<const float2*>(part_ml);
  const int dq = D / 4;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < rows * dq;
       i += (long long)gridDim.x * blockDim.x) {
    const long long r = i / dq;
    const int c = static_cast<int>(i % dq) * 4;
    float mx = -INFINITY;
    for (int s = 0; s < splits; ++s) mx = fmaxf(mx, ml[s * rows + r].x);
    float l = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < splits; ++s) {
      const float2 p = ml[s * rows + r];
      const float w = exp2f(p.x - mx);
      l = fmaf(w, p.y, l);
      const float4 po = *reinterpret_cast<const float4*>(part_o + (s * rows + r) * D + c);
      acc.x = fmaf(w, po.x, acc.x);
      acc.y = fmaf(w, po.y, acc.y);
      acc.z = fmaf(w, po.z, acc.z);
      acc.w = fmaf(w, po.w, acc.w);
    }
    Io<T>::store4(o + r * D + c, make_float4(acc.x / l, acc.y / l, acc.z / l, acc.w / l));
  }
}

// The split partials (splits > 1): fp32 O of every split and query row,
// then (m, l), at `offset` bytes into the workspace.
struct Partials {
  float* o = nullptr;
  float* ml = nullptr;
};

long long partial_bytes(int BH, int Sq, int D, int splits) {
  return splits > 1 ? 4LL * splits * BH * Sq * (D + 2) : 0;
}

Partials partials_at(void* workspace, long long offset, int BH, int Sq, int D, int splits) {
  Partials p;
  if (splits > 1) {
    p.o = reinterpret_cast<float*>(static_cast<char*>(workspace) + offset);
    p.ml = p.o + (long long)splits * BH * Sq * D;
  }
  return p;
}

template <typename T>
void launch_merge(const Partials& p, T* o, int BH, int Sq, int D, int splits,
                  cudaStream_t stream) {
  const long long rows = (long long)BH * Sq;
  const long long n = rows * (D / 4);
  const int blocks = cdiv(n, 256) < 8192 ? cdiv(n, 256) : 8192;
  attention_merge_kernel<T><<<blocks, 256, 0, stream>>>(p.o, p.ml, o, rows, D, splits);
}

// Workspace: the K / V^T images, then (splits > 1) the partial O and (m, l).
struct TcLayout {
  int n_tiles = 0, tiles_per_split = 0;
  long long image_bytes = 0, partial_offset = 0, bytes = 0;
};

TcLayout tc_layout(int BH, int Sq, int Skv, int D, int bk, int splits) {
  TcLayout L;
  const int dt = head_tile(D);
  L.n_tiles = cdiv(Skv, bk);
  L.tiles_per_split = cdiv(L.n_tiles, splits);
  L.image_bytes = (long long)BH * L.n_tiles * 16 * dt * bk;
  L.partial_offset = (L.image_bytes + 255) / 256 * 256;
  L.bytes = splits > 1 ? L.partial_offset + partial_bytes(BH, Sq, D, splits) : L.image_bytes;
  return L;
}

template <int DT, int BK>
int launch_tc(const float* q, const float* k, const float* v, float* o, int BH, int Sq, int Skv,
              int D, float scale, int splits, void* workspace, long long workspace_bytes,
              cudaStream_t stream) {
  using C = TcCfg<DT, BK>;
  const TcLayout L = tc_layout(BH, Sq, Skv, D, BK, splits);
  // Every split must own at least one key tile: the plan's split count.
  if (cdiv(L.n_tiles, L.tiles_per_split) != splits || !workspace || workspace_bytes < L.bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  float* img = static_cast<float*>(workspace);
  const Partials part = partials_at(workspace, L.partial_offset, BH, Sq, D, splits);

  attention_kv_split_kernel<<<BH * L.n_tiles, 256, 2 * BK * (DT + 4) * 4, stream>>>(
      k, v, img, Skv, D, L.n_tiles, DT, BK);

  auto kernel = flash_attention_tf32x3_kernel<DT, BK>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale_log2 = static_cast<float>(static_cast<double>(scale) * 1.4426950408889634);
  dim3 grid(cdiv(Sq, C::ROWS), BH, splits);
  kernel<<<grid, kTcThreads, C::SMEM_BYTES, stream>>>(q, img, o, part.o, part.ml, Sq, Skv, D,
                                                      L.n_tiles, L.tiles_per_split, scale_log2);
  if (splits > 1) launch_merge<float>(part, o, BH, Sq, D, splits, stream);
  return static_cast<int>(cudaGetLastError());
}

int launch_tc_entry(int key_tile, const float* q, const float* k, const float* v, float* o,
                    int BH, int Sq, int Skv, int D, float scale, int splits, void* ws,
                    long long ws_bytes, cudaStream_t s) {
  switch (head_tile(D) * 1000 + key_tile) {
    case 64008: return launch_tc<64, 8>(q, k, v, o, BH, Sq, Skv, D, scale, splits, ws, ws_bytes, s);
    case 64016: return launch_tc<64, 16>(q, k, v, o, BH, Sq, Skv, D, scale, splits, ws, ws_bytes, s);
    case 64032: return launch_tc<64, 32>(q, k, v, o, BH, Sq, Skv, D, scale, splits, ws, ws_bytes, s);
    case 64064: return launch_tc<64, 64>(q, k, v, o, BH, Sq, Skv, D, scale, splits, ws, ws_bytes, s);
    case 128008: return launch_tc<128, 8>(q, k, v, o, BH, Sq, Skv, D, scale, splits, ws, ws_bytes, s);
    case 128016: return launch_tc<128, 16>(q, k, v, o, BH, Sq, Skv, D, scale, splits, ws, ws_bytes, s);
    case 128032: return launch_tc<128, 32>(q, k, v, o, BH, Sq, Skv, D, scale, splits, ws, ws_bytes, s);
    case 256008: return launch_tc<256, 8>(q, k, v, o, BH, Sq, Skv, D, scale, splits, ws, ws_bytes, s);
    case 256016: return launch_tc<256, 16>(q, k, v, o, BH, Sq, Skv, D, scale, splits, ws, ws_bytes, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// bf16 tensor-core variant: D % 8 == 0.
// ---------------------------------------------------------------------------

// The longest key tile at head tile dt: four stages of K and V fit shared
// memory, and S and P (BK / 2 registers each) fit beside O and the tile's
// accumulator (DN / 2 each), 192 of the consumers' 232 at every head tile.
// The plan mirrors it.
__host__ __device__ constexpr int max_key_tile_bf16(int dt) {
  return dt == 64 ? 128 : dt == 128 ? 64 : 32;
}

template <int DT, int BK>
struct Bf16Cfg {
  static constexpr int DSPLIT = DT == 256 ? 2 : 1;  // consumers sharing one 64-row block
  static constexpr int DN = DT / DSPLIT;            // output columns per consumer
  static constexpr int ROWS = 128 / DSPLIT;         // query rows per block
  static constexpr int CHUNKS = DT / 64;            // 64-column (128-byte) chunks of a row
  static constexpr int KS = DT / 16 / DSPLIT;       // k16 steps of Q.K^T per consumer
  static constexpr int Q_CHUNK = ROWS * 128;        // bytes of one Q chunk
  static constexpr int Q_BYTES = CHUNKS * Q_CHUNK;
  static constexpr int KV_CHUNK = BK * 128;         // bytes of one K or V chunk
  static constexpr int HALF_BYTES = CHUNKS * KV_CHUNK;  // K, or V, of one stage
  static constexpr int STAGE_BYTES = 2 * HALF_BYTES;
  // DSPLIT = 2: each consumer's half of S, two tiles deep, [tile % 2][dh][BK / 2][128]
  static constexpr int X_BYTES = DSPLIT == 2 ? 2 * 2 * (BK / 2) * 128 * 4 : 0;
  // 1024 bytes to align the dynamic shared memory for the swizzle atoms
  static constexpr int FIT = (kSmemBudget - 1024 - Q_BYTES - X_BYTES - 128) / STAGE_BYTES;
  static constexpr int NSTAGE = FIT < 4 ? FIT : 4;
  static constexpr int SMEM_BYTES =
      1024 + NSTAGE * STAGE_BYTES + Q_BYTES + X_BYTES + (2 * NSTAGE + 1) * 8;
  static_assert(NSTAGE >= 2, "fewer than two stages fit");
  static_assert(BK % 16 == 0 && BK <= max_key_tile_bf16(DT) && DT == head_tile(DT),
                "unsupported tile");
};

// 2^x on the MUFU (ex2.approx, relative error near 2^-22; results below
// 2^-126 flush to zero, 2^-inf = 0), without exp2f's range fix-ups.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// a[i] = op(a[i], a[i + W]) for i < W, then W / 2 ... 1: a[0] becomes op
// over a[0 .. 2W) in a tree (each index a constant once inlined).
template <int W, typename Op>
__device__ __forceinline__ void fold_tree(float* a, Op op) {
  if constexpr (W >= 1) {
#pragma unroll
    for (int i = 0; i < W; ++i) a[i] = op(a[i], a[i + W]);
    fold_tree<W / 2>(a, op);
  }
}

// op folded over this lane's BK / 4 values of each row of s (row g: e < 2,
// row g + 8: e >= 2, below) as a tree, so that the chain of dependent
// instructions is log2(BK / 4) long, not BK / 4.
template <int BK, typename Op>
__device__ __forceinline__ void row_trees(const float* s, float& r0, float& r1, Op op) {
  float a[BK / 8], b[BK / 8];
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    a[j] = op(s[4 * j], s[4 * j + 1]);
    b[j] = op(s[4 * j + 2], s[4 * j + 3]);
  }
  fold_tree<BK / 16>(a, op);
  fold_tree<BK / 16>(b, op);
  r0 = a[0];
  r1 = b[0];
}

// Online softmax of one key tile in log2 units (c = scale * log2(e)), for
// this lane's rows g and g + 8: s[4j + e] holds row g (e < 2) or g + 8, key
// kbase + 8j + 2t + (e & 1). Updates m and l (l over this lane's keys; the
// quad is summed at the end), returns the rescale alpha of each row, and
// writes p's two bf16 parts packed as P.V's A fragments: register r holds
// keys (2r, 2r + 1) of the accumulator's order, so registers 4kk..4kk + 3
// are k16 step kk. A tile whose keys all lie below Skv takes the row max
// of the raw scores (scaling by c > 0 keeps the order of rounded values;
// c < 0 reverses it, so the min) and p = 2^(s c - m) as one FMA; the tile
// that crosses Skv scales first and masks the keys past it to -inf.
template <int BK>
__device__ __forceinline__ void softmax_tile(float* s, uint32_t* phi, uint32_t* plo, float& m0,
                                             float& m1, float& l0, float& l1, float& alpha0,
                                             float& alpha1, int kbase, int Skv, int t, float c) {
  const auto max = [](float x, float y) { return fmaxf(x, y); };
  float mx0, mx1, k = c;  // the row maxima of c * s, and the factor s still needs
  if (kbase + BK > Skv) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[4 * j + e] = kbase + 8 * j + 2 * t + (e & 1) < Skv ? s[4 * j + e] * c : -INFINITY;
    row_trees<BK>(s, mx0, mx1, max);
    k = 1.f;
  } else {
    if (c >= 0.f) row_trees<BK>(s, mx0, mx1, max);
    else row_trees<BK>(s, mx0, mx1, [](float x, float y) { return fminf(x, y); });
    mx0 *= c;
    mx1 *= c;
  }
  mx0 = fmaxf(m0, mx0);
  mx1 = fmaxf(m1, mx1);
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  alpha0 = ex2(m0 - mx0);
  alpha1 = ex2(m1 - mx1);
  m0 = mx0;
  m1 = mx1;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[4 * j + e] = ex2(fmaf(s[4 * j + e], k, e < 2 ? -m0 : -m1));
  float ps0, ps1;
  row_trees<BK>(s, ps0, ps1, [](float x, float y) { return x + y; });
  l0 = l0 * alpha0 + ps0;
  l1 = l1 * alpha1 + ps1;
#pragma unroll
  for (int r = 0; r < BK / 4; ++r) {
    const uint32_t hi = pack_bf16x2(s[2 * r], s[2 * r + 1]);
    plo[r] = pack_bf16x2(s[2 * r] - bf16_lo(hi), s[2 * r + 1] - bf16_hi(hi));
    phi[r] = hi;
  }
}

// Head tile 256: S = the two consumers' halves over d, swapped through
// shared memory; a + b == b + a, so both hold the same bits. The buffers
// alternate by tile: a consumer can reach tile i + 2's writes only after
// the other has passed tile i + 1's barrier, past its reads.
template <int BK>
__device__ __forceinline__ void swap_halves(float* s, float* xch, int i, int dh) {
  const int ti = threadIdx.x & 127;
  float* mine = xch + ((i & 1) * 2 + dh) * (BK / 2) * 128;
  const float* theirs = xch + ((i & 1) * 2 + (dh ^ 1)) * (BK / 2) * 128;
#pragma unroll
  for (int c = 0; c < BK / 2; ++c) mine[c * 128 + ti] = s[c];
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
#pragma unroll
  for (int c = 0; c < BK / 2; ++c) s[c] += theirs[c * 128 + ti];
}

// S = Q.K^T of one stage over this consumer's k16 steps of d, into s
// (overwritten). q_rows: this consumer's first row in Q's chunk 0.
template <int DT, int BK>
__device__ __forceinline__ void issue_s(float* s, uint32_t q_rows, uint32_t kb, int dh) {
  using C = Bf16Cfg<DT, BK>;
#pragma unroll
  for (int ks = 0; ks < C::KS; ++ks) {
    const int kk = dh * C::KS + ks;  // k16 step over d: chunk kk / 4, 32 bytes a step
    const uint32_t off = (kk / 4) * C::Q_CHUNK + (kk % 4) * 32;
    const uint64_t a = sw128_desc(q_rows + off);
    const uint64_t b = sw128_desc(kb + (kk / 4) * C::KV_CHUNK + (kk % 4) * 32);
    WgmmaBf16SS<BK>::mma(s, a, b, ks > 0);
  }
}

// tile = P.V of one stage, p's lo part before its hi part at each k16 step;
// V MN-major, this consumer's DN columns from chunk dh * DN / 64.
template <int DT, int BK>
__device__ __forceinline__ void issue_pv(float* tile, const uint32_t* phi, const uint32_t* plo,
                                         uint32_t vb, int dh) {
  using C = Bf16Cfg<DT, BK>;
  const uint32_t v0 = vb + dh * (C::DN / 64) * C::KV_CHUNK;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t b = sw128_desc(v0 + kk * 2048, C::KV_CHUNK);
    WgmmaBf16T<C::DN>::mma(tile, &plo[4 * kk], b, kk > 0);
    WgmmaBf16T<C::DN>::mma(tile, &phi[4 * kk], b, 1);
  }
}

// The consumer warpgroups. Tile i's P.V and tile i + 1's S are issued
// together and waited for together: at the wait P (BK / 2 registers), s
// (BK / 2), O and the tile accumulator (DN / 2 each) are live. Running
// tile i + 1's softmax under this consumer's own P.V of tile i (waiting for
// S alone) kept a second tile's P live and ran slower on an H100 (PERF.md):
// the other consumer's products already cover the softmax.
template <int DT, int BK>
__device__ __forceinline__ void consume_bf16(const unsigned char* stages, const unsigned char* qs,
                                             float* xch, uint64_t* full, uint64_t* empty,
                                             uint64_t* qbar, bf16* __restrict__ o,
                                             float* __restrict__ part_o,
                                             float* __restrict__ part_ml, int bh, int q0, int Sq,
                                             int Skv, int D, int t_begin, int t_end,
                                             float scale_log2) {
  using C = Bf16Cfg<DT, BK>;
  constexpr bool PINGPONG = C::DSPLIT == 1;
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int dh = wg % C::DSPLIT;                          // which output columns
  const int qrow = 64 * (wg / C::DSPLIT);                 // this consumer's rows in the block
  const int row0 = q0 + qrow + 16 * warp + g;             // rows row0 and row0 + 8
  const int n = t_end - t_begin;
  const uint32_t q_rows = smem_u32(qs) + qrow * 128;
  const uint32_t st0 = smem_u32(stages);

  // Consumer wg waits on named barrier 2 + wg before it issues and arrives
  // on the other's once it has; consumer 0 goes first. Each issues n + 1
  // times; consumer 1 does not arrive after its last.
  auto sched_sync = [&]() {
    if constexpr (PINGPONG) {
      if (wg == 0) asm volatile("bar.sync 2, %0;" ::"n"(kConsumers) : "memory");
      else asm volatile("bar.sync 3, %0;" ::"n"(kConsumers) : "memory");
    }
  };
  auto sched_arrive = [&](bool last) {
    if constexpr (PINGPONG) {
      if (wg == 0) asm volatile("bar.arrive 3, %0;" ::"n"(kConsumers) : "memory");
      else if (!last) asm volatile("bar.arrive 2, %0;" ::"n"(kConsumers) : "memory");
    }
  };

  // s and tile are overwritten by each tile's first product (scale-d 0)
  float acc[C::DN / 2], tile[C::DN / 2], s[BK / 2], alpha[2];
  uint32_t phi[BK / 4], plo[BK / 4];  // p's two bf16 parts
#pragma unroll
  for (int c = 0; c < C::DN / 2; ++c) acc[c] = tile[c] = 0.f;
#pragma unroll
  for (int j = 0; j < BK / 2; ++j) s[j] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  if (PINGPONG && wg == 1) asm volatile("bar.arrive 2, %0;" ::"n"(kConsumers) : "memory");

  // Tile 0's S and softmax.
  mbar_wait(qbar, 0);
  mbar_wait(&full[0], 0);
  sched_sync();
  wgmma_fence();
  issue_s<DT, BK>(s, q_rows, st0, dh);
  wgmma_commit();
  sched_arrive(false);
  wgmma_wait_all();
  fence_regs<BK / 2>(s);
  if constexpr (C::DSPLIT == 2) swap_halves<BK>(s, xch, 0, dh);
  softmax_tile<BK>(s, phi, plo, m0, m1, l0, l1, alpha[0], alpha[1], t_begin * BK, Skv, t,
                   scale_log2);

  // Tile i: S of tile i + 1 and P.V of tile i in one issue, then, both
  // done, tile i folded into O and tile i + 1's softmax (under the other
  // consumer's products).
  for (int i = 0; i < n; ++i) {
    const bool next = i + 1 < n;
    const int st = i % C::NSTAGE, nst = (i + 1) % C::NSTAGE;
    if (next) mbar_wait(&full[nst], ((i + 1) / C::NSTAGE) & 1);
    sched_sync();
    fence_regs<BK / 4>(phi);
    fence_regs<BK / 4>(plo);
    wgmma_fence();
    if (next) issue_s<DT, BK>(s, q_rows, st0 + nst * C::STAGE_BYTES, dh);
    issue_pv<DT, BK>(tile, phi, plo, st0 + st * C::STAGE_BYTES + C::HALF_BYTES, dh);
    wgmma_commit();
    sched_arrive(!next);
    wgmma_wait_all();
    fence_regs<C::DN / 2>(tile);
    fence_regs<BK / 4>(phi);
    fence_regs<BK / 4>(plo);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
#pragma unroll
    for (int c = 0; c < C::DN / 2; ++c) acc[c] = fmaf(acc[c], alpha[(c >> 1) & 1], tile[c]);
    if (next) {
      fence_regs<BK / 2>(s);
      if constexpr (C::DSPLIT == 2) swap_halves<BK>(s, xch, i + 1, dh);
      softmax_tile<BK>(s, phi, plo, m0, m1, l0, l1, alpha[0], alpha[1], (t_begin + i + 1) * BK,
                       Skv, t, scale_log2);
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  store_rows<C::DN>(acc, m0, m1, l0, l1, o, part_o, part_ml, bh, row0, Sq, D, dh * C::DN, t,
                    dh == 0);
}

template <int DT, int BK>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_attention_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                            const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap, bf16* __restrict__ o,
                            float* __restrict__ part_o, float* __restrict__ part_ml, int Sq,
                            int Skv, int D, int n_tiles, int tiles_per_split, float scale_log2) {
  using C = Bf16Cfg<DT, BK>;
  extern __shared__ __align__(1024) unsigned char smem_bf16[];
  // The 128-byte swizzle repeats every 1024 bytes: every region starts on
  // such a boundary.
  unsigned char* stages = smem_bf16 + ((1024 - (smem_u32(smem_bf16) & 1023)) & 1023);
  unsigned char* qs = stages + C::NSTAGE * C::STAGE_BYTES;  // [CHUNKS][ROWS][128 bytes]
  float* xch = reinterpret_cast<float*>(qs + C::Q_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(qs + C::Q_BYTES + C::X_BYTES);
  uint64_t* empty = full + C::NSTAGE;
  uint64_t* qbar = empty + C::NSTAGE;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * C::ROWS;
  const int t_begin = blockIdx.z * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);

  if (threadIdx.x == 0) {
    for (int i = 0; i < C::NSTAGE; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumers / 32);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // Producer: one thread loads Q once and keeps the K / V stages in flight.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x != kConsumers) return;
    mbar_expect_tx(qbar, C::Q_BYTES);
    for (int c = 0; c < C::CHUNKS; ++c) tma_load_3d(qs + c * C::Q_CHUNK, &qmap, qbar, 64 * c, q0, bh);
    for (int i = 0; i < t_end - t_begin; ++i) {
      const int st = i % C::NSTAGE;
      mbar_wait(&empty[st], ((i / C::NSTAGE) & 1) ^ 1);
      mbar_expect_tx(&full[st], C::STAGE_BYTES);
      unsigned char* dst = stages + st * C::STAGE_BYTES;
      const int key0 = (t_begin + i) * BK;
      for (int c = 0; c < C::CHUNKS; ++c) {
        tma_load_3d(dst + c * C::KV_CHUNK, &kmap, &full[st], 64 * c, key0, bh);
        tma_load_3d(dst + C::HALF_BYTES + c * C::KV_CHUNK, &vmap, &full[st], 64 * c, key0, bh);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    consume_bf16<DT, BK>(stages, qs, xch, full, empty, qbar, o, part_o, part_ml, bh, q0, Sq, Skv,
                         D, t_begin, t_end, scale_log2);
  }
}

// The TMA map of a contiguous (BH, rows, D) bf16 tensor for boxes of 64
// columns x box_rows rows of one (batch*head), 128-byte swizzle; rows past
// `rows` and columns past D read as zeros.
bool encode_rows_map(CUtensorMap* map, const void* base, int BH, int rows, int D, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {2ull * D, 2ull * D * rows};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

template <int DT, int BK>
int launch_bf16(const bf16* q, const bf16* k, const bf16* v, bf16* o, int BH, int Sq, int Skv,
                int D, float scale, int splits, void* workspace, long long workspace_bytes,
                cudaStream_t stream) {
  using C = Bf16Cfg<DT, BK>;
  const int n_tiles = cdiv(Skv, BK), tiles_per_split = cdiv(n_tiles, splits);
  // Every split must own at least one key tile: the plan's split count.
  if (cdiv(n_tiles, tiles_per_split) != splits ||
      (splits > 1 && (!workspace || workspace_bytes < partial_bytes(BH, Sq, D, splits))))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap qmap, kmap, vmap;
  if (!encode_tiled()) return static_cast<int>(cudaErrorNotSupported);
  if (!encode_rows_map(&qmap, q, BH, Sq, D, C::ROWS) ||
      !encode_rows_map(&kmap, k, BH, Skv, D, BK) || !encode_rows_map(&vmap, v, BH, Skv, D, BK))
    return static_cast<int>(cudaErrorInvalidValue);
  const Partials part = partials_at(workspace, 0, BH, Sq, D, splits);

  auto kernel = flash_attention_bf16_kernel<DT, BK>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale_log2 = static_cast<float>(static_cast<double>(scale) * 1.4426950408889634);
  dim3 grid(cdiv(Sq, C::ROWS), BH, splits);
  kernel<<<grid, kTcThreads, C::SMEM_BYTES, stream>>>(qmap, kmap, vmap, o, part.o, part.ml, Sq,
                                                      Skv, D, n_tiles, tiles_per_split,
                                                      scale_log2);
  if (splits > 1) launch_merge<bf16>(part, o, BH, Sq, D, splits, stream);
  return static_cast<int>(cudaGetLastError());
}

int launch_bf16_entry(int key_tile, const bf16* q, const bf16* k, const bf16* v, bf16* o, int BH,
                      int Sq, int Skv, int D, float scale, int splits, void* ws, long long ws_bytes,
                      cudaStream_t s) {
  switch (head_tile(D) * 1000 + key_tile) {
    case 64016: return launch_bf16<64, 16>(q, k, v, o, BH, Sq, Skv, D, scale, splits, ws, ws_bytes, s);
    case 64032: return launch_bf16<64, 32>(q, k, v, o, BH, Sq, Skv, D, scale, splits, ws, ws_bytes, s);
    case 64064: return launch_bf16<64, 64>(q, k, v, o, BH, Sq, Skv, D, scale, splits, ws, ws_bytes, s);
    case 64128: return launch_bf16<64, 128>(q, k, v, o, BH, Sq, Skv, D, scale, splits, ws, ws_bytes, s);
    case 128016: return launch_bf16<128, 16>(q, k, v, o, BH, Sq, Skv, D, scale, splits, ws, ws_bytes, s);
    case 128032: return launch_bf16<128, 32>(q, k, v, o, BH, Sq, Skv, D, scale, splits, ws, ws_bytes, s);
    case 128064: return launch_bf16<128, 64>(q, k, v, o, BH, Sq, Skv, D, scale, splits, ws, ws_bytes, s);
    case 256016: return launch_bf16<256, 16>(q, k, v, o, BH, Sq, Skv, D, scale, splits, ws, ws_bytes, s);
    case 256032: return launch_bf16<256, 32>(q, k, v, o, BH, Sq, Skv, D, scale, splits, ws, ws_bytes, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The entry for one element type: the FMA kernel (variant 0) or the
// tensor-core kernel (variant 1: 16-byte rows, D % 4 == 0 in fp32, D % 8 == 0
// in bf16, and 16-byte aligned tensors).
template <typename T>
int run(const void* q_, const void* k_, const void* v_, void* o_, int BH, int Sq, int Skv, int D,
        float scale, int variant, int rows, int key_tile, int splits, void* workspace,
        long long workspace_bytes, cudaStream_t s) {
  const T* q = static_cast<const T*>(q_);
  const T* k = static_cast<const T*>(k_);
  const T* v = static_cast<const T*>(v_);
  T* o = static_cast<T*>(o_);
  if (variant == 0) {
    if (rows != kBQ || key_tile != kBK || splits != 1) return static_cast<int>(cudaErrorInvalidValue);
    return launch_ffma_entry<T>(q, k, v, o, BH, Sq, Skv, D, scale, s);
  }
  const uintptr_t align = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o);
  constexpr bool kBf16 = sizeof(T) == 2;
  const int dt = head_tile(D);
  if (variant != 1 || D % (16 / sizeof(T)) != 0 || align % 16 != 0 ||
      rows != (dt == 256 ? 64 : 128) ||
      key_tile > (kBf16 ? max_key_tile_bf16(dt) : max_key_tile(dt)))
    return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (kBf16)
    return launch_bf16_entry(key_tile, q, k, v, o, BH, Sq, Skv, D, scale, splits, workspace,
                             workspace_bytes, s);
  else
    return launch_tc_entry(key_tile, q, k, v, o, BH, Sq, Skv, D, scale, splits, workspace,
                           workspace_bytes, s);
}

}  // namespace

extern "C" {

// q (BH, Sq, D), k and v (BH, Skv, D), o (BH, Sq, D), all contiguous, of one
// dtype (0: fp32, 1: bf16). The plan (ops/cuda/flash_attention.py `plan`)
// names the variant (0: FMA, 1: tensor cores, which needs 16-byte rows, D %
// 4 == 0 in fp32 and D % 8 == 0 in bf16, and 16-byte aligned tensors), the
// query rows per block, the key tile, the split count and the workspace
// bytes; the entry refuses a plan that does not match the shape.
// Returns a cudaError_t value: 0 when the launches were accepted.
int tmdiff_flash_attention(int dtype, const void* q, const void* k, const void* v, void* o,
                           int BH, int Sq, int Skv, int D, float scale, int variant, int rows,
                           int key_tile, int splits, void* workspace, long long workspace_bytes,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (BH < 1 || BH > 65535 || Sq < 1 || Skv < 1 || D < 1 || D > 256 || splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return run<float>(q, k, v, o, BH, Sq, Skv, D, scale, variant, rows, key_tile, splits,
                      workspace, workspace_bytes, s);
  if (dtype == 1)
    return run<bf16>(q, k, v, o, BH, Sq, Skv, D, scale, variant, rows, key_tile, splits,
                     workspace, workspace_bytes, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* tmdiff_flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
