// Non-causal attention over (B, H, S, D) fp32 tensors with an online softmax:
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
// grid axis, carrying (m, l, acc) in VMEM scratch. Here one block owns a
// (batch*head, 64-query tile) pair and loops over 64-key K/V tiles itself;
// the ragged edges (keys at or past Skv, queries past Sq, columns past D) are
// masked or zero-filled in shared memory, so nothing is padded in device
// memory.
//
// What bounds it on an H100: operations. Each query row does 4 * Skv * D
// FLOPs (two products) against 8 * D bytes of q and o, and each K/V row is
// reused by every query tile: at S = 1024..4096 that is 0.5-2 kFLOP per byte,
// far above the fp32 ridge of 20 FLOP/byte. Only cross-attention to a short
// context (Skv of 1 to a few tokens) is bound by bytes. The design uses the
// fp32 FMA pipes:
//   * 256 threads as 16 x 16: thread (ty, tx) owns query rows 4ty..4ty+3;
//     for the scores it owns keys tx, tx+16, tx+32, tx+48 of the tile, for
//     the output the value columns 64c + 4tx .. 64c + 4tx + 3;
//   * Q (64 x D), the K and V tiles (64 x D) and the probabilities P (64 x 64)
//     sit in dynamic shared memory (217 KB at D = 256), rows padded to an odd
//     multiple of 4 floats so the float4 reads of 16 neighbouring rows fall in
//     distinct banks;
//   * the row max and row sum are reduced across the 16 threads of a row with
//     warp shuffles; P goes through shared memory to the P.V product.
// No tensor cores (wgmma), TMA or double buffering yet: those are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per K/V tile
constexpr int kLDP = kBK + 4;  // row stride of P
constexpr float kNegInf = -1e30f;

template <int NQ>  // value-column chunks of 64: D <= 64 * NQ
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o, int Sq, int Skv,
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
  const float* qb = q + (bh * Sq + q0) * D;
  const float* kb = k + bh * Skv * D;
  const float* vb = v + bh * Skv * D;

  for (int e = tid; e < kBQ * DP; e += kThreads) {
    const int r = e / DP, c = e % DP;
    qs[r * LD + c] = (q0 + r < Sq && c < D) ? qb[(long long)r * D + c] : 0.f;
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
      ks[r * LD + c] = in ? kb[g] : 0.f;
      vs[r * LD + c] = in ? vb[g] : 0.f;
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
    float* orow = o + (bh * Sq + r) * D;
#pragma unroll
    for (int cq = 0; cq < NQ; ++cq)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 64 * cq + 4 * tx + e;
        if (c < D) orow[c] = acc[i][4 * cq + e] / l[i];
      }
  }
}

template <int NQ>
int launch(const float* q, const float* k, const float* v, float* o, int BH, int Sq, int Skv,
           int D, float scale, cudaStream_t stream) {
  const int DP = (D + 3) / 4 * 4;
  const int LD = DP % 8 == 0 ? DP + 4 : DP;  // an odd multiple of 4
  const int smem = ((kBQ + 2 * kBK) * LD + kBQ * kLDP) * 4;
  auto kernel = flash_attention_kernel<NQ>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Sq + kBQ - 1) / kBQ, BH);
  kernel<<<grid, kThreads, smem, stream>>>(q, k, v, o, Sq, Skv, D, DP, LD, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q (BH, Sq, D), k and v (BH, Skv, D), o (BH, Sq, D), all contiguous fp32.
// Returns a cudaError_t value: 0 when the launch was accepted.
int tmdiff_flash_attention(const float* q, const float* k, const float* v, float* o, int BH,
                           int Sq, int Skv, int D, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (BH < 1 || BH > 65535 || Sq < 1 || Skv < 1 || D < 1 || D > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  if (D <= 64) return launch<1>(q, k, v, o, BH, Sq, Skv, D, scale, s);
  if (D <= 128) return launch<2>(q, k, v, o, BH, Sq, Skv, D, scale, s);
  if (D <= 192) return launch<3>(q, k, v, o, BH, Sq, Skv, D, scale, s);
  return launch<4>(q, k, v, o, BH, Sq, Skv, D, scale, s);
}

const char* tmdiff_flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
