// SAME, stride-1 convolutions with a 3x3 spatial window over channels-last
// activations, fp32 in and out with fp32-accurate accumulation, or bf16 in and
// out with fp32 accumulation. Two entries share one kernel template over the
// number of depth taps KD:
//
//   KD = 3, tmdiff_conv3d_333: (B, D, H, W, Cin) with the spectral bands as
//     depth, kernel (3, 3, 3, Cin, Cout);
//   KD = 1, tmdiff_conv2d_33: (B, H, W, Cin) NHWC, kernel (3, 3, Cin, Cout),
//     run as D = 1.
//
//   y[b,d,h,w,o] = bias[o] (+ y[b,d,h,w,o] when accumulating)
//                + sum_{i,j,k,c} W[i,j,k,c,o] * s[b,c] * a[b,d+i-KD/2,h+j-1,w+k-1,c]
//
// with a = x, or in the bf16 K1 instance a = silu(x + shift[b,c]) (the
// input's pre-activation, its shift optional), and zeros outside the input.
// `s` (B, Cin) is the per-sample style of a modulated conv and `bias` (Cout)
// the conv bias; all are optional. The
// accumulate mode (3x3x3 entry only) lets a decoder conv over a channel concat
// run one launch per part without materialising the concat.
//
// Replaces the Pallas TPU kernels tmdiff_tpu/ops/pallas/banded_conv3d.py
// `banded_conv3d` (_kernel) and `banded_conv3d_v2` (_kernel_v2) with KD = 3,
// and tmdiff_tpu/ops/pallas/conv2d.py `conv3x3_nhwc` (_kernel: 9 accumulated
// MXU matmuls per 8-row strip plus a 2-row halo) with KD = 1. The TPU kernels
// fold bands into the 128 MXU lanes and tile H in 8-row strips; these kernels
// port the functions, not that tiling, and take any D, H and W.
//
// What bounds it on an H100: operations. A 3x3x3 conv does 2*27*Cin FLOPs per
// output element against about (Cin + Cout) * 4 bytes, the band-folded 3x3 conv
// 2*9*Cin: far above the ridge of any rate. fp32 accuracy on the tensor cores
// costs three TF32 products per multiply-add (3xTF32: each operand v splits
// into hi = rna_tf32(v) and lo = rna_tf32(v - hi), and hi*hi + hi*lo + lo*hi
// keeps about 21 bits where plain TF32 keeps 11), so the bound is the TF32
// rate over three: 495 / 3 = 165 TFLOP/s, 2.5x the 67 TFLOP/s of the fp32
// FMA pipes that the FMA variant below runs on.
//
// The tensor-core variant (conv_3x3_tf32x3_kernel) is an implicit GEMM:
// M = output positions, N = Cout, K = KD * 9 * Cin.
//   * Tile: 256 positions, 16 lines of 16 consecutive W positions (TD x TH x
//     16 = 4 x 4 x 16 for KD = 3, 1 x 16 x 16 for KD = 1), by BN = 32, 64 or
//     128 output channels. Two consumer warpgroups each own two m64 row
//     blocks (4 warps x 16 rows = 4 lines) and issue
//     wgmma.mma_async.m64nBNk8.f32.tf32.tf32 with A from registers and B from
//     shared memory; fp32 accumulators stay in registers.
//   * A: per step of 16 input channels, the halo (TD+KD-1)(TH+2)(16+2) x 16
//     channels is staged once and read by all KD * 9 taps at the tap's shifted
//     window (no im2col copy): each thread loads one float4 per row and tap
//     (4 channels; 64-byte halo rows keep a quarter-warp's float4s on distinct
//     banks), applies the style, splits into hi and lo. The 16 channels give
//     two k8 steps with the k order permuted so that k8 column j and j + 4 are
//     neighbouring channels of one float4.
//   * B: a first pass (conv_3x3_weight_split_kernel) writes the weight, split
//     into hi and lo, transposed to K-major [Cout][Cin] and in the wgmma
//     no-swizzle core-matrix layout with that k order, one contiguous 128 * BN
//     byte image per (N tile, channel step, tap) into the workspace. So the
//     weight views (concat parts, groups) at any offset go in without a copy
//     of their own, and the main loop stages B with one bulk copy.
//   * Stage ring: a producer warp keeps two halo buffers (TMA tensor-map loads
//     over (C, W, H, D, B); box (16, 18, TH+2, TD+KD-1, 1); the out-of-bounds
//     zero fill writes the SAME padding, negative start coordinates included)
//     and four weight stages (cp.async.bulk) in flight, each signalled by an
//     mbarrier; consumers release a stage through an "empty" mbarrier. The
//     halo of channel step c+1 is issued during the taps of step c.
//   * Split-K: where the output tiles give fewer than 1.5 waves of blocks
//     on the card's SMs (a wave = SMs x resident blocks per SM), the
//     channel steps are split over 2^k blocks, the least k that reaches 1.5
//     waves (at most one split per step). Between 1.5 and 2 waves a split
//     would not cut the number of partly idle waves and only adds the
//     second pass. Each split writes its partial sums to the workspace and
//     conv_3x3_splitk_reduce_kernel adds them in split order, with the bias
//     and the accumulate read: no atomics, one input gives one output.
//   * Epilogue: bias, accumulate-into-y and the ragged Cout and W edges;
//     float4 stores (after one shuffle pair) where Cout % 4 == 0.
// It takes Cin % 4 == 0 and a 16-byte aligned x (the tensor map's strides and
// base). Every other shape goes to the fp32 FMA kernel
// (conv_3x3_ffma_kernel), chosen by shape in the C entry through
// make_plan(); tmdiff_conv_plan() tells the wrapper which variant a shape
// takes, its split count and how many workspace bytes it needs, and the
// entries take that split count back, so the card is asked once per shape.
//
// bf16 (dtype 1): what the Pallas kernels compute for bf16 operands, A =
// bf16(x * s) (the style product rounded once, as the JAX package's
// `x * style.astype(x.dtype)`), B = bf16(W), fp32 accumulation, then bias and
// the accumulated `y` added in fp32 and one rounding to bf16 (the JAX package
// adds its bias and concat parts after the conv, in bf16). One kernel
// template, conv_3x3_bf16_kernel<KD, BN, CK>, on the 3xTF32 variant's tile
// (256 positions by BN, two consumer warpgroups of two m64 row blocks, a
// producer warpgroup) and split-K rule:
//   * Channel step CK = 64 at BN = 64 and 128 when Cin > 32, else 32 (BN =
//     32 runs two blocks an SM, whose shared memory holds two 32-channel
//     halos and not two 64-channel ones; Cin <= 32 would stage zeros).
//     Each row block and tap issues CK / 16 wgmma.mma_async.m64nBNk16.f32.
//     bf16.bf16 back to back, A from registers, B from shared memory.
//   * Stages: the halo (TD+KD-1)(TH+2)(18) x CK bf16 (TMA, two buffers:
//     83 KB each at KD = 3, CK = 64) and one weight image of BN x CK per
//     (channel step, tap) (bulk copy), in a ring as deep as the shared
//     memory left beside the halos (BfTile::STAGES: 4 at KD = 3, BN = 128,
//     CK = 64, up to 16), so the producer runs far ahead of narrow tiles.
//   * Operand pass: the style, and in K1 a pre-activation of the input,
//     x -> silu(x + shift) with an optional shift (B, Cin) (the model's
//     `silu(h + temb)` before a conv), applied once per staged
//     halo by the producer warpgroup's warps 1-3: when a halo lands they
//     rewrite it in place as bf16(bf16(silu(bf16(x + shift))) * s), rounded
//     where PyTorch's unfused bf16 ops round (the add and the product one
//     bf16 FMA a pair each, the SiLU with the MUFU's ex2 and rcp, within a
//     bf16 step of F.silu), leaving the positions outside
//     the image at the TMA's zeros (the SAME padding of the activated
//     tensor), and arrive on halo_ready, which the consumers wait on
//     instead of the TMA's barrier; the taps read ready A and the consumers
//     never touch the style or the pre-activation. The pass runs beside the
//     other halo buffer's taps, so the model writes neither x + shift nor
//     its SiLU to device memory.
//   * Persistent: one wave of blocks walks the work items (spatial tile
//     fastest, then N tile, then split), the producer loading the next
//     item's first halo where it would load this item's next channel step
//     (early in the last step: the operand pass has most of a step to
//     rewrite it), and its weights during this one's last taps and epilogue.
//   * Waits: each row block commits its products of a tap as one group; its
//     A of the next tap loads into the second of two register buffers as
//     soon as its group of the previous tap is done (wait_group 2), while
//     the other row block's products run. BN = 64 drains at the end of each
//     channel step to add its chain into the second accumulator
//     (tc_promotes).
//   * A layout: halo rows of CK channels, no TMA swizzle. The k order of a
//     step is permuted (bf16_k_channel) so that a thread's fragments of two
//     k16 products are the 8 channels of one 16-byte chunk: one 16-byte
//     load a row, tap and product pair. At CK = 64 (128-byte rows, all 32
//     banks a row) lanes of odd g load their two chunks in the other order,
//     so each quarter warp reads 32 distinct banks; 64-byte rows alternate
//     bank halves by themselves.
//   * B: conv_3x3_weight_bf16_kernel writes the bf16 weight in the k16
//     no-swizzle core-matrix layout with that k order, BN * CK * 2 bytes
//     per (N tile, channel step, tap).
//   * Split-K keeps fp32 partial sums; the reduce pass rounds once to bf16.
// Bound on an H100: operations at the dense bf16 rate, 989 TFLOP/s. What
// held the first bf16 instance at 0.25-0.40 of it was the time between
// products: one k16 product a row block and tap, then a full wait, a stage
// round trip and the style re-applied at every tap. The design issues 2-4
// products a row block between waits, keeps a group in flight while the
// next A loads, runs the weight ring far ahead and moves the style out of
// the taps. What bounds it now is shared memory's bandwidth: at the full
// product rate B's reads (every m64 row block reads the tile's B), A's
// loads, the weight and halo copies and the style pass take about as many
// cycles a tap as the products (PERF.md); halving A's loads alone cut 9 %
// of the time. A read by wgmma straight from shared memory (a chunk-major
// halo) lost overall and B in a swizzled layout changed nothing (PERF.md).
// It takes Cin % 8 == 0 (the tensor map's 16-byte strides) and a 16-byte
// aligned x; there is no bf16 FMA variant, so the plan refuses every other
// bf16 shape (variant -1) and the entries return cudaErrorInvalidValue for
// it.
//
// The weight gradient (tmdiff_wgrad_333, fp32): the gradient of the 3x3x3
// entry's kernel,
//
//   dW[i,j,k,c,o] = sum_{b,d,h,w} (x s)[b,d+i-1,h+j-1,w+k-1,c] * dy[b,d,h,w,o]
//
// with zeros outside x. The JAX package takes it from XLA's conv VJP outside
// its Pallas kernel, so it replaces no TPU kernel; it replaces cuDNN's fp32
// weight gradient, an Ampere FMA kernel that ran at 1/14.5 of the bound
// below. The same operations as the forward, so the same bound: 3xTF32 at
// 495 / 3 TFLOP/s. An implicit GEMM with M = 27 taps x Cin, N = Cout and the
// positions as the reduction K; wgrad_3x3_tf32x3_kernel<BN>:
//   * Rows: a block holds 8 RB (channel group of 16, tap) pairs of 16 rows
//     (RB = 2, 4, 7 row blocks a consumer warpgroup at BN = 128, 64, 32:
//     about 128 accumulators a thread), pairs numbered channel group major,
//     so a block reads 2-4 channel groups. A warp's row block is one pair;
//     A comes from registers, so the pair's tap only moves where its lanes
//     read the halo.
//   * A: x from a halo per stage and channel group (TMA, box 16 x 18 x 4 x 3,
//     the SAME padding by the out-of-bounds zero fill). A stage is 32
//     positions, two lines of 16; a k8 step is half a line. Rows g and g + 8
//     of a lane are two neighbouring channels, one 8-byte load a row; the
//     64-byte swizzle and the channel order of wg_channel put a half warp's
//     loads on 32 distinct banks. Each lane splits into hi and lo and issues
//     its row blocks' three products, one or two k8 steps between waits
//     (wg_k8_per_group).
//   * B: dy, which does not move with the tap, is the shared operand (tf32
//     wgmma reads only K-major B from shared memory): its tile lands by TMA
//     as [position][BN]. A ring of three stages of halos and dy tiles.
//   * Operand pass: the producer warpgroup's warps 1-3 split each landed dy
//     tile and write it K-major (b_desc's layout) into one of two image
//     buffers, while the consumers run the previous stage; every row block
//     of the block reads the image. The style (the same fp32 product as
//     x * s) is applied by this pass to the halo in place at BN = 32 and by
//     the consumers as they load A at BN = 64 and 128 (wg_style_in_pass).
//   * Splits: the stages are split over blocks so that the row tiles, N tiles
//     and splits fill the SMs once (tmdiff_wgrad_plan, asked once per shape);
//     each split writes its partial dW and wgrad_splitk_reduce_kernel adds
//     them in split order: no atomics, one input gives one output, and
//     nothing allocated or synchronised, so a CUDA graph captures it.
//   * Chains: every kWgChain stages each thread adds its accumulators into
//     its split's partial dW with IEEE fp32 adds and starts a new chain, as
//     K1 promotes its chains: the tensor cores' accumulation loses precision
//     with the chain's length, which here would be a split's whole share of
//     the positions.
// It takes Cin % 4 == 0, Cout % 4 == 0 and a 16-byte aligned x and dy (the
// tensor maps); the wrapper sends every other shape to cuDNN. Its kernels
// are named wgrad_*, never conv_3x3_*: the benchmark charges the latter to
// the forward and input gradient.

#include <cuda.h>
#include <cuda_runtime.h>

#include <cuda_bf16.h>

#include <atomic>
#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace hopper;

// ---------------------------------------------------------------------------
// fp32 FMA variant: Cin % 4 != 0 or an x that is not 16-byte aligned.
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kBK = 8;  // input channels staged per step
constexpr int kTM = 8;  // consecutive W positions per thread
constexpr int kTN = 8;  // output channels per thread

template <int KD, int BN, int TD, int TH, int TW>
struct Tile {
  static constexpr int NG = BN / kTN;        // channel groups per block
  static constexpr int PG = kThreads / NG;   // position groups per block
  static_assert(PG * kTM == TD * TH * TW, "tile does not match the threads");
  static_assert(TW % kTM == 0, "TW must be a multiple of kTM");
  static constexpr int HD = TD + KD - 1, HH = TH + 2, HW = TW + 2;
  static constexpr int HALO = HD * HH * HW;
  static constexpr int HALO_LD = HALO | 1;  // odd channel stride: fewer bank conflicts on stores
  static constexpr int XS_FLOATS = (kBK * HALO_LD + 3) / 4 * 4;  // keeps the weights 16-byte aligned
  static constexpr int WS_FLOATS = KD * 9 * kBK * BN;
  static constexpr int SMEM_BYTES = (XS_FLOATS + WS_FLOATS) * 4;
};

template <int KD, int BN, int TD, int TH, int TW>
__global__ void __launch_bounds__(kThreads, 2)
conv_3x3_ffma_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ style, const float* __restrict__ bias,
                     float* __restrict__ y, int B, int D, int H, int W, int Cin,
                     int Cout, long long w_stride_tap, long long w_stride_c,
                     int accumulate) {
  using T = Tile<KD, BN, TD, TH, TW>;
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // [kBK][HALO_LD]
  float* ws = xs + T::XS_FLOATS;                // [KD * 9][kBK][BN]

  const int tiles_w = (W + TW - 1) / TW;
  const int tiles_h = (H + TH - 1) / TH;
  const int tiles_d = (D + TD - 1) / TD;
  int t = blockIdx.x;
  const int w0 = (t % tiles_w) * TW;
  t /= tiles_w;
  const int h0 = (t % tiles_h) * TH;
  t /= tiles_h;
  const int d0 = (t % tiles_d) * TD;
  const int b = t / tiles_d;
  const int n0 = blockIdx.y * BN;

  const int tid = threadIdx.x;
  const int ng = tid % T::NG;
  const int pg = tid / T::NG;
  const int pw = (pg % (TW / kTM)) * kTM;
  const int prow = pg / (TW / kTM);
  const int ph = prow % TH;
  const int pd = prow / TH;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  const float* xb = x + (long long)b * D * H * W * Cin;
  const float* sb = style ? style + (long long)b * Cin : nullptr;

  for (int c0 = 0; c0 < Cin; c0 += kBK) {
    // Input halo, channel fastest so that 8 neighbouring threads read 32
    // contiguous bytes of one position.
    for (int e = tid; e < T::HALO * kBK; e += kThreads) {
      const int c = e % kBK;
      const int pos = e / kBK;
      const int gw = w0 + pos % T::HW - 1;
      const int gh = h0 + (pos / T::HW) % T::HH - 1;
      const int gd = d0 + pos / (T::HW * T::HH) - KD / 2;
      const int gc = c0 + c;
      float v = 0.f;
      if (gc < Cin && gd >= 0 && gd < D && gh >= 0 && gh < H && gw >= 0 && gw < W) {
        v = xb[(((long long)gd * H + gh) * W + gw) * Cin + gc];
        if (sb) v *= sb[gc];
      }
      xs[c * T::HALO_LD + pos] = v;
    }
    // The KD * 9 weight slices of these channels, output channel fastest.
    for (int e = tid; e < T::WS_FLOATS; e += kThreads) {
      const int n = e % BN;
      const int c = (e / BN) % kBK;
      const int tap = e / (BN * kBK);
      const int gc = c0 + c, gn = n0 + n;
      ws[e] = (gc < Cin && gn < Cout) ? w[tap * w_stride_tap + gc * w_stride_c + gn] : 0.f;
    }
    __syncthreads();

#pragma unroll 1
    for (int kd = 0; kd < KD; ++kd) {
#pragma unroll 1
      for (int kh = 0; kh < 3; ++kh) {
#pragma unroll 1
        for (int kw = 0; kw < 3; ++kw) {
          const float* xr = xs + ((pd + kd) * T::HH + ph + kh) * T::HW + pw + kw;
          const float* wr = ws + ((kd * 3 + kh) * 3 + kw) * kBK * BN + ng * 4;
#pragma unroll
          for (int c = 0; c < kBK; ++c) {
            float a[kTM];
#pragma unroll
            for (int i = 0; i < kTM; ++i) a[i] = xr[c * T::HALO_LD + i];
            // A thread's channels are {4 ng .. 4 ng + 3} and the same plus
            // BN / 2: each float4 load of a warp is then one contiguous run.
            const float4 b0 = *reinterpret_cast<const float4*>(wr + c * BN);
            const float4 b1 = *reinterpret_cast<const float4*>(wr + c * BN + BN / 2);
            const float bv[kTN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int i = 0; i < kTM; ++i)
#pragma unroll
              for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
          }
        }
      }
    }
    __syncthreads();
  }

  const int gd = d0 + pd, gh = h0 + ph;
  if (gd >= D || gh >= H) return;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int n = n0 + half * (BN / 2) + ng * 4;
    if (n >= Cout) continue;
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int gw = w0 + pw + i;
      if (gw >= W) continue;
      float* yp = y + ((((long long)b * D + gd) * H + gh) * W + gw) * Cout + n;
      float v[4] = {acc[i][half * 4], acc[i][half * 4 + 1], acc[i][half * 4 + 2],
                    acc[i][half * 4 + 3]};
      if ((Cout & 3) == 0) {  // n % 4 == 0, so all four channels are in range
        if (bias) {
          const float4 bb = *reinterpret_cast<const float4*>(bias + n);
          v[0] += bb.x; v[1] += bb.y; v[2] += bb.z; v[3] += bb.w;
        }
        if (accumulate) {
          const float4 o = *reinterpret_cast<const float4*>(yp);
          v[0] += o.x; v[1] += o.y; v[2] += o.z; v[3] += o.w;
        }
        *reinterpret_cast<float4*>(yp) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
        for (int j = 0; j < 4 && n + j < Cout; ++j) {
          float r = v[j];
          if (bias) r += bias[n + j];
          if (accumulate) r += yp[j];
          yp[j] = r;
        }
      }
    }
  }
}

template <int KD, int BN, int TD, int TH, int TW>
int launch_ffma(const float* x, const float* w, const float* style, const float* bias, float* y,
                int B, int D, int H, int W, int Cin, int Cout, long long w_stride_tap,
                long long w_stride_c, int accumulate, cudaStream_t stream) {
  using T = Tile<KD, BN, TD, TH, TW>;
  auto kernel = conv_3x3_ffma_kernel<KD, BN, TD, TH, TW>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = (long long)B * ((D + TD - 1) / TD) * ((H + TH - 1) / TH) *
                          ((W + TW - 1) / TW);
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  dim3 grid(static_cast<unsigned>(tiles), (Cout + BN - 1) / BN);
  kernel<<<grid, kThreads, T::SMEM_BYTES, stream>>>(
      x, w, style, bias, y, B, D, H, W, Cin, Cout, w_stride_tap, w_stride_c, accumulate);
  return static_cast<int>(cudaGetLastError());
}

int launch_ffma_entry(int kd, const float* x, const float* w, const float* style,
                      const float* bias, float* y, int B, int D, int H, int W, int Cin,
                      int Cout, long long w_stride_tap, long long w_stride_c, int accumulate,
                      cudaStream_t s) {
  if (kd == 3) {
    if (Cout % 64 == 0)
      return launch_ffma<3, 64, 2, 4, 32>(x, w, style, bias, y, B, D, H, W, Cin, Cout,
                                          w_stride_tap, w_stride_c, accumulate, s);
    return launch_ffma<3, 32, 2, 8, 32>(x, w, style, bias, y, B, D, H, W, Cin, Cout,
                                        w_stride_tap, w_stride_c, accumulate, s);
  }
  if (Cout % 64 == 0)
    return launch_ffma<1, 64, 1, 8, 32>(x, w, style, bias, y, B, 1, H, W, Cin, Cout,
                                        w_stride_tap, w_stride_c, 0, s);
  return launch_ffma<1, 32, 1, 16, 32>(x, w, style, bias, y, B, 1, H, W, Cin, Cout,
                                       w_stride_tap, w_stride_c, 0, s);
}

// ---------------------------------------------------------------------------
// 3xTF32 tensor-core variant.
// ---------------------------------------------------------------------------

constexpr int kCK = 16;                       // fp32 input channels per stage: 64-byte halo rows
constexpr int kConsumers = 256;               // two consumer warpgroups
constexpr int kTcThreads = kConsumers + 128;  // and one producer warpgroup
constexpr int kStages = 4;                    // fp32 weight stages in the ring

// Resident blocks per SM, and the registers per thread that setmaxnreg gives
// the consumer and producer warpgroups out of the block's share of the 64 K
// register file (launch bounds give every thread 168, or 80 at two blocks).
__host__ __device__ constexpr int tc_min_blocks(int bn) { return bn == 32 ? 2 : 1; }
__host__ __device__ constexpr int tc_consumer_regs(int bn) { return bn == 32 ? 104 : 232; }
__host__ __device__ constexpr int tc_producer_regs(int bn) { return bn == 32 ? 32 : 40; }

// Accumulation chains. The tensor cores add each wgmma's products into the
// fp32 accumulator without IEEE round-to-nearest: the error grows with the
// adds in one chain (5.96e-5 of the output's scale over the 16 channel steps
// of K = 27 x 256, 3.4e-6 over one step, the steps' partial sums added in
// fp32; an NVIDIA H100 80GB HBM3 at 700 W). So the BN = 64 instances start
// a chain at every channel step and add it into a second accumulator. BN =
// 128 has no registers for that, and BN = 32 (two blocks an SM, 80
// registers a thread at compile time) spills with it: they keep one chain a
// split, within 8e-5 of the output's scale at the main path's deepest sums.
__host__ __device__ constexpr bool tc_promotes(int bn) { return bn == 64; }

template <int KD, int BN>
struct TcTile {
  static constexpr int TW = 16, TD = KD == 3 ? 4 : 1, TH = 16 / TD;  // 16 lines of 16
  static constexpr int TAPS = KD * 9;
  static constexpr int HD = TD + KD - 1, HH = TH + 2, HW = TW + 2;
  static constexpr int HALO_BYTES = HD * HH * HW * kCK * 4;
  static constexpr int W_FLOATS = 32 * BN;  // [hi, lo][k8 step][BN x 8], K-major core matrices
  static constexpr int W_BYTES = W_FLOATS * 4;
  static constexpr int SMEM_BYTES = 2 * HALO_BYTES + kStages * W_BYTES + (4 + 2 * kStages) * 8;
  static_assert(HALO_BYTES % 128 == 0 && W_BYTES % 128 == 0, "stage alignment");
};

__device__ __forceinline__ void tma_load_halo(void* dst, const CUtensorMap* map, uint64_t* bar,
                                              int c, int w, int h, int d, int b) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6, %7}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c), "r"(w), "r"(h), "r"(d),
      "r"(b)
      : "memory");
}

// The stage ring's mbarriers: two halo buffers and STAGES weight stages,
// each with a "full" barrier (the producer's copy landed) and an "empty" one
// (every consumer warp is done with it).
template <int STAGES = kStages>
__device__ __forceinline__ void init_stage_barriers(uint64_t* halo_full, uint64_t* halo_empty,
                                                    uint64_t* w_full, uint64_t* w_empty) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&halo_full[i], 1);
      mbar_init(&halo_empty[i], kConsumers / 32);
    }
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&w_full[i], 1);
      mbar_init(&w_empty[i], kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

// A halo's channel step and the origin of its output tile.
struct HaloAt {
  int c, w0, h0, d0, b;
};

// The producer thread: the halo of each channel step of CK channels (TMA,
// two buffers) and the weight image of each (channel step, tap) (bulk copy,
// STAGES buffers), in the consumers' order. `wblk` is this block's N tile of
// the weight images, W_BYTES per (channel step, tap). `halos` and `steps`
// number the halos and weight stages this thread has issued before (0 for a
// block's one tile; a persistent block carries them from tile to tile). A
// persistent block passes `next`, the first halo of its next work item,
// which is issued where this item's next halo would be in its last channel
// step, and `issued` on the next call: so a work item of one channel step
// has its halo a whole item ahead, time for the operand pass.
template <int KD, int TAPS, int HALO_BYTES, int W_BYTES, int CK = kCK, int STAGES = kStages>
__device__ __forceinline__ void produce(const CUtensorMap* map, const unsigned char* wblk,
                                        unsigned char* halo, unsigned char* wst,
                                        uint64_t* halo_full, uint64_t* halo_empty,
                                        uint64_t* w_full, uint64_t* w_empty, int cb_begin,
                                        int cb_end, int w0, int h0, int d0, int b, int& halos,
                                        int& steps, bool issued = false,
                                        const HaloAt* next = nullptr) {
  auto load = [&](const HaloAt& a) {
    const int i = halos++, s = i & 1;
    mbar_wait(&halo_empty[s], ((i >> 1) & 1) ^ 1);
    mbar_expect_tx(&halo_full[s], HALO_BYTES);
    tma_load_halo(halo + s * HALO_BYTES, map, &halo_full[s], a.c * CK, a.w0 - 1, a.h0 - 1,
                  a.d0 - KD / 2, a.b);
  };
  auto load_halo = [&](int c) { load(HaloAt{c, w0, h0, d0, b}); };
  // With STAGES < TAPS the consumers have finished step (c, 0) once stage
  // (c, STAGES) is free, so the other halo buffer (step c - 1, or the last
  // of the previous item) is free too; with a deeper ring the producer waits
  // for it after the step's last tap.
  constexpr int kHaloTap = STAGES < TAPS - 1 ? STAGES : TAPS - 1;
  if (cb_begin < cb_end && !issued) load_halo(cb_begin);
  for (int c = cb_begin; c < cb_end; ++c) {
    for (int tap = 0; tap < TAPS; ++tap) {
      const int step = steps++, s = step % STAGES;
      mbar_wait(&w_empty[s], ((step / STAGES) & 1) ^ 1);
      mbar_expect_tx(&w_full[s], W_BYTES);
      bulk_load(wst + s * W_BYTES, wblk + ((long long)c * TAPS + tap) * W_BYTES, W_BYTES,
                &w_full[s]);
      // The next halo lands during this step.
      if (tap == kHaloTap && c + 1 < cb_end) load_halo(c + 1);
      if (tap == kHaloTap && c + 1 == cb_end && next) load(*next);
    }
  }
}

// The weight's B operand: for each (N tile, channel step of 16, tap) one
// W_FLOATS image of the stage as the main kernel stages it, hi then lo, each
// two k8 steps of an N x 8 K-major no-swizzle matrix. Within a step s the k8
// column kc holds input channel 4 (kc % 4) + 2 s + kc / 4 of the step, so
// that the A fragment's columns t and t + 4 are neighbours in one float4.
// Channels past Cin and outputs past Cout are zero.
__global__ void conv_3x3_weight_split_kernel(const float* __restrict__ w, float* __restrict__ out,
                                             int taps, int Cin, int Cout, int bn,
                                             long long w_stride_tap, long long w_stride_c) {
  const int n_cb = (Cin + kCK - 1) / kCK, n_nb = (Cout + bn - 1) / bn;
  const int half = 16 * bn;  // hi floats of one stage
  const long long total = (long long)n_nb * n_cb * taps * half;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const int q = static_cast<int>(i % half);
    const long long stage = i / half;  // (nb * n_cb + cb) * taps + tap
    const int tap = static_cast<int>(stage % taps);
    const int cb = static_cast<int>((stage / taps) % n_cb);
    const int nb = static_cast<int>(stage / taps / n_cb);
    const int s = q / (8 * bn), f = q % (8 * bn);
    const int n = (f >> 6) * 8 + ((f >> 2) & 7);   // core-matrix row
    const int kc = ((f >> 5) & 1) * 4 + (f & 3);   // K half, then column in it
    const int c = cb * kCK + 4 * (kc & 3) + 2 * s + (kc >> 2);
    const int o = nb * bn + n;
    const float v = (c < Cin && o < Cout) ? w[tap * w_stride_tap + c * w_stride_c + o] : 0.f;
    uint32_t hi, lo;
    split_tf32(v, hi, lo);
    float* dst = out + stage * 2 * half;
    dst[q] = __uint_as_float(hi);
    dst[half + q] = __uint_as_float(lo);
  }
}

// The consumer warpgroups' main loop and epilogue.
template <int KD, int BN>
__device__ __forceinline__ void consume(
    const unsigned char* halo, const unsigned char* wst, uint64_t* halo_full,
    uint64_t* halo_empty, uint64_t* w_full, uint64_t* w_empty, const float* __restrict__ style,
    const float* __restrict__ bias, float* __restrict__ y, float* __restrict__ partial,
    long long plane, int D, int H, int W, int Cin, int Cout, int cb_begin, int cb_end, int b,
    int d0, int h0, int w0, int n0, int accumulate) {
  using T = TcTile<KD, BN>;

  // Consumers: warpgroup wg owns m64 row blocks 2 wg and 2 wg + 1; in each,
  // warp `warp` owns 16 rows = one line of 16 W positions, line index
  // L = 4 (2 wg + mb) + warp, at (pd, ph) = (L / TH, L % TH).
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  int row0[2];  // halo position of row g at tap (0, 0, 0)
#pragma unroll
  for (int mb = 0; mb < 2; ++mb) {
    const int L = 4 * (2 * wg + mb) + warp;
    row0[mb] = ((L / T::TH) * T::HH + L % T::TH) * T::HW + g;
  }
  // acc takes one accumulation chain's wgmmas; with promotion each channel
  // step starts a fresh chain and adds it into sum with IEEE fp32 adds.
  constexpr bool kPromote = tc_promotes(BN);
  float acc[2][BN / 2], sum[2][BN / 2];
#pragma unroll
  for (int mb = 0; mb < 2; ++mb)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[mb][i] = sum[mb][i] = 0.f;

  const float* sb = style ? style + (long long)b * Cin : nullptr;
  int step = 0;
  for (int c = cb_begin; c < cb_end; ++c) {
    const int i = c - cb_begin, hs = i & 1;
    float4 sv = make_float4(1.f, 1.f, 1.f, 1.f);
    if (sb) {
      const int ch = c * kCK + 4 * t;
      sv.x = ch < Cin ? sb[ch] : 0.f;
      sv.y = ch + 1 < Cin ? sb[ch + 1] : 0.f;
      sv.z = ch + 2 < Cin ? sb[ch + 2] : 0.f;
      sv.w = ch + 3 < Cin ? sb[ch + 3] : 0.f;
    }
    mbar_wait(&halo_full[hs], (i >> 1) & 1);
    const unsigned char* hb = halo + hs * T::HALO_BYTES + t * 16;
#pragma unroll 1
    for (int kd = 0; kd < KD; ++kd) {
#pragma unroll 1
      for (int kh = 0; kh < 3; ++kh) {
#pragma unroll 1
        for (int kw = 0; kw < 3; ++kw, ++step) {
          const int shift = (kd * T::HH + kh) * T::HW + kw;
          uint32_t ahi[2][2][4], alo[2][2][4];  // [mb][k8 step][fragment]
#pragma unroll
          for (int mb = 0; mb < 2; ++mb) {
            float4 v0 = *reinterpret_cast<const float4*>(hb + (row0[mb] + shift) * (kCK * 4));
            float4 v1 = *reinterpret_cast<const float4*>(hb + (row0[mb] + shift + 8) * (kCK * 4));
            if (sb) {
              v0.x *= sv.x; v0.y *= sv.y; v0.z *= sv.z; v0.w *= sv.w;
              v1.x *= sv.x; v1.y *= sv.y; v1.z *= sv.z; v1.w *= sv.w;
            }
            // Fragment: (row g, col t), (g + 8, t), (g, t + 4), (g + 8, t + 4).
            split_tf32(v0.x, ahi[mb][0][0], alo[mb][0][0]);
            split_tf32(v1.x, ahi[mb][0][1], alo[mb][0][1]);
            split_tf32(v0.y, ahi[mb][0][2], alo[mb][0][2]);
            split_tf32(v1.y, ahi[mb][0][3], alo[mb][0][3]);
            split_tf32(v0.z, ahi[mb][1][0], alo[mb][1][0]);
            split_tf32(v1.z, ahi[mb][1][1], alo[mb][1][1]);
            split_tf32(v0.w, ahi[mb][1][2], alo[mb][1][2]);
            split_tf32(v1.w, ahi[mb][1][3], alo[mb][1][3]);
          }
          const int s = step % kStages;
          mbar_wait(&w_full[s], (step / kStages) & 1);
          const uint32_t wb = smem_u32(wst + s * T::W_BYTES);
          fence_regs<BN / 2>(acc[0]);
          fence_regs<BN / 2>(acc[1]);
          fence_regs<16>(&ahi[0][0][0]);
          fence_regs<16>(&alo[0][0][0]);
          asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const uint64_t dhi = b_desc(wb + k * BN * 32), dlo = b_desc(wb + (2 + k) * BN * 32);
#pragma unroll
            for (int mb = 0; mb < 2; ++mb) {
              Wgmma<BN>::mma(acc[mb], ahi[mb][k], dlo);
              Wgmma<BN>::mma(acc[mb], alo[mb][k], dhi);
              Wgmma<BN>::mma(acc[mb], ahi[mb][k], dhi);
            }
          }
          asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
          asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
          fence_regs<BN / 2>(acc[0]);
          fence_regs<BN / 2>(acc[1]);
          __syncwarp();
          if (lane == 0) mbar_arrive(&w_empty[s]);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&halo_empty[hs]);
    if constexpr (kPromote) {
#pragma unroll
      for (int mb = 0; mb < 2; ++mb)
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
          sum[mb][i] += acc[mb][i];
          acc[mb][i] = 0.f;
        }
    }
  }

  // Epilogue. Accumulator j of a row block holds (row g, col 8 j + 2 t),
  // (g, 8 j + 2 t + 1), (g + 8, 8 j + 2 t), (g + 8, 8 j + 2 t + 1).
  float* out = partial ? partial + blockIdx.z * plane : y;
  const bool vec = (Cout & 3) == 0;
#pragma unroll
  for (int mb = 0; mb < 2; ++mb) {
    const int L = 4 * (2 * wg + mb) + warp;
    const int gd = d0 + L / T::TH, gh = h0 + L % T::TH;
    const bool line_ok = gd < D && gh < H;
    const long long line = (((long long)b * D + gd) * H + gh) * W;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const float* a = kPromote ? &sum[mb][4 * j] : &acc[mb][4 * j];
      if (vec) {
        // Lanes t and t ^ 1 trade halves: an even t stores row g, channels
        // 8 j + 2 t .. + 3; an odd t row g + 8, channels 8 j + 2 (t - 1) .. + 3.
        const bool odd = t & 1;
        const float r0 = __shfl_xor_sync(0xffffffffu, odd ? a[0] : a[2], 1);
        const float r1 = __shfl_xor_sync(0xffffffffu, odd ? a[1] : a[3], 1);
        float4 v = odd ? make_float4(r0, r1, a[2], a[3]) : make_float4(a[0], a[1], r0, r1);
        const int gw = w0 + g + (odd ? 8 : 0);
        const int n = n0 + 8 * j + 2 * (t & ~1);
        if (line_ok && gw < W && n < Cout) {
          float* p = out + (line + gw) * Cout + n;
          if (!partial) {
            if (bias) {
              const float4 bb = *reinterpret_cast<const float4*>(bias + n);
              v.x += bb.x; v.y += bb.y; v.z += bb.z; v.w += bb.w;
            }
            if (accumulate) {
              const float4 o = *reinterpret_cast<const float4*>(p);
              v.x += o.x; v.y += o.y; v.z += o.z; v.w += o.w;
            }
          }
          *reinterpret_cast<float4*>(p) = v;
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int gw = w0 + g + (e >> 1) * 8;
          const int n = n0 + 8 * j + 2 * t + (e & 1);
          if (line_ok && gw < W && n < Cout) {
            float* p = out + (line + gw) * Cout + n;
            float v = a[e];
            if (!partial) {
              if (bias) v += bias[n];
              if (accumulate) v += *p;
            }
            *p = v;
          }
        }
      }
    }
  }
}

template <int KD, int BN>
__global__ void __launch_bounds__(kTcThreads, tc_min_blocks(BN))
conv_3x3_tf32x3_kernel(const __grid_constant__ CUtensorMap xmap, const float* __restrict__ wsplit,
                       const float* __restrict__ style, const float* __restrict__ bias,
                       float* __restrict__ y, float* __restrict__ partial, long long plane,
                       int D, int H, int W, int Cin, int Cout, int cb_per_split, int accumulate) {
  using T = TcTile<KD, BN>;
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* halo = smem;                     // [2][HALO_BYTES]
  unsigned char* wst = smem + 2 * T::HALO_BYTES;  // [kStages][W_BYTES]
  uint64_t* bars = reinterpret_cast<uint64_t*>(wst + kStages * T::W_BYTES);
  uint64_t* halo_full = bars;
  uint64_t* halo_empty = bars + 2;
  uint64_t* w_full = bars + 4;
  uint64_t* w_empty = bars + 4 + kStages;

  const int tiles_w = (W + T::TW - 1) / T::TW;
  const int tiles_h = (H + T::TH - 1) / T::TH;
  const int tiles_d = (D + T::TD - 1) / T::TD;
  int tile = blockIdx.x;
  const int w0 = (tile % tiles_w) * T::TW;
  tile /= tiles_w;
  const int h0 = (tile % tiles_h) * T::TH;
  tile /= tiles_h;
  const int d0 = (tile % tiles_d) * T::TD;
  const int b = tile / tiles_d;
  const int n0 = blockIdx.y * BN;
  const int n_cb = (Cin + kCK - 1) / kCK;
  const int cb_begin = blockIdx.z * cb_per_split;
  const int cb_end = min(n_cb, cb_begin + cb_per_split);

  init_stage_barriers(halo_full, halo_empty, w_full, w_empty);

  if (threadIdx.x >= kConsumers) {
    // Producer: one thread keeps the halo and weight stages in flight.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(tc_producer_regs(BN)));
    if (threadIdx.x != kConsumers) return;
    const float* wblk = wsplit + (long long)blockIdx.y * n_cb * T::TAPS * T::W_FLOATS;
    int halos = 0, steps = 0;
    produce<KD, T::TAPS, T::HALO_BYTES, T::W_BYTES>(
        &xmap, reinterpret_cast<const unsigned char*>(wblk), halo, wst, halo_full, halo_empty,
        w_full, w_empty, cb_begin, cb_end, w0, h0, d0, b, halos, steps);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(tc_consumer_regs(BN)));
    consume<KD, BN>(halo, wst, halo_full, halo_empty, w_full, w_empty, style, bias, y, partial,
                    plane, D, H, W, Cin, Cout, cb_begin, cb_end, b, d0, h0, w0, n0, accumulate);
  }
}

// y = (accumulate ? y : 0) + bias + partial[0] + partial[1] + ..., in that
// order: the split-K sum is the same from run to run.
__global__ void conv_3x3_splitk_reduce_kernel(const float* __restrict__ partial, int splits,
                                              long long plane, const float* __restrict__ bias,
                                              float* __restrict__ y, int Cout, int accumulate) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  if ((Cout & 3) == 0) {
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < plane / 4;
         i += stride) {
      float4 v = accumulate ? reinterpret_cast<const float4*>(y)[i] : make_float4(0.f, 0.f, 0.f, 0.f);
      if (bias) {
        const float4 bb = *reinterpret_cast<const float4*>(bias + (i * 4) % Cout);
        v.x += bb.x; v.y += bb.y; v.z += bb.z; v.w += bb.w;
      }
      for (int s = 0; s < splits; ++s) {
        const float4 p = reinterpret_cast<const float4*>(partial + s * plane)[i];
        v.x += p.x; v.y += p.y; v.z += p.z; v.w += p.w;
      }
      reinterpret_cast<float4*>(y)[i] = v;
    }
  } else {
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < plane; i += stride) {
      float v = accumulate ? y[i] : 0.f;
      if (bias) v += bias[i % Cout];
      for (int s = 0; s < splits; ++s) v += partial[s * plane + i];
      y[i] = v;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 tensor-core variant.
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

// The bf16 tile: the 3xTF32 variant's 256 positions by BN, resident blocks
// and registers (tc_min_blocks, tc_consumer_regs), with the instance's own
// channel step CK (32 or 64, make_plan's rule) and a weight ring as deep as
// the shared memory left beside the two halo buffers allows (4 to 16
// stages, at the block's share of the SM: all of it at BN = 64 and 128, half
// at BN = 32, which runs two blocks an SM).
template <int KD, int BN, int CK>
struct BfTile {
  static constexpr int TW = 16, TD = KD == 3 ? 4 : 1, TH = 16 / TD;  // 16 lines of 16
  static constexpr int TAPS = KD * 9;
  static constexpr int HD = TD + KD - 1, HH = TH + 2, HW = TW + 2;
  static constexpr int ROW_BYTES = CK * 2;  // one halo position: CK bf16 channels
  static constexpr int CHUNKS = CK / 8;     // its 16-byte chunks of 8 channels
  static constexpr int KSTEPS = CK / 16;    // k16 products per row block and tap
  static constexpr int HALO_BYTES = HD * HH * HW * ROW_BYTES;
  static constexpr int W_BYTES = BN * CK * 2;  // KSTEPS k16 images of BN x 16 bf16, K-major
  static constexpr int SMEM_CAP = tc_min_blocks(BN) == 1 ? 232448 : 115712;
  // the operand pass's shifts and styles of a channel step, two buffers
  static constexpr int TABLE_BYTES = 2 * 2 * CK * 2;
  static constexpr int FREE = (SMEM_CAP - 2 * HALO_BYTES - TABLE_BYTES - 512) / W_BYTES;
  static constexpr int STAGES = FREE > 16 ? 16 : FREE;
  static constexpr int SMEM_BYTES =
      2 * HALO_BYTES + STAGES * W_BYTES + TABLE_BYTES + (6 + 2 * STAGES) * 8;
  static_assert(CK == 32 || CK == 64, "channel step");
  static_assert(STAGES >= 4, "weight ring");
  static_assert(SMEM_BYTES <= SMEM_CAP, "shared memory");
  static_assert(HALO_BYTES % 128 == 0 && W_BYTES % 128 == 0, "stage alignment");
};

// Input channel (within a channel step) of column kc of the step's k16
// product s. Thread t's 16-byte chunk t + 4 (s / 2) of a halo position
// holds its fragment columns 2t, 2t+1, 2t+8, 2t+9 of products s = 2m
// (the chunk's channels 0-3) and s = 2m + 1 (channels 4-7): one 16-byte load
// a row gives two products' A.
__host__ __device__ constexpr int bf16_k_channel(int s, int kc) {
  return 32 * (s >> 1) + 8 * ((kc & 7) >> 1) + 4 * (s & 1) + 2 * (kc >> 3) + (kc & 1);
}

// The weight's B operand for the bf16 kernel: for each (N tile, channel step
// of ck, tap) one image of ck / 16 k16 products, each BN x 16 bf16 with
// (n, kc) at (n / 8) * 128 + (kc / 8) * 64 + (n % 8) * 8 + kc % 8
// (b_desc_k16's layout), kc of product s holding channel
// bf16_k_channel(s, kc) of the step. Channels past Cin and outputs past
// Cout are zero.
__global__ void conv_3x3_weight_bf16_kernel(const bf16* __restrict__ w, bf16* __restrict__ out,
                                            int taps, int Cin, int Cout, int bn, int ck,
                                            long long w_stride_tap, long long w_stride_c) {
  const int n_cb = (Cin + ck - 1) / ck, n_nb = (Cout + bn - 1) / bn;
  const int image = ck * bn;  // bf16 of one stage
  const long long total = (long long)n_nb * n_cb * taps * image;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const int q = static_cast<int>(i % image);
    const long long stage = i / image;  // (nb * n_cb + cb) * taps + tap
    const int tap = static_cast<int>(stage % taps);
    const int cb = static_cast<int>((stage / taps) % n_cb);
    const int nb = static_cast<int>(stage / taps / n_cb);
    const int s = q / (16 * bn), r = q % (16 * bn);
    const int n = (r >> 7) * 8 + ((r >> 3) & 7);  // 8-row group, then row in it
    const int kc = ((r >> 6) & 1) * 8 + (r & 7);  // K half, then column in it
    const int c = cb * ck + bf16_k_channel(s, kc);
    const int o = nb * bn + n;
    out[i] = (c < Cin && o < Cout) ? w[tap * w_stride_tap + c * w_stride_c + o]
                                   : __float2bfloat16_rn(0.f);
  }
}

// One work item of a persistent bf16 block: a spatial tile, an N tile and a
// split of the channel steps.
struct BfItem {
  int b, d0, h0, w0, nb, split, cb_begin, cb_end;
};

// Which positions of an item's halo lie inside the image, for the operand
// pass: bit wx (wx < HW) for the column w0 - 1 + wx, bit 18 + hy for the row
// h0 - 1 + hy, bit 24 + dz for the depth d0 - 1 + dz (the TMA box's origin,
// KD = 3 only).
template <int HD, int HH, int HW>
__device__ __forceinline__ uint32_t halo_inside(const BfItem& m, int D, int H, int W) {
  static_assert(HW <= 18 && HH <= 6 && HD <= 8, "halo mask bits");
  auto in = [](int v, int n) { return static_cast<uint32_t>(static_cast<unsigned>(v) < n); };
  uint32_t mask = 0;
#pragma unroll
  for (int i = 0; i < HW; ++i) mask |= in(m.w0 - 1 + i, W) << i;
#pragma unroll
  for (int i = 0; i < HH; ++i) mask |= in(m.h0 - 1 + i, H) << (18 + i);
#pragma unroll
  for (int i = 0; i < HD; ++i) mask |= in(m.d0 - 1 + i, D) << (24 + i);
  return mask;
}

// a * b + c on two bf16 pairs, each rounded once (the exact product and sum):
// with b = 1 it is PyTorch's bf16 add (an fp32 sum of two bf16, rounded), with
// c = -0 its bf16 product (the exact fp32 product, rounded).
__device__ __forceinline__ uint32_t fma_bf16x2(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// One staged halo's pre-activation pass (operand_halos): the chunks of this
// thread that lie inside the image, rewritten as
// bf16(bf16(silu(bf16(x + shift))) * s), with the chunk's 8 shifts and 8
// styles read from the channel step's table `tab` (bf16 pairs). SiLU is
// x / (1 + 2^(-x log2(e))) with the MUFU's ex2 and rcp: within about 1e-5 of
// PyTorch's fp32 SiLU (expf and an IEEE division) relative to it (the
// rounding of -x log2(e) grows with |x|), far inside a bf16 step, so the two
// are one bf16 step apart at most once rounded, down to x = -87.3; below that
// both are under 1e-35 in magnitude and this gives -0. The eight elements of
// a chunk run as eight independent chains, one stage of all of them after the
// other (ex2, then rcp), which keeps the MUFU busy from few registers: the
// pass warps run at 32 or 40 registers (setmaxnreg).
template <int CK, int HH, int HW>
__device__ __forceinline__ void preact_halo(unsigned char* hb, const unsigned char* tab,
                                            uint32_t inside, int tid) {
  constexpr int kStylers = 96, kChunks = CK / 8, kPlane = HH * HW * kChunks;
  const unsigned char* th = tab + 16 * (tid % kChunks);  // this chunk's shifts; styles 2 CK on
  // The depth rows inside the image are one run of chunks [k_begin, k_end),
  // and an item off the image's H and W edges needs no test a position.
  const uint32_t rows = inside >> 24;
  const int k_begin = (__ffs(rows) - 1) * kPlane, k_end = (32 - __clz(rows)) * kPlane;
  const bool edge = (inside & 0xffffffu) != (((1u << HH) - 1) << 18 | ((1u << HW) - 1));
#pragma unroll 1
  for (int k = k_begin + tid; k < k_end; k += kStylers) {
    if (edge) {
      const int p = k / kChunks, wx = p % HW, hy = p / HW % HH;
      if (!((inside >> wx) & (inside >> (18 + hy)) & 1u)) continue;
    }
    const uint4 v = *reinterpret_cast<const uint4*>(hb + 16 * k);
    const uint4 h = *reinterpret_cast<const uint4*>(th);
    // bf16(x + shift), PyTorch's add: one bf16 FMA (x * 1 + shift) a pair
    constexpr uint32_t kOnes = 0x3f803f80u, kNegZeros = 0x80008000u;  // bf16 (1, 1), (-0, -0)
    uint32_t t[4] = {fma_bf16x2(v.x, kOnes, h.x), fma_bf16x2(v.y, kOnes, h.y),
                     fma_bf16x2(v.z, kOnes, h.z), fma_bf16x2(v.w, kOnes, h.w)};
    float e[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float x = j & 1 ? bf16_hi(t[j / 2]) : bf16_lo(t[j / 2]);
      asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e[j]) : "f"(x * -1.4426950408889634f));
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(e[j]) : "f"(1.f + e[j]));
#pragma unroll
    for (int j = 0; j < 4; ++j)  // silu(x) = x / (1 + 2^(-x log2(e))), rounded
      t[j] = pack_bf16x2(bf16_lo(t[j]) * e[2 * j], bf16_hi(t[j]) * e[2 * j + 1]);
    const uint4 sv = *reinterpret_cast<const uint4*>(th + 2 * CK);
    // bf16(a * s): the exact product, one rounding
    *reinterpret_cast<uint4*>(hb + 16 * k) =
        make_uint4(fma_bf16x2(t[0], sv.x, kNegZeros), fma_bf16x2(t[1], sv.y, kNegZeros),
                   fma_bf16x2(t[2], sv.z, kNegZeros), fma_bf16x2(t[3], sv.w, kNegZeros));
  }
}

// The producer warpgroup's warps 1-3 when the conv has an operand pass (a
// style or a pre-activation): each halo, as it lands, is rewritten in
// place (16 bytes a thread and turn), then announced on halo_ready. A styled
// halo without a pre-activation becomes bf16(x * s). With the SiLU (`silu`;
// `hb16` the item's row of the shift, (B, Cin), or null) it becomes
//   a = bf16(bf16(silu(bf16(x + shift))) * s),
// rounded where the unfused ops round: PyTorch's bf16 add, F.silu (fp32 math,
// one rounding; preact_halo's form, within a bf16 step of it), the style
// product, the add and the product one bf16 FMA a pair each; a missing shift
// adds 0 and a missing style multiplies by 1, both exact. The channel step's
// shifts and styles go first into `table` (two buffers of CK shifts and CK
// styles, so one named barrier a step orders them), and only the positions
// inside the image are rewritten (`inside`, halo_inside's bits): the TMA's
// zeros outside stay zero, since silu(0 + shift) is not 0 and the SAME
// padding pads the activated tensor. Channels past Cin take a zero shift
// and style, so they stay zero too. `halos` numbers the halos as produce()
// does.
template <int KD, int HALO_BYTES, int CK, int HH, int HW>
__device__ __forceinline__ void operand_halos(unsigned char* halo, unsigned char* table,
                                              uint64_t* halo_full, uint64_t* halo_ready,
                                              const bf16* __restrict__ sb,
                                              const bf16* __restrict__ hb16, bool silu, int Cin,
                                              int cb_begin, int cb_end, uint32_t inside,
                                              int& halos) {
  constexpr int kStylers = 96, kChunks = CK / 8;
  static_assert(kStylers % kChunks == 0, "a styler thread keeps one channel chunk");
  const int tid = threadIdx.x - kConsumers - 32;
  const bool pre = KD == 3 && silu;
  for (int c = cb_begin; c < cb_end; ++c) {
    const int i = halos++, hs = i & 1;
    const int ch = c * CK + 8 * (tid % kChunks);
    unsigned char* hb = halo + hs * HALO_BYTES;
    if (!pre) {
      float sv[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) sv[e] = ch + e < Cin ? __bfloat162float(sb[ch + e]) : 0.f;
      mbar_wait(&halo_full[hs], (i >> 1) & 1);
#pragma unroll 4
      for (int k = tid; k < HALO_BYTES / 16; k += kStylers) {
        uint4 v = *reinterpret_cast<const uint4*>(hb + 16 * k);
        // bf16(x * s): the fp32 product of two bf16 is exact, one rounding
        v.x = pack_bf16x2(bf16_lo(v.x) * sv[0], bf16_hi(v.x) * sv[1]);
        v.y = pack_bf16x2(bf16_lo(v.y) * sv[2], bf16_hi(v.y) * sv[3]);
        v.z = pack_bf16x2(bf16_lo(v.z) * sv[4], bf16_hi(v.z) * sv[5]);
        v.w = pack_bf16x2(bf16_lo(v.w) * sv[6], bf16_hi(v.w) * sv[7]);
        *reinterpret_cast<uint4*>(hb + 16 * k) = v;
      }
    } else if constexpr (KD == 3) {
      unsigned char* tab = table + (i & 1) * 4 * CK;  // [shift, style][CK] bf16
      if (tid < kChunks) {  // the step's shifts and styles, 0 past Cin
        uint32_t hv[4], sv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float h2[2], s2[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int cj = ch + 2 * e + j;
            h2[j] = hb16 && cj < Cin ? __bfloat162float(hb16[cj]) : 0.f;
            s2[j] = cj < Cin ? (sb ? __bfloat162float(sb[cj]) : 1.f) : 0.f;
          }
          hv[e] = pack_bf16x2(h2[0], h2[1]);
          sv[e] = pack_bf16x2(s2[0], s2[1]);
        }
        *reinterpret_cast<uint4*>(tab + 16 * tid) = make_uint4(hv[0], hv[1], hv[2], hv[3]);
        *reinterpret_cast<uint4*>(tab + 2 * CK + 16 * tid) = make_uint4(sv[0], sv[1], sv[2], sv[3]);
      }
      asm volatile("bar.sync 1, %0;" ::"n"(kStylers) : "memory");
      mbar_wait(&halo_full[hs], (i >> 1) & 1);
      preact_halo<CK, HH, HW>(hb, tab, inside, tid);
    }
    // a later TMA load into this buffer comes after these writes
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(&halo_ready[hs]);
  }
}

// The bf16 kernel's consumer warpgroups on one work item: the 3xTF32
// consumer's tiling and row blocks, with
//   * the taps reading ready A: a styled halo waits on halo_ready (the
//     producer warpgroup styled it), an unstyled one on halo_full;
//   * A of step j + 1 (a tap of a channel step) loaded into the second of
//     two register buffers while the products of step j run: each row
//     block issues its products of step j and commits them as one group,
//     waits until its own group of step j - 1 is done (wait_group 2: the
//     other row block's group and this one stay in flight) and loads its A
//     of step j + 1; step j - 1's weight stage is released once both of its
//     groups are done. BN = 64 drains at the end of each channel step
//     (wait_group 0) to add its chain into the second accumulator.
// `halos` and `steps` number the halos and weight stages used before, as in
// produce().
template <int KD, int BN, int CK>
__device__ __forceinline__ void consume_bf16(
    const unsigned char* halo, const unsigned char* wst, uint64_t* halo_wait,
    uint64_t* halo_empty, uint64_t* w_full, uint64_t* w_empty, const bf16* __restrict__ bias,
    bf16* __restrict__ y, float* __restrict__ partial, long long plane, int D, int H, int W,
    int Cout, const BfItem& m, int accumulate, int& halos, int& steps) {
  using T = BfTile<KD, BN, CK>;
  constexpr int NK = T::KSTEPS;
  constexpr int LOADS = CK / 32;  // 16-byte loads a row and tap
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // With 128-byte rows (CK = 64) every row spans all 32 banks: lanes of odd
  // g take their two chunks in the other order, so that each quarter warp
  // (g = 2q, 2q + 1) reads chunks 0-3 of one row and 4-7 of the next, all
  // 32 banks once. 64-byte rows (CK = 32) alternate halves by themselves.
  const int odd = CK == 64 ? (g & 1) : 0;
  int row0[2];  // halo position of row g at tap (0, 0, 0)
#pragma unroll
  for (int mb = 0; mb < 2; ++mb) {
    const int L = 4 * (2 * wg + mb) + warp;
    row0[mb] = ((L / T::TH) * T::HH + L % T::TH) * T::HW + g;
  }
  constexpr bool kPromote = tc_promotes(BN);
  float acc[2][BN / 2], sum[2][BN / 2];
#pragma unroll
  for (int mb = 0; mb < 2; ++mb)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[mb][i] = sum[mb][i] = 0.f;

  const int n_steps = (m.cb_end - m.cb_begin) * T::TAPS;
  const int h_seq = halos, j_seq = steps;

  auto wait_halo = [&](int i) {
    const int seq = h_seq + i;
    mbar_wait(&halo_wait[seq & 1], (seq >> 1) & 1);
  };

  // A of step j for row block mb: [mb][product][fragment register].
  auto load_a = [&](int j, uint32_t(&a)[2][NK][4], int mb) {
    const int i = j / T::TAPS, tap = j - i * T::TAPS;
    const int shift = ((tap / 9) * T::HH + (tap / 3) % 3) * T::HW + tap % 3;
    const unsigned char* hb = halo + ((h_seq + i) & 1) * T::HALO_BYTES + 16 * t;
    {
      const unsigned char* r = hb + (row0[mb] + shift) * T::ROW_BYTES;
      uint4 v[LOADS], u[LOADS];  // rows g and g + 8
#pragma unroll
      for (int l = 0; l < LOADS; ++l) {
        const int off = 64 * (l ^ odd);
        v[l] = *reinterpret_cast<const uint4*>(r + off);
        u[l] = *reinterpret_cast<const uint4*>(r + 8 * T::ROW_BYTES + off);
      }
#pragma unroll
      for (int h = 0; h < LOADS; ++h) {  // chunk t + 4 h: products 2h and 2h + 1
        const uint4 vh = (h ^ odd) ? v[LOADS - 1] : v[0];
        const uint4 uh = (h ^ odd) ? u[LOADS - 1] : u[0];
        a[mb][2 * h][0] = vh.x;
        a[mb][2 * h][1] = uh.x;
        a[mb][2 * h][2] = vh.y;
        a[mb][2 * h][3] = uh.y;
        a[mb][2 * h + 1][0] = vh.z;
        a[mb][2 * h + 1][1] = uh.z;
        a[mb][2 * h + 1][2] = vh.w;
        a[mb][2 * h + 1][3] = uh.w;
      }
    }
  };

  auto release = [&](int j) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&w_empty[(j_seq + j) % T::STAGES]);
  };

  // Step j with A in `cur`; loads A of step j + 1 into `nxt`. Each row block
  // commits its own group, and its A of step j + 1 loads as soon as its own
  // group of step j - 1 is done (wait_group 2), while the other row block's
  // products run. Returns whether step j's weight stage is still held.
  auto step = [&](int j, uint32_t(&cur)[2][NK][4], uint32_t(&nxt)[2][NK][4], bool held_prev) {
    const int seq = j_seq + j, s = seq % T::STAGES;
    mbar_wait(&w_full[s], (seq / T::STAGES) & 1);
    const uint32_t wb = smem_u32(wst + s * T::W_BYTES);
    const bool last = (j + 1) % T::TAPS == 0, more = j + 1 < n_steps;
    bool held = true;
#pragma unroll
    for (int mb = 0; mb < 2; ++mb) {
      fence_regs<BN / 2>(acc[mb]);
      fence_regs<4 * NK>(&cur[mb][0][0]);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < NK; ++k)
        WgmmaBf16<BN>::mma(acc[mb], cur[mb][k], b_desc_k16(wb + k * BN * 32));
      wgmma_commit();
      wgmma_wait<2>();  // row block mb's group of step j - 1 is done
      fence_regs<BN / 2>(acc[0]);
      fence_regs<BN / 2>(acc[1]);
      fence_regs<4 * NK>(&nxt[mb][0][0]);
      if (mb == 1) {
        if (held_prev) release(j - 1);  // both groups of step j - 1 are done
        if (last) {  // the channel step's A is all in registers
          __syncwarp();
          if (lane == 0) mbar_arrive(&halo_empty[(h_seq + j / T::TAPS) & 1]);
          if constexpr (kPromote) {
            wgmma_wait<0>();
            fence_regs<BN / 2>(acc[0]);
            fence_regs<BN / 2>(acc[1]);
            release(j);
            held = false;
#pragma unroll
            for (int b2 = 0; b2 < 2; ++b2)
#pragma unroll
              for (int i = 0; i < BN / 2; ++i) {
                sum[b2][i] += acc[b2][i];
                acc[b2][i] = 0.f;
              }
          }
        }
      }
      if (more) {
        if (mb == 0 && last) wait_halo((j + 1) / T::TAPS);
        load_a(j + 1, nxt, mb);
      }
    }
    return held;
  };

  uint32_t a0[2][NK][4], a1[2][NK][4];
  wait_halo(0);
  load_a(0, a0, 0);
  load_a(0, a0, 1);
  bool held = false;
  int j = 0;
#pragma unroll 1
  for (; j + 1 < n_steps; j += 2) {
    held = step(j, a0, a1, held);
    held = step(j + 1, a1, a0, held);
  }
  if (j < n_steps) held = step(j, a0, a1, held);
  wgmma_wait<0>();
  fence_regs<BN / 2>(acc[0]);
  fence_regs<BN / 2>(acc[1]);
  fence_regs<8 * NK>(&a0[0][0][0]);
  fence_regs<8 * NK>(&a1[0][0][0]);
  if (held) release(n_steps - 1);
  halos = h_seq + (m.cb_end - m.cb_begin);
  steps = j_seq + n_steps;

  // Epilogue. Accumulator j of a row block holds (row g, col 8 j + 2 t),
  // (g, 8 j + 2 t + 1), (g + 8, 8 j + 2 t), (g + 8, 8 j + 2 t + 1): each
  // thread writes column pairs, fp32 into the split-K workspace, else
  // bf16(acc + bias + y) with one rounding; the bias of its columns is read
  // before the first store.
  const bool pairs = (Cout & 1) == 0;
  const int n0 = m.nb * BN;
  float bv[BN / 8][2];
#pragma unroll
  for (int jn = 0; jn < BN / 8; ++jn) {
    const int n = n0 + 8 * jn + 2 * t;
    bv[jn][0] = bias && !partial && n < Cout ? __bfloat162float(bias[n]) : 0.f;
    bv[jn][1] = bias && !partial && n + 1 < Cout ? __bfloat162float(bias[n + 1]) : 0.f;
  }
#pragma unroll
  for (int mb = 0; mb < 2; ++mb) {
    const int L = 4 * (2 * wg + mb) + warp;
    const int gd = m.d0 + L / T::TH, gh = m.h0 + L % T::TH;
    if (gd >= D || gh >= H) continue;
    const long long line = (((long long)m.b * D + gd) * H + gh) * W;
#pragma unroll
    for (int jn = 0; jn < BN / 8; ++jn) {
      const float* a = kPromote ? &sum[mb][4 * jn] : &acc[mb][4 * jn];
      const int n = n0 + 8 * jn + 2 * t;
      if (n >= Cout) continue;
      const bool second = n + 1 < Cout;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int gw = m.w0 + g + 8 * r;
        if (gw >= W) continue;
        const long long e = (line + gw) * Cout + n;
        float v0 = a[2 * r], v1 = a[2 * r + 1];
        if (partial) {
          float* p = partial + m.split * plane + e;
          if (pairs) {
            *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
          } else {
            p[0] = v0;
            if (second) p[1] = v1;
          }
          continue;
        }
        bf16* p = y + e;
        v0 += bv[jn][0];
        v1 += bv[jn][1];
        if (accumulate) {
          v0 += __bfloat162float(p[0]);
          if (second) v1 += __bfloat162float(p[1]);
        }
        if (pairs) {
          *reinterpret_cast<uint32_t*>(p) = pack_bf16x2(v0, v1);
        } else {
          p[0] = __float2bfloat16_rn(v0);
          if (second) p[1] = __float2bfloat16_rn(v1);
        }
      }
    }
  }
}

// Persistent: block k takes work items k, k + gridDim.x, ... (spatial tile
// fastest, then N tile, then split), so the producer loads the next item's
// halo and weights while the consumers finish this one.
template <int KD, int BN, int CK>
__global__ void __launch_bounds__(kTcThreads, tc_min_blocks(BN))
conv_3x3_bf16_kernel(const __grid_constant__ CUtensorMap xmap, const bf16* __restrict__ wimg,
                     const bf16* __restrict__ style, const bf16* __restrict__ shift, int silu,
                     const bf16* __restrict__ bias, bf16* __restrict__ y,
                     float* __restrict__ partial, long long plane, int B, int D, int H, int W,
                     int Cin, int Cout, int n_nb, int cb_per_split, int splits, int accumulate) {
  using T = BfTile<KD, BN, CK>;
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* halo = smem;                     // [2][HALO_BYTES]
  unsigned char* wst = smem + 2 * T::HALO_BYTES;  // [STAGES][W_BYTES]
  unsigned char* table = wst + T::STAGES * T::W_BYTES;  // [2][shift, style][CK] bf16
  uint64_t* bars = reinterpret_cast<uint64_t*>(table + T::TABLE_BYTES);
  uint64_t* halo_full = bars;
  uint64_t* halo_empty = bars + 2;
  uint64_t* w_full = bars + 4;
  uint64_t* w_empty = bars + 4 + T::STAGES;
  uint64_t* halo_ready = bars + 4 + 2 * T::STAGES;  // a rewritten halo: the operand pass

  const int tiles_w = (W + T::TW - 1) / T::TW;
  const int tiles_h = (H + T::TH - 1) / T::TH;
  const int tiles_d = (D + T::TD - 1) / T::TD;
  const int tiles = B * tiles_d * tiles_h * tiles_w;
  const int items = tiles * n_nb * splits;
  const int n_cb = (Cin + CK - 1) / CK;
  auto item_at = [&](int it) {
    BfItem m;
    int r = it % tiles;
    m.w0 = (r % tiles_w) * T::TW;
    r /= tiles_w;
    m.h0 = (r % tiles_h) * T::TH;
    r /= tiles_h;
    m.d0 = (r % tiles_d) * T::TD;
    m.b = r / tiles_d;
    r = it / tiles;
    m.nb = r % n_nb;
    m.split = r / n_nb;
    m.cb_begin = m.split * cb_per_split;
    m.cb_end = min(n_cb, m.cb_begin + cb_per_split);
    return m;
  };

  if (threadIdx.x == 0) {
    mbar_init(&halo_ready[0], 3);
    mbar_init(&halo_ready[1], 3);
  }
  init_stage_barriers<T::STAGES>(halo_full, halo_empty, w_full, w_empty);
  const bool pass = style || silu;  // the operand pass rewrites each halo

  int halos = 0, steps = 0;
  if (threadIdx.x >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(tc_producer_regs(BN)));
    if (threadIdx.x == kConsumers) {  // one thread keeps the halo and weight stages in flight
      bool issued = false;  // this item's first halo, with the previous item's
      for (int it = blockIdx.x; it < items; it += gridDim.x) {
        const BfItem m = item_at(it);
        const bf16* wblk = wimg + (long long)m.nb * n_cb * T::TAPS * (T::W_BYTES / 2);
        const bool more = it + static_cast<int>(gridDim.x) < items;
        HaloAt next{};
        if (more) {
          const BfItem n = item_at(it + gridDim.x);
          next = HaloAt{n.cb_begin, n.w0, n.h0, n.d0, n.b};
        }
        produce<KD, T::TAPS, T::HALO_BYTES, T::W_BYTES, CK, T::STAGES>(
            &xmap, reinterpret_cast<const unsigned char*>(wblk), halo, wst, halo_full,
            halo_empty, w_full, w_empty, m.cb_begin, m.cb_end, m.w0, m.h0, m.d0, m.b, halos,
            steps, issued, more ? &next : nullptr);
        issued = more;
      }
    } else if (pass && threadIdx.x >= kConsumers + 32) {
      for (int it = blockIdx.x; it < items; it += gridDim.x) {
        const BfItem m = item_at(it);
        uint32_t inside = 0;
        if constexpr (KD == 3)
          if (silu) inside = halo_inside<T::HD, T::HH, T::HW>(m, D, H, W);
        operand_halos<KD, T::HALO_BYTES, CK, T::HH, T::HW>(
            halo, table, halo_full, halo_ready, style ? style + (long long)m.b * Cin : nullptr,
            shift ? shift + (long long)m.b * Cin : nullptr, silu, Cin, m.cb_begin, m.cb_end,
            inside, halos);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(tc_consumer_regs(BN)));
    uint64_t* halo_wait = pass ? halo_ready : halo_full;
#pragma unroll 1
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
      const BfItem m = item_at(it);
      consume_bf16<KD, BN, CK>(halo, wst, halo_wait, halo_empty, w_full, w_empty, bias, y,
                               partial, plane, D, H, W, Cout, m, accumulate, halos, steps);
    }
  }
}

// y = bf16((accumulate ? y : 0) + bias + partial[0] + partial[1] + ...), the
// sum in fp32 in that order and rounded once.
__global__ void conv_3x3_splitk_reduce_bf16_kernel(const float* __restrict__ partial, int splits,
                                                   long long plane, const bf16* __restrict__ bias,
                                                   bf16* __restrict__ y, int Cout,
                                                   int accumulate) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < plane; i += stride) {
    float v = accumulate ? __bfloat162float(y[i]) : 0.f;
    if (bias) v += __bfloat162float(bias[i % Cout]);
    for (int s = 0; s < splits; ++s) v += partial[s * plane + i];
    y[i] = __float2bfloat16_rn(v);
  }
}

// ---------------------------------------------------------------------------
// fp32 weight gradient, 3xTF32 tensor cores (header: "The weight gradient").
// ---------------------------------------------------------------------------

// A stage: 32 output positions, two lines of 16 W positions at one depth of
// one image, with the x halo of its 27 taps, 3 x 4 x 18 positions of 16
// channels (one TMA box, 64-byte rows, 64-byte swizzle).
constexpr int kWgTH = 2, kWgTW = 16, kWgP = kWgTH * kWgTW;
constexpr int kWgHH = kWgTH + 2, kWgHW = kWgTW + 2;
constexpr int kWgHaloBytes = 3 * kWgHH * kWgHW * kCK * 4;
constexpr int kWgHaloStride = (kWgHaloBytes + 1023) / 1024 * 1024;  // swizzle atoms aligned
constexpr int kWgStages = 3;
constexpr int kWgPassThreads = 96;  // producer warps 1-3: the dy pass
constexpr int kWgConsumerRegs = 232, kWgProducerRegs = 40;
// Stages a chain of tensor-core accumulation runs before the consumers add
// it into the block's partial sums in device memory (IEEE fp32 adds): the
// tensor cores' fp32 accumulation loses precision with the chain's length
// (at 512 stages 1.4e-4 of the gradient's scale, at 8 stages 2.0e-6; an
// NVIDIA H100 80GB HBM3 at 700 W).
constexpr int kWgChain = 16;

// Row blocks a consumer warpgroup holds: about 128 accumulators a thread.
__host__ __device__ constexpr int wg_row_blocks(int bn) { return bn == 128 ? 2 : bn == 64 ? 4 : 7; }
// k8 steps a consumer warpgroup issues between waits: two at BN = 128 (its 2
// row blocks issue 6 products a step; two steps a wait ran 4-7% faster at
// most of the training step's shapes on an H100), one at BN = 64 and 32
// (their 4 and 7 row blocks issue 12 and 21 products a step, and the second
// step's A fragments spill at BN = 64).
__host__ __device__ constexpr int wg_k8_per_group(int bn) { return bn == 128 ? 2 : 1; }
// Where the style is applied: by the operand pass in place at BN = 32 (its
// consumers have no registers to spare for it), by the consumers as they load
// A otherwise (the pass's extra shared-memory traffic cost more there).
__host__ __device__ constexpr bool wg_style_in_pass(int bn) { return bn == 32; }

template <int BN>
struct WgTile {
  static constexpr int RB = wg_row_blocks(BN);
  static constexpr int SLOTS = 8 * RB;               // (channel group, tap) rows of 16 a block
  static constexpr int NCG = (SLOTS + 25) / 27 + 1;  // channel groups SLOTS consecutive pairs span
  static constexpr int RAW_BYTES = kWgP * BN * 4;    // dy as the TMA lands it, [position][BN]
  static constexpr int IMG_BYTES = kWgP * BN * 8;    // 4 k8 steps of [hi, lo] BN x 8, K-major
  static constexpr int STAGE_BYTES = NCG * kWgHaloStride + RAW_BYTES;
  static constexpr int BARS = 3 * kWgStages + 4;
  static constexpr int SMEM_BYTES = 1024 + kWgStages * STAGE_BYTES + 2 * IMG_BYTES + BARS * 8;
  static_assert(SMEM_BYTES <= 232448, "shared memory");
  static_assert(RAW_BYTES % 1024 == 0 && IMG_BYTES % 1024 == 0, "stage alignment");
};

// The channel pair of rows g and g + 8 of a warp's 16-channel group: lanes
// of one half warp (g < 4 or g >= 4) read the 16-byte chunks {0, 2} or
// {1, 3} of a halo row, which the 64-byte swizzle spreads over distinct banks
// for any four consecutive rows.
__device__ __forceinline__ int wg_channel(int g) {
  return 8 * ((g >> 1) & 1) + 4 * (g >> 2) + 2 * (g & 1);
}

// Byte offset of the 8-byte word at channel c (even) of halo row r under the
// TMA's 64-byte swizzle (address bits 4-5 ^= bits 7-8).
__device__ __forceinline__ int wg_halo_at(int r, int c) {
  return r * 64 + (((c >> 2) ^ ((r >> 1) & 3)) << 4) + (c & 3) * 4;
}

template <int BN>
__global__ void __launch_bounds__(kTcThreads, 1)
wgrad_3x3_tf32x3_kernel(const __grid_constant__ CUtensorMap xmap,
                        const __grid_constant__ CUtensorMap dymap, const float* __restrict__ style,
                        float* __restrict__ out, long long plane, int D, int H, int W, int Cin,
                        int Cout, int m_tiles, int n_tiles, long long tiles, int tiles_per_split) {
  using T = WgTile<BN>;
  constexpr int RB = T::RB, KS = wg_k8_per_group(BN);
  constexpr bool kPassStyle = wg_style_in_pass(BN);
  extern __shared__ unsigned char wg_smem[];
  unsigned char* smem = wg_smem + ((1024 - (smem_u32(wg_smem) & 1023)) & 1023);
  unsigned char* img = smem + kWgStages * T::STAGE_BYTES;  // [2][IMG_BYTES]
  uint64_t* full = reinterpret_cast<uint64_t*>(img + 2 * T::IMG_BYTES);  // x halos and raw dy
  uint64_t* x_empty = full + kWgStages;
  uint64_t* raw_empty = x_empty + kWgStages;
  uint64_t* img_full = raw_empty + kWgStages;
  uint64_t* img_empty = img_full + 2;

  int blk = blockIdx.x;
  const int mt = blk % m_tiles;
  blk /= m_tiles;
  const int nb = blk % n_tiles;
  const int split = blk / n_tiles;
  const long long t_begin = (long long)split * tiles_per_split;
  const int items = static_cast<int>(min((long long)tiles_per_split, tiles - t_begin));
  const int n_cg = (Cin + kCK - 1) / kCK;
  const int q0 = mt * T::SLOTS;
  const int cg_first = q0 / 27;
  const int cg_count = min(n_cg - 1, (q0 + T::SLOTS - 1) / 27) - cg_first + 1;
  const int tiles_w = (W + kWgTW - 1) / kWgTW, tiles_h = (H + kWgTH - 1) / kWgTH;
  auto origin = [&](int i, int& b, int& d, int& h0, int& w0) {
    long long t = t_begin + i;
    w0 = static_cast<int>(t % tiles_w) * kWgTW;
    t /= tiles_w;
    h0 = static_cast<int>(t % tiles_h) * kWgTH;
    t /= tiles_h;
    d = static_cast<int>(t % D);
    b = static_cast<int>(t / D);
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < kWgStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&x_empty[i], kConsumers / 32);
      mbar_init(&raw_empty[i], kWgPassThreads / 32);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&img_full[i], kWgPassThreads / 32);
      mbar_init(&img_empty[i], kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kWgProducerRegs));
    if (threadIdx.x == kConsumers) {
      // The copies: each stage's halos (one per channel group the block's
      // rows read) and its dy tile, on one barrier.
      for (int i = 0; i < items; ++i) {
        const int s = i % kWgStages, parity = ((i / kWgStages) & 1) ^ 1;
        mbar_wait(&x_empty[s], parity);
        mbar_wait(&raw_empty[s], parity);
        int b, d, h0, w0;
        origin(i, b, d, h0, w0);
        unsigned char* st = smem + s * T::STAGE_BYTES;
        mbar_expect_tx(&full[s], cg_count * kWgHaloBytes + T::RAW_BYTES);
        for (int c = 0; c < cg_count; ++c)
          tma_load_halo(st + c * kWgHaloStride, &xmap, &full[s], (cg_first + c) * kCK, w0 - 1,
                        h0 - 1, d - 1, b);
        tma_load_halo(st + T::NCG * kWgHaloStride, &dymap, &full[s], nb * BN, w0, h0, d, b);
      }
    } else if (threadIdx.x >= kConsumers + 32) {
      // The operand pass: each stage's halos multiplied by the style in place
      // (the 64-byte swizzle puts logical chunk pc ^ ((r >> 1) & 3) of row r
      // at 16-byte chunk pc), then its dy tile split into hi and lo and
      // written K-major (b_desc's layout), k8 step j holding positions 8j ..
      // 8j + 7.
      const int pt = threadIdx.x - kConsumers - 32;
      for (int i = 0; i < items; ++i) {
        const int s = i % kWgStages, m = i & 1;
        mbar_wait(&full[s], (i / kWgStages) & 1);
        if (kPassStyle && style) {
          int b, d, h0, w0;
          origin(i, b, d, h0, w0);
          for (int cl = 0; cl < cg_count; ++cl) {
            float4* halo = reinterpret_cast<float4*>(smem + s * T::STAGE_BYTES + cl * kWgHaloStride);
            const float* sb = style + (long long)b * Cin + (cg_first + cl) * kCK;
            for (int f = pt; f < kWgHaloBytes / 16; f += kWgPassThreads) {
              const int r = f >> 2, ch = 4 * ((f & 3) ^ ((r >> 1) & 3));
              if ((cg_first + cl) * kCK + ch >= Cin) continue;  // TMA zeros past Cin
              float4 v = halo[f];
              v.x *= sb[ch]; v.y *= sb[ch + 1]; v.z *= sb[ch + 2]; v.w *= sb[ch + 3];
              halo[f] = v;
            }
          }
        }
        mbar_wait(&img_empty[m], ((i >> 1) & 1) ^ 1);
        const float* raw =
            reinterpret_cast<const float*>(smem + s * T::STAGE_BYTES + T::NCG * kWgHaloStride);
        float* dst = reinterpret_cast<float*>(img + m * T::IMG_BYTES);
        for (int e = pt; e < 8 * BN; e += kWgPassThreads) {
          const int n = e % BN, kq = e / BN;  // positions 4 kq .. 4 kq + 3
          uint32_t hi[4], lo[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) split_tf32(raw[(4 * kq + r) * BN + n], hi[r], lo[r]);
          float* p = dst + (kq >> 1) * 16 * BN + (n >> 3) * 64 + (kq & 1) * 32 + (n & 7) * 4;
          *reinterpret_cast<uint4*>(p) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
          *reinterpret_cast<uint4*>(p + 8 * BN) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
        }
        // the consumers' wgmma reads the image through the async proxy
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        __syncwarp();
        if ((threadIdx.x & 31) == 0) {
          mbar_arrive(&img_full[m]);
          mbar_arrive(&raw_empty[s]);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kWgConsumerRegs));
  // Consumers: warpgroup wg holds row blocks wg * RB .. + RB - 1; in row block
  // rb, warp `warp` holds the 16 rows of pair q = q0 + 4 (wg RB + rb) + warp:
  // channel group q / 27 at tap q % 27, row g and g + 8 its channels c, c + 1.
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int c = wg_channel(g);
  const int pairs = 27 * n_cg;
  // shift: halo row of column 0 of the stage at the pair's tap, counted from
  // the first halo buffer (a buffer is a whole number of swizzle atoms, so
  // the swizzle reads the same from any of them)
  int shift[RB];
  bool valid[RB];
#pragma unroll
  for (int rb = 0; rb < RB; ++rb) {
    const int q = q0 + 4 * (wg * RB + rb) + warp;
    valid[rb] = q < pairs;
    const int tap = q % 27, cg = q / 27;
    shift[rb] = ((tap / 9) * kWgHH + (tap / 3) % 3) * kWgHW + tap % 3 +
                (valid[rb] ? (cg - cg_first) * (kWgHaloStride / 64) : 0);
  }
  float acc[RB][BN / 2];
#pragma unroll
  for (int rb = 0; rb < RB; ++rb)
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) acc[rb][e] = 0.f;

  // Adds the chain into this split's partial dW (stores it at the first
  // flush) and starts a new one. Accumulator 4 jn + e of a row block holds
  // rows g (e < 2) and g + 8 (channels c and c + 1), column 8 jn + 2 t + e % 2
  // (Cout % 4 == 0, so a pair of columns is in range or out together). Each
  // element has one thread, which alone reads and writes it.
  float* o = out + (long long)split * plane;
  const int n0 = nb * BN;
  auto flush = [&](bool first) {
#pragma unroll
    for (int rb = 0; rb < RB; ++rb) {
      const int q = q0 + 4 * (wg * RB + rb) + warp, ch = q / 27 * kCK + c;
      if (valid[rb] && ch < Cin) {
        float* row = o + ((long long)(q % 27) * Cin + ch) * Cout;
#pragma unroll
        for (int jn = 0; jn < BN / 8; ++jn) {
          const int n = n0 + 8 * jn + 2 * t;
          if (n >= Cout) continue;
          float2 v0 = make_float2(acc[rb][4 * jn], acc[rb][4 * jn + 1]);
          float2 v1 = make_float2(acc[rb][4 * jn + 2], acc[rb][4 * jn + 3]);
          float2* p0 = reinterpret_cast<float2*>(row + n);
          float2* p1 = reinterpret_cast<float2*>(row + Cout + n);
          if (!first) {
            const float2 a = *p0, b = *p1;
            v0.x += a.x; v0.y += a.y; v1.x += b.x; v1.y += b.y;
          }
          *p0 = v0;
          *p1 = v1;
        }
      }
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) acc[rb][e] = 0.f;
    }
  };

  for (int i = 0; i < items; ++i) {
    const int s = i % kWgStages, m = i & 1;
    float2 sv[RB];  // the style of the lane's two channels, where the consumers apply it
    int b = 0, d, h0, w0;
    if (!kPassStyle && style) origin(i, b, d, h0, w0);
#pragma unroll
    for (int rb = 0; rb < RB; ++rb) {
      sv[rb] = make_float2(1.f, 1.f);
      const int ch = (q0 + 4 * (wg * RB + rb) + warp) / 27 * kCK + c;
      if (!kPassStyle && style && valid[rb] && ch < Cin) {
        const float* sb = style + (long long)b * Cin + ch;
        sv[rb] = make_float2(sb[0], sb[1]);
      }
    }
    mbar_wait(&full[s], (i / kWgStages) & 1);
    mbar_wait(&img_full[m], (i >> 1) & 1);
    const unsigned char* xs = smem + s * T::STAGE_BYTES;
    const uint32_t ib = smem_u32(img + m * T::IMG_BYTES);
#pragma unroll 1
    for (int j0 = 0; j0 < 4; j0 += KS) {
      uint32_t ahi[KS][RB][4], alo[KS][RB][4];
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        // column t of k8 step j: line j / 2, position 8 (j % 2) + t of it
        const int j = j0 + kk, r_base = (j >> 1) * kWgHW + 8 * (j & 1) + t;
#pragma unroll
        for (int rb = 0; rb < RB; ++rb) {
          float2 v0 = make_float2(0.f, 0.f), v1 = v0;
          if (valid[rb]) {
            const int r0 = r_base + shift[rb];
            v0 = *reinterpret_cast<const float2*>(xs + wg_halo_at(r0, c));
            v1 = *reinterpret_cast<const float2*>(xs + wg_halo_at(r0 + 4, c));
            if (!kPassStyle && style) {
              v0.x *= sv[rb].x; v0.y *= sv[rb].y;
              v1.x *= sv[rb].x; v1.y *= sv[rb].y;
            }
          }
          // Fragment: (row g, col t), (g + 8, t), (g, t + 4), (g + 8, t + 4).
          split_tf32(v0.x, ahi[kk][rb][0], alo[kk][rb][0]);
          split_tf32(v0.y, ahi[kk][rb][1], alo[kk][rb][1]);
          split_tf32(v1.x, ahi[kk][rb][2], alo[kk][rb][2]);
          split_tf32(v1.y, ahi[kk][rb][3], alo[kk][rb][3]);
        }
      }
#pragma unroll
      for (int rb = 0; rb < RB; ++rb) {
        fence_regs<BN / 2>(acc[rb]);
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          fence_regs<4>(ahi[kk][rb]);
          fence_regs<4>(alo[kk][rb]);
        }
      }
      wgmma_fence();
      // every row block, those past the last pair on zeros: a branch
      // around a wgmma serializes the warpgroup's wgmmas (ptxas C7520)
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const int j = j0 + kk;
        const uint64_t dhi = b_desc(ib + j * BN * 64), dlo = b_desc(ib + j * BN * 64 + BN * 32);
#pragma unroll
        for (int rb = 0; rb < RB; ++rb) {
          Wgmma<BN>::mma(acc[rb], ahi[kk][rb], dlo);
          Wgmma<BN>::mma(acc[rb], alo[kk][rb], dhi);
          Wgmma<BN>::mma(acc[rb], ahi[kk][rb], dhi);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int rb = 0; rb < RB; ++rb) fence_regs<BN / 2>(acc[rb]);
    }
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(&x_empty[s]);
      mbar_arrive(&img_empty[m]);
    }
    if ((i + 1) % kWgChain == 0 || i + 1 == items) flush(i < kWgChain);
  }
}

// dw = partial[0] + partial[1] + ..., in that order: the split sum is the
// same from run to run. plane % 4 == 0 (Cout % 4 == 0).
__global__ void wgrad_splitk_reduce_kernel(const float* __restrict__ partial, int splits,
                                           long long plane, float* __restrict__ dw) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < plane / 4;
       i += stride) {
    float4 v = reinterpret_cast<const float4*>(partial)[i];
    for (int s = 1; s < splits; ++s) {
      const float4 p = reinterpret_cast<const float4*>(partial + s * plane)[i];
      v.x += p.x; v.y += p.y; v.z += p.z; v.w += p.w;
    }
    reinterpret_cast<float4*>(dw)[i] = v;
  }
}

// ---------------------------------------------------------------------------
// Host side.
// ---------------------------------------------------------------------------

enum Dtype { kFloat32 = 0, kBfloat16 = 1 };
enum Variant {
  kNone = -1,  // a bf16 shape that no instance takes
  kFfma = 0,
  kTf32x3 = 1,
  kTf32x3SplitK = 2,
  kBf16 = 3,
  kBf16SplitK = 4
};

struct Plan {
  int variant = kFfma;
  int bn = 0, ck = kCK, n_nb = 0, n_cb = 0, splits = 1, cb_per_split = 0;
  long long tiles = 0, wsplit_floats = 0, partial_offset = 0, bytes = 0;
};

int cdiv(long long a, long long b) { return static_cast<int>((a + b - 1) / b); }

// The current device's multiprocessor count, asked of the runtime once per
// device.
int sm_count() {
  static std::atomic<int> cached[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  int n = cached[dev].load(std::memory_order_relaxed);
  if (n <= 0) {
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n <= 0)
      n = 132;
    cached[dev].store(n, std::memory_order_relaxed);
  }
  return n;
}

// The variant and tiling of one shape. splits <= 0 chooses the split count
// from the card's SMs (the split-K rule above); splits > 0 takes that count,
// at most one split a channel step. bf16 has the tensor-core variant only:
// Cin % 8 == 0 (16-byte tensor-map strides) and a 16-byte aligned x; its
// channel step is 64 at BN = 64 and 128 with Cin > 32, else 32 (see the
// header).
Plan make_plan(int kd, int dtype, int B, int D, int H, int W, int Cin, int Cout, const void* x,
               int splits) {
  Plan p;
  const bool bf = dtype == kBfloat16;
  if (bf && (Cin % 8 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0)) {
    p.variant = kNone;
    return p;
  }
  if (Cin % 4 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0) return p;
  p.bn = Cout <= 32 ? 32 : Cout <= 64 ? 64 : 128;
  const int td = kd == 3 ? 4 : 1, th = 16 / td;
  p.tiles = (long long)B * cdiv(D, td) * cdiv(H, th) * cdiv(W, 16);
  p.n_nb = cdiv(Cout, p.bn);
  if (bf) p.ck = p.bn == 32 || Cin <= 32 ? 32 : 64;
  p.n_cb = cdiv(Cin, p.ck);
  int s = splits < p.n_cb ? splits : p.n_cb;
  if (s <= 0) {
    const long long blocks = p.tiles * p.n_nb;
    const long long wave = (long long)sm_count() * tc_min_blocks(p.bn);
    s = 1;
    while (2 * blocks * s < 3 * wave && s * 2 <= p.n_cb) s *= 2;  // under 1.5 waves
  }
  p.cb_per_split = cdiv(p.n_cb, s);
  p.splits = cdiv(p.n_cb, p.cb_per_split);
  if (bf) {
    p.variant = p.splits > 1 ? kBf16SplitK : kBf16;
    // one bf16 image of BN x ck per (N tile, channel step, tap)
    p.wsplit_floats = (long long)p.n_nb * p.n_cb * kd * 9 * p.ck * p.bn / 2;
  } else {
    p.variant = p.splits > 1 ? kTf32x3SplitK : kTf32x3;
    p.wsplit_floats = (long long)p.n_nb * p.n_cb * kd * 9 * 32 * p.bn;
  }
  p.partial_offset = (p.wsplit_floats * 4 + 255) / 256 * 256;
  p.bytes = p.partial_offset +
            (p.splits > 1 ? 4LL * p.splits * B * D * H * W * Cout : 0);
  return p;
}

// The TMA map of x (B, D, H, W, Cin) for a halo box of (ck, HW, HH, HD, 1)
// elements; out-of-bounds elements (the SAME padding, channels past Cin)
// read as zeros.
bool encode_halo_map(CUtensorMap* map, bool bf, const void* x, int B, int D, int H, int W,
                     int Cin, int ck, int hw, int hh, int hd,
                     CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_NONE) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t e = bf ? 2 : 4;
  const cuuint64_t dims[5] = {(cuuint64_t)Cin, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)D,
                              (cuuint64_t)B};
  const cuuint64_t strides[4] = {e * Cin, e * W * Cin, e * H * W * Cin, e * D * H * W * Cin};
  const cuuint32_t box[5] = {(cuuint32_t)ck, (cuuint32_t)hw, (cuuint32_t)hh, (cuuint32_t)hd, 1};
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  return encode(map, bf ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 5,
                const_cast<void*>(x), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int KD, int BN>
int launch_tc(const Plan& p, const float* x, const float* w, const float* style,
              const float* bias, float* y, int B, int D, int H, int W, int Cin, int Cout,
              long long w_stride_tap, long long w_stride_c, int accumulate, void* workspace,
              cudaStream_t stream) {
  using T = TcTile<KD, BN>;
  if (!workspace || p.tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (!encode_tiled()) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap xmap;
  if (!encode_halo_map(&xmap, false, x, B, D, H, W, Cin, kCK, T::HW, T::HH, T::HD))
    return static_cast<int>(cudaErrorInvalidValue);

  float* wsplit = static_cast<float*>(workspace);
  float* partial = p.splits > 1
                       ? reinterpret_cast<float*>(static_cast<char*>(workspace) + p.partial_offset)
                       : nullptr;
  const long long plane = (long long)B * D * H * W * Cout;

  const int split_blocks = cdiv(p.wsplit_floats / 2, 256);
  conv_3x3_weight_split_kernel<<<split_blocks < 4096 ? split_blocks : 4096, 256, 0, stream>>>(
      w, wsplit, KD * 9, Cin, Cout, BN, w_stride_tap, w_stride_c);

  auto kernel = conv_3x3_tf32x3_kernel<KD, BN>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(static_cast<unsigned>(p.tiles), p.n_nb, p.splits);
  kernel<<<grid, kTcThreads, T::SMEM_BYTES, stream>>>(xmap, wsplit, style, bias, y, partial,
                                                      plane, D, H, W, Cin, Cout,
                                                      p.cb_per_split, accumulate);
  if (p.splits > 1) {
    const long long items = (Cout & 3) == 0 ? plane / 4 : plane;
    const int blocks = cdiv(items, 256) < 8192 ? cdiv(items, 256) : 8192;
    conv_3x3_splitk_reduce_kernel<<<blocks, 256, 0, stream>>>(partial, p.splits, plane, bias, y,
                                                              Cout, accumulate);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int KD>
int launch_tc_entry(const Plan& p, const float* x, const float* w, const float* style,
                    const float* bias, float* y, int B, int D, int H, int W, int Cin, int Cout,
                    long long w_stride_tap, long long w_stride_c, int accumulate,
                    void* workspace, cudaStream_t s) {
  if (p.bn == 32)
    return launch_tc<KD, 32>(p, x, w, style, bias, y, B, D, H, W, Cin, Cout, w_stride_tap,
                             w_stride_c, accumulate, workspace, s);
  if (p.bn == 64)
    return launch_tc<KD, 64>(p, x, w, style, bias, y, B, D, H, W, Cin, Cout, w_stride_tap,
                             w_stride_c, accumulate, workspace, s);
  return launch_tc<KD, 128>(p, x, w, style, bias, y, B, D, H, W, Cin, Cout, w_stride_tap,
                            w_stride_c, accumulate, workspace, s);
}

template <int KD, int BN, int CK>
int launch_bf16(const Plan& p, const bf16* x, const bf16* w, const bf16* style, const bf16* shift,
                int silu, const bf16* bias, bf16* y, int B, int D, int H, int W, int Cin,
                int Cout, long long w_stride_tap, long long w_stride_c, int accumulate,
                void* workspace, cudaStream_t stream) {
  using T = BfTile<KD, BN, CK>;
  if (!workspace || p.tiles * p.n_nb * p.splits > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!encode_tiled()) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap xmap;
  if (!encode_halo_map(&xmap, true, x, B, D, H, W, Cin, CK, T::HW, T::HH, T::HD))
    return static_cast<int>(cudaErrorInvalidValue);

  bf16* wimg = static_cast<bf16*>(workspace);
  float* partial = p.splits > 1
                       ? reinterpret_cast<float*>(static_cast<char*>(workspace) + p.partial_offset)
                       : nullptr;
  const long long plane = (long long)B * D * H * W * Cout;

  const int pack_blocks = cdiv(p.wsplit_floats * 2, 256);  // one thread per bf16
  conv_3x3_weight_bf16_kernel<<<pack_blocks < 4096 ? pack_blocks : 4096, 256, 0, stream>>>(
      w, wimg, KD * 9, Cin, Cout, BN, CK, w_stride_tap, w_stride_c);

  auto kernel = conv_3x3_bf16_kernel<KD, BN, CK>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  // persistent: at most one wave of blocks
  const long long items = p.tiles * p.n_nb * p.splits;
  const long long wave = (long long)sm_count() * tc_min_blocks(BN);
  kernel<<<static_cast<unsigned>(items < wave ? items : wave), kTcThreads, T::SMEM_BYTES,
           stream>>>(xmap, wimg, style, shift, silu, bias, y, partial, plane, B, D, H, W, Cin,
                     Cout, p.n_nb, p.cb_per_split, p.splits, accumulate);
  if (p.splits > 1) {
    const int blocks = cdiv(plane, 256) < 8192 ? cdiv(plane, 256) : 8192;
    conv_3x3_splitk_reduce_bf16_kernel<<<blocks, 256, 0, stream>>>(partial, p.splits, plane, bias,
                                                                   y, Cout, accumulate);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int KD>
int launch_bf16_entry(const Plan& p, const void* x, const void* w, const void* style,
                      const void* shift, int silu, const void* bias, void* y, int B, int D, int H,
                      int W, int Cin, int Cout, long long w_stride_tap, long long w_stride_c,
                      int accumulate, void* workspace, cudaStream_t s) {
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(w);
  const bf16* sb = static_cast<const bf16*>(style);
  const bf16* hb = static_cast<const bf16*>(shift);
  const bf16* bb = static_cast<const bf16*>(bias);
  bf16* yb = static_cast<bf16*>(y);
  // (BN, channel step): make_plan's rule
  if (p.bn == 32)
    return launch_bf16<KD, 32, 32>(p, xb, wb, sb, hb, silu, bb, yb, B, D, H, W, Cin, Cout,
                                   w_stride_tap, w_stride_c, accumulate, workspace, s);
  if (p.bn == 64 && p.ck == 32)
    return launch_bf16<KD, 64, 32>(p, xb, wb, sb, hb, silu, bb, yb, B, D, H, W, Cin, Cout,
                                   w_stride_tap, w_stride_c, accumulate, workspace, s);
  if (p.bn == 64)
    return launch_bf16<KD, 64, 64>(p, xb, wb, sb, hb, silu, bb, yb, B, D, H, W, Cin, Cout,
                                   w_stride_tap, w_stride_c, accumulate, workspace, s);
  if (p.ck == 32)
    return launch_bf16<KD, 128, 32>(p, xb, wb, sb, hb, silu, bb, yb, B, D, H, W, Cin, Cout,
                                    w_stride_tap, w_stride_c, accumulate, workspace, s);
  return launch_bf16<KD, 128, 64>(p, xb, wb, sb, hb, silu, bb, yb, B, D, H, W, Cin, Cout,
                                  w_stride_tap, w_stride_c, accumulate, workspace, s);
}

// One launch of either dtype's instances for the plan's variant.
template <int KD>
int launch_any(const Plan& p, int dtype, const void* x, const void* w, const void* style,
               const void* shift, int silu, const void* bias, void* y, int B, int D, int H,
               int W, int Cin, int Cout, long long w_stride_tap, long long w_stride_c,
               int accumulate, void* workspace, cudaStream_t s) {
  if (p.variant == kNone) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kBfloat16)
    return launch_bf16_entry<KD>(p, x, w, style, shift, silu, bias, y, B, D, H, W, Cin, Cout,
                                 w_stride_tap, w_stride_c, accumulate, workspace, s);
  // no fp32 instance applies a pre-activation
  if (shift || silu) return static_cast<int>(cudaErrorInvalidValue);
  const float *xf = static_cast<const float*>(x), *wf = static_cast<const float*>(w);
  const float *sf = static_cast<const float*>(style), *bf = static_cast<const float*>(bias);
  float* yf = static_cast<float*>(y);
  if (p.variant == kFfma)
    return launch_ffma_entry(KD, xf, wf, sf, bf, yf, B, D, H, W, Cin, Cout, w_stride_tap,
                             w_stride_c, accumulate, s);
  return launch_tc_entry<KD>(p, xf, wf, sf, bf, yf, B, D, H, W, Cin, Cout, w_stride_tap,
                             w_stride_c, accumulate, workspace, s);
}

// The weight gradient's tiling of one shape (header: "The weight
// gradient"): the N tile, the blocks' row tiles of (channel group, tap) pairs,
// the stages (position tiles) and their split over blocks. splits <= 0
// chooses the split count: the SMs over the row and N tiles, at least 1 and
// at most the stages; splits > 0 takes that count, at most one split a stage.
// Refused (ok false): Cin or Cout not a multiple of 4, or an x or dy that is
// not 16-byte aligned (the TMA maps' strides and bases).
struct WgPlan {
  bool ok = false;
  int bn = 0, m_tiles = 0, n_tiles = 0, splits = 1, tiles_per_split = 0;
  long long tiles = 0, bytes = 0;
};

WgPlan make_wgrad_plan(int B, int D, int H, int W, int Cin, int Cout, const void* x,
                       const void* dy, int splits) {
  WgPlan p;
  if (Cin < 1 || Cout < 1 || Cin % 4 != 0 || Cout % 4 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(dy) % 16 != 0)
    return p;
  p.ok = true;
  p.bn = Cout <= 32 ? 32 : Cout <= 64 ? 64 : 128;
  p.m_tiles = cdiv(27LL * cdiv(Cin, kCK), 8 * wg_row_blocks(p.bn));
  p.n_tiles = cdiv(Cout, p.bn);
  p.tiles = (long long)B * D * cdiv(H, kWgTH) * cdiv(W, kWgTW);
  const long long blocks = (long long)p.m_tiles * p.n_tiles;
  long long s = splits > 0 ? splits : sm_count() / blocks;
  s = s < 1 ? 1 : s;
  s = s > p.tiles ? p.tiles : s;
  p.tiles_per_split = s > 0 ? cdiv(p.tiles, s) : 0;
  p.splits = s > 0 ? cdiv(p.tiles, p.tiles_per_split) : 1;
  p.bytes = p.splits > 1 ? 4LL * p.splits * 27 * Cin * Cout : 0;
  return p;
}

template <int BN>
int launch_wgrad(const WgPlan& p, const float* x, const float* style, const float* dy, float* dw,
                 int B, int D, int H, int W, int Cin, int Cout, void* workspace,
                 cudaStream_t stream) {
  using T = WgTile<BN>;
  const long long blocks = (long long)p.m_tiles * p.n_tiles * p.splits;
  if ((p.splits > 1 && !workspace) || blocks > 0x7fffffffLL || p.tiles < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!encode_tiled()) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap xmap, dymap;
  if (!encode_halo_map(&xmap, false, x, B, D, H, W, Cin, kCK, kWgHW, kWgHH, 3,
                       CU_TENSOR_MAP_SWIZZLE_64B) ||
      !encode_halo_map(&dymap, false, dy, B, D, H, W, Cout, BN, kWgTW, kWgTH, 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long plane = 27LL * Cin * Cout;
  float* out = p.splits > 1 ? static_cast<float*>(workspace) : dw;
  auto kernel = wgrad_3x3_tf32x3_kernel<BN>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), kTcThreads, T::SMEM_BYTES, stream>>>(
      xmap, dymap, style, out, plane, D, H, W, Cin, Cout, p.m_tiles, p.n_tiles, p.tiles,
      p.tiles_per_split);
  if (p.splits > 1) {
    const int n = cdiv(plane / 4, 256) < 8192 ? cdiv(plane / 4, 256) : 8192;
    wgrad_splitk_reduce_kernel<<<n, 256, 0, stream>>>(out, p.splits, plane, dw);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Which variant the entries launch for this shape and dtype (0: float32, 1:
// bfloat16): -1 none (a bf16 shape with Cin % 8 != 0 or an x that is not
// 16-byte aligned), 0 fp32 FMA, 1 3xTF32 tensor cores, 2 the same with
// split-K, 3 bf16 tensor cores, 4 the same with split-K; the split count to
// pass the entries and the workspace bytes it needs (0 for the FMA variant),
// on the current device; kd = 3 for tmdiff_conv3d_333, 1 for
// tmdiff_conv2d_33 (with D = 1). *splits comes in as the split count wanted
// (0: the split-K rule's) and goes out as the count the entries will take.
int tmdiff_conv_plan(int kd, int dtype, int B, int D, int H, int W, int Cin, int Cout,
                     const void* x, long long* workspace_bytes, int* splits) {
  const Plan p = make_plan(kd, dtype, B, D, H, W, Cin, Cout, x, *splits);
  *workspace_bytes = p.bytes;
  *splits = p.splits;
  return p.variant;
}

// Returns a cudaError_t value: 0 when the launches were accepted. Every
// tensor has the given dtype. The weight element (tap, c, o) lies at
// w[tap * w_stride_tap + c * w_stride_c + o], so the wrapper can pass slices
// of a larger weight (a concat part's input channels, one group of a grouped
// conv) without copying them. `splits` and `workspace` are tmdiff_conv_plan's
// split count and bytes for this shape, the workspace allocated by the
// caller. `silu` (nonzero: on) and `shift` (B, Cin) or null are the
// pre-activation of the input, x -> silu(x + shift), applied before the style
// and padded after it; bf16 only (an fp32 call with either, or a shift
// without the SiLU, is refused).
int tmdiff_conv3d_333(int dtype, const void* x, const void* w, const void* style,
                      const void* shift, int silu, const void* bias, void* y, int B, int D, int H,
                      int W, int Cin, int Cout, long long w_stride_tap, long long w_stride_c,
                      int accumulate, int splits, void* workspace, void* stream) {
  if (splits < 1 || (shift && !silu)) return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan(3, dtype, B, D, H, W, Cin, Cout, x, splits);
  return launch_any<3>(p, dtype, x, w, style, shift, silu, bias, y, B, D, H, W, Cin, Cout,
                       w_stride_tap, w_stride_c, accumulate, workspace,
                       static_cast<cudaStream_t>(stream));
}

// The same for a 3x3 NHWC conv, (B, H, W, Cin) -> (B, H, W, Cout): one depth
// tap and a tile one position deep. It writes y and never accumulates into it.
int tmdiff_conv2d_33(int dtype, const void* x, const void* w, const void* style,
                     const void* bias, void* y, int B, int H, int W, int Cin, int Cout,
                     long long w_stride_tap, long long w_stride_c, int splits, void* workspace,
                     void* stream) {
  if (splits < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan(1, dtype, B, 1, H, W, Cin, Cout, x, splits);
  return launch_any<1>(p, dtype, x, w, style, nullptr, 0, bias, y, B, 1, H, W, Cin, Cout,
                       w_stride_tap, w_stride_c, 0, workspace, static_cast<cudaStream_t>(stream));
}

// The fp32 weight gradient of the SAME 3x3x3 conv: whether the kernel takes
// this shape (1) or not (0: Cin or Cout not a multiple of 4, an x or dy not
// 16-byte aligned), the split count to pass tmdiff_wgrad_333 and the
// workspace bytes it needs, on the current device. *splits comes in as the
// split count wanted (0: the plan's rule) and goes out as the count taken.
int tmdiff_wgrad_plan(int B, int D, int H, int W, int Cin, int Cout, const void* x,
                      const void* dy, long long* workspace_bytes, int* splits) {
  const WgPlan p = make_wgrad_plan(B, D, H, W, Cin, Cout, x, dy, *splits);
  *workspace_bytes = p.bytes;
  *splits = p.splits;
  return p.ok ? 1 : 0;
}

// dw (3, 3, 3, Cin, Cout) = sum over (b, d, h, w) of
// (x * s)[b, d + i - 1, h + j - 1, w + k - 1, c] * dy[b, d, h, w, o], zeros
// outside x; x (B, D, H, W, Cin), dy (B, D, H, W, Cout), s (B, Cin) or null,
// all fp32 and contiguous. `splits` and `workspace` are tmdiff_wgrad_plan's.
// Returns a cudaError_t value: 0 when the launches were accepted.
int tmdiff_wgrad_333(const void* x, const void* style, const void* dy, void* dw, int B, int D,
                     int H, int W, int Cin, int Cout, int splits, void* workspace,
                     void* stream) {
  if (splits < 1) return static_cast<int>(cudaErrorInvalidValue);
  const WgPlan p = make_wgrad_plan(B, D, H, W, Cin, Cout, x, dy, splits);
  if (!p.ok) return static_cast<int>(cudaErrorInvalidValue);
  const float *xf = static_cast<const float*>(x), *sf = static_cast<const float*>(style),
              *df = static_cast<const float*>(dy);
  float* wf = static_cast<float*>(dw);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.bn == 32)
    return launch_wgrad<32>(p, xf, sf, df, wf, B, D, H, W, Cin, Cout, workspace, s);
  if (p.bn == 64)
    return launch_wgrad<64>(p, xf, sf, df, wf, B, D, H, W, Cin, Cout, workspace, s);
  return launch_wgrad<128>(p, xf, sf, df, wf, B, D, H, W, Cin, Cout, workspace, s);
}

const char* tmdiff_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
