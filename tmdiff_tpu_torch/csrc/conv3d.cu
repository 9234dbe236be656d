// SAME, stride-1 convolutions with a 3x3 spatial window over channels-last
// activations, fp32 in and out, fp32 accumulation. Two entries share one
// kernel template over the number of depth taps KD:
//
//   KD = 3, tmdiff_conv3d_333: (B, D, H, W, Cin) with the spectral bands as
//     depth, kernel (3, 3, 3, Cin, Cout);
//   KD = 1, tmdiff_conv2d_33: (B, H, W, Cin) NHWC, kernel (3, 3, Cin, Cout),
//     run as D = 1.
//
//   y[b,d,h,w,o] = bias[o] (+ y[b,d,h,w,o] when accumulating)
//                + sum_{i,j,k,c} W[i,j,k,c,o] * s[b,c] * x[b,d+i-KD/2,h+j-1,w+k-1,c]
//
// with zeros outside the input. `s` (B, Cin) is the per-sample style of a
// modulated conv and `bias` (Cout) the conv bias; both are optional. The
// accumulate mode (3x3x3 entry only) lets a decoder conv over a channel concat
// run one launch per part without materialising the concat.
//
// Replaces the Pallas TPU kernels tmdiff_tpu/ops/pallas/banded_conv3d.py
// `banded_conv3d` (_kernel) and `banded_conv3d_v2` (_kernel_v2) with KD = 3,
// and tmdiff_tpu/ops/pallas/conv2d.py `conv3x3_nhwc` (_kernel: 9 accumulated
// MXU matmuls per 8-row strip plus a 2-row halo) with KD = 1. The TPU kernels
// fold bands into the 128 MXU lanes and tile H in 8-row strips; this kernel
// ports the functions, not that tiling, and takes any H and W.
//
// What bounds it on an H100: operations. A WavBEST 3x3x3 conv does 2*27*Cin
// FLOPs per output element against about (Cin + Cout) * 4 bytes of traffic,
// and the band-folded 2-D conv (Cin, Cout = D x 32..64 = 128..512) 2*9*Cin:
// 1-5 kFLOP per 100-4000 bytes, far above the fp32 ridge (67 TFLOP/s over
// 3.35 TB/s = 20 FLOP/byte). The design is an implicit GEMM on the fp32 FMA
// pipes (M = positions, N = Cout, K = KD * 9 * Cin):
//   * one block per output tile of TD x TH x TW positions by BN channels;
//   * per step of kBK input channels, the input halo
//     (TD+KD-1)(TH+2)(TW+2) is staged in shared memory once, with the style
//     scale applied and the zero padding written in, and reused by all
//     KD * 9 taps; the weight slices of those channels are staged beside it;
//   * each thread keeps an 8 x 8 register tile (8 consecutive W positions by
//     8 channels): 16 shared loads per 64 FMAs;
//   * the bias and the accumulate read sit in the epilogue.
// No tensor cores (wgmma), TMA or pipelining yet: those are later work.

#include <cuda_runtime.h>

namespace {

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
conv_3x3_kernel(const float* __restrict__ x, const float* __restrict__ w,
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
int launch(const float* x, const float* w, const float* style, const float* bias, float* y,
           int B, int D, int H, int W, int Cin, int Cout, long long w_stride_tap,
           long long w_stride_c, int accumulate, cudaStream_t stream) {
  using T = Tile<KD, BN, TD, TH, TW>;
  auto kernel = conv_3x3_kernel<KD, BN, TD, TH, TW>;
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

}  // namespace

extern "C" {

// Returns a cudaError_t value: 0 when the launch was accepted. The weight
// element (tap, c, o) lies at w[tap * w_stride_tap + c * w_stride_c + o], so
// the wrapper can pass slices of a larger weight (a concat part's input
// channels, one group of a grouped conv) without copying them.
int tmdiff_conv3d_333(const float* x, const float* w, const float* style,
                      const float* bias, float* y, int B, int D, int H, int W, int Cin,
                      int Cout, long long w_stride_tap, long long w_stride_c,
                      int accumulate, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Cout % 64 == 0)
    return launch<3, 64, 2, 4, 32>(x, w, style, bias, y, B, D, H, W, Cin, Cout, w_stride_tap,
                                   w_stride_c, accumulate, s);
  return launch<3, 32, 2, 8, 32>(x, w, style, bias, y, B, D, H, W, Cin, Cout, w_stride_tap,
                                 w_stride_c, accumulate, s);
}

// The same for a 3x3 NHWC conv, (B, H, W, Cin) -> (B, H, W, Cout): one depth
// tap and a tile one position deep, so the 256 threads cover 8 or 16 rows.
// It writes y and never accumulates into it.
int tmdiff_conv2d_33(const float* x, const float* w, const float* style,
                     const float* bias, float* y, int B, int H, int W, int Cin, int Cout,
                     long long w_stride_tap, long long w_stride_c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Cout % 64 == 0)
    return launch<1, 64, 1, 8, 32>(x, w, style, bias, y, B, 1, H, W, Cin, Cout, w_stride_tap,
                                   w_stride_c, 0, s);
  return launch<1, 32, 1, 16, 32>(x, w, style, bias, y, B, 1, H, W, Cin, Cout, w_stride_tap,
                                  w_stride_c, 0, s);
}

const char* tmdiff_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
