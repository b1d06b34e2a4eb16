// The float32 engine of the fused encoder (A2 forward, encoder_fwd.cu; A3
// backward, encoder_bwd.cu) for Hopper, sm_90a: every grouped convolution
// whose input channels per group are a multiple of 16 (all but conv1), and
// every weight gradient of those, as plain FMA at full float32 (no TF32, no
// tensor cores). conv1 stays on the SIMT kernels of encoder_common.cuh and
// encoder_bwd.cu. Included by encoder_common.cuh after ConvArgs and
// conv_store, which it uses.
//
// Replaces, with the SIMT kernels, the TPU kernels
// electrocardio_panorama_tpu/ops/pallas/encoder_fused.py::_fwd_kernel and
// ::_bwd_kernel.
//
// Convolutions (conv_kernel_fma<KA, SA, KB>): a block takes 64 output
// channels x 64 output positions (half a sample at T=128, 2 or 4 whole
// samples at T=32 / 16) with two groups of 64 threads; each thread holds 8
// channels x (4 + 4) positions in registers, and the two groups take the
// two halves of every chunk of 16 input channels. Per chunk the input rows
// are staged once with the taps' halo, as [ci][segment][row] float32, so a
// tap is an offset into the staged row and not a new row; the weights are
// packed once per launch into [g][tap][ci][o] (pack_kernel; a data
// gradient's transposed, flipped weights are only other strides there), so
// both stagings are straight 16-byte cp.async copies into a double buffer.
// Per input channel a thread reads its positions' taps with 2 x NXV float4
// loads and, per tap, 8 weights with two float4 loads (broadcast across the
// positions' threads), for 64 FMAs per tap: shared loads are not the limit.
// The second operand c.b accumulates into the same registers after the
// first. The groups' sums meet in a [64][64] tile in shared memory (group 1's
// added to group 0's, a fixed order), from which the block runs
// conv_store, the epilogue the other engines run, along output rows.
//
// Weight gradients (dw_kernel_fma<K>): dW_k[o][i] = sum_p dy[o][p] * X[i][p +
// k - pad] over one of the fixed position ranges, a (BO x BI) tile of (o, i)
// for all K taps per block. Per chunk of 32 positions (two segments of 16,
// each inside one sample) dy is staged as [o][p] and X with the taps' halo
// as [i][row]; a thread walks the positions of a segment with the X rows of
// its K taps in a register ring, so each X value is read once for all taps
// and one dy value serves K x (its input channels) FMAs. Per-thread tiles
// keep K x tile accumulators near 100 registers: 4 x 4 at k7, 8 x 4 at k3,
// 8 x 8 at k1. The partial sums leave through shared memory as whole rows;
// encoder_bwd.cu's dw_reduce_kernel adds the ranges in a fixed order: no
// atomics, so the gradients stay bitwise equal across repeats and
// encoder_ckpt modes.
//
// Bound. At B=32, L=3 A3 is about 59 GFLOP of products against about 1 GB
// of float32 planes: 0.88 ms of operations at the 67 TFLOP/s float32 FMA
// peak against 0.3 ms of memory, so operations bound it. The register
// tiles keep the FMA pipes, not the shared-memory loads, the limit of the
// main loops; what keeps a conv from the peak is its epilogue (the
// residual, dropout and relu-mask planes read and the output written by
// every block of a one-wave grid at once) and the staging copies.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_ptx.cuh"

namespace enc {
namespace fma {

constexpr int BM = 64;       // output channels per conv block
constexpr int BN = 64;       // output positions per conv block
constexpr int CI_T = 16;     // input channels per staged chunk
constexpr int GROUPS = 2;    // conv blocks: two groups of 8 x 8 threads, each taking CI_T / 2 of every chunk
constexpr int THREADS = 64 * GROUPS;
constexpr int MIN_BLOCKS = 3;  // conv blocks per SM: at most 168 registers a thread

using namespace tcptx;  // cp.async

// ------------------------------------------------------------- weight packing
// out[((g*K + k)*cig + ci)*cog + o] = W(g, o, ci, k), from the operand's
// strides (a data gradient's are negative along k).
__global__ void pack_kernel(const Operand<float, float> a, int cog, long long n, float* __restrict__ out) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const int o = (int)(e % cog);
  long long r = e / cog;
  const int ci = (int)(r % a.cig);
  r /= a.cig;
  const int k = (int)(r % a.K);
  const long long g = r / a.K;
  out[e] = a.w[g * a.wsG + o * a.wsO + ci * a.wsI + k * a.wsK];
}

// ------------------------------------------------------------- conv engine
// The taps the engine runs: K at stride S with padding PAD (a 'same' conv,
// or the transposed conv's data gradient, k2 s2). A segment's staged rows
// start HALO input steps before its first (16-byte aligned); a position's
// taps start OFF rows after its own, and its group of 4 positions reads NXV
// float4 rows.
template <int K, int S>
struct Taps {
  static constexpr int PAD = S == 1 ? (K - 1) / 2 : 0;
  static constexpr int HALO = PAD > 0 ? 4 : 0;
  static constexpr int OFF = HALO - PAD;
  static constexpr int NXV = (OFF + 3 * S + K + 3) / 4;
};

// a block's positions: segs segments of steps positions (a whole sample, or
// BN of one), each staged as rows input steps
struct Geometry {
  int steps, segs, rows;
  __host__ __device__ Geometry(int S, int nxv, int Tout) {
    steps = Tout < BN ? Tout : BN;
    segs = BN / steps;
    rows = S * (steps - 4) + 4 * nxv;
  }
  __host__ __device__ int x_floats() const { return CI_T * segs * rows; }
};

// May this conv run on the engine? (every conv of the chain but conv1)
inline bool conv_ok(int cig, int cog, int Tout) {
  return cig % 16 == 0 && cog % BM == 0 && Tout % 16 == 0 && (Tout % BN == 0 || BN % Tout == 0);
}

// dynamic shared memory of one operand: input rows and weights, twice; and
// at least the epilogue's [BM][BN] tile
template <int K, int S>
inline int conv_smem_bytes(int Tout) {
  const Geometry geo(S, Taps<K, S>::NXV, Tout);
  const int pipeline = 2 * (geo.x_floats() + K * CI_T * BM) * 4, tile = BM * BN * 4;
  return pipeline > tile ? pipeline : tile;
}

// acc += the conv of operand a over this block's positions, with its packed
// weights wp: input channels in chunks of CI_T, each chunk's rows and weights
// copied into one half of the double buffer while the other is consumed; a
// thread of group grp takes the chunk's channels grp*CI_G .. +CI_G-1.
// acc[h][j][i]: output channel o0 + 8ty + j, position p0 + 32h + 4tx + i.
template <int K, int S>
__device__ __forceinline__ void conv_accumulate_fma(const Operand<float, float>& a, const float* __restrict__ wp,
                                                    int cog, int g, int o0, int p0, int N, int Tout,
                                                    float* smem, float (&acc)[2][8][4]) {
  using T = Taps<K, S>;
  constexpr int WF = K * CI_T * BM;
  constexpr int CI_G = CI_T / GROUPS;  // input channels of a chunk per group
  const int tid = threadIdx.x, tx = tid & 7, ty = (tid >> 3) & 7, grp = tid >> 6;
  const Geometry geo(S, T::NXV, Tout);
  const int XF = geo.x_floats();
  // buffer b: input rows at smem + b*(XF + WF), then weights
  auto xs = [&](int b) { return smem + b * (XF + WF); };
  auto ws = [&](int b) { return smem + b * (XF + WF) + XF; };
  const int chunks = a.cig / CI_T;
  const float* wg = wp + (long long)g * K * a.cig * cog + o0;
  const int rows4 = geo.rows / 4, seg4 = geo.segs * rows4;

  auto stage = [&](int ch, int buf) {
    const int ci0 = ch * CI_T;
    for (int e = tid; e < K * CI_T * (BM / 4); e += THREADS) {
      const int row = e / (BM / 4), col = e - row * (BM / 4);  // row = k*CI_T + ci
      const int k = row / CI_T, ci = row - k * CI_T;
      cp_async16(smem_u32(ws(buf) + row * BM + col * 4), wg + ((long long)k * a.cig + ci0 + ci) * cog + col * 4,
                 true);
    }
    // staged float4 e: channel e / seg4, segment s, rows 4*r4 .. 4*r4 + 3
    for (int e = tid; e < CI_T * seg4; e += THREADS) {
      const int ci = e / seg4, rr = e - ci * seg4;
      const int s = rr / rows4, r4 = rr - s * rows4;
      const int ps = p0 + s * geo.steps;
      const int n = ps / Tout;
      const int ti = (ps - n * Tout) * S - T::HALO + 4 * r4;
      const bool in = n < N && ti >= 0 && ti < a.xT;
      const float* src = a.x + ((long long)(in ? n : 0) * a.xC + g * a.x_gs + a.x_off + ci0 + ci) * a.xT + (in ? ti : 0);
      cp_async16(smem_u32(xs(buf) + 4 * e), src, in);
    }
    cp_async_commit();
  };

  // the staged row of each position group's first tap
  int xoff[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int pos = 32 * h + 4 * tx;
    const int s = pos / geo.steps, tl = pos - s * geo.steps;
    xoff[h] = s * geo.rows + tl * S;
  }
  const int cstride = geo.segs * geo.rows;

  __syncthreads();  // the previous operand's buffers are consumed
  stage(0, 0);
  for (int ch = 0; ch < chunks; ++ch) {
    if (ch + 1 < chunks) {
      stage(ch + 1, (ch + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* x = xs(ch & 1);
    const float* w = ws(ch & 1) + ty * 8;
#pragma unroll 1
    for (int ci = grp * CI_G; ci < (grp + 1) * CI_G; ++ci) {
      float xv[2][4 * T::NXV];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int v = 0; v < T::NXV; ++v) {
          const float4 q = *reinterpret_cast<const float4*>(x + ci * cstride + xoff[h] + 4 * v);
          xv[h][4 * v] = q.x, xv[h][4 * v + 1] = q.y, xv[h][4 * v + 2] = q.z, xv[h][4 * v + 3] = q.w;
        }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float4 w0 = *reinterpret_cast<const float4*>(w + (k * CI_T + ci) * BM);
        const float4 w1 = *reinterpret_cast<const float4*>(w + (k * CI_T + ci) * BM + 4);
        const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[h][j][i] = fmaf(wv[j], xv[h][T::OFF + i * S + k], acc[h][j][i]);
      }
    }
    __syncthreads();  // before the next chunk's copy reuses this buffer
  }
}

// grid: (ceil(N*Tout / BN), G*cog / BM); conv_ok(...) holds for a and b, a
// has KA taps at stride SA, b (KB > 0) KB taps at stride 1.
template <int KA, int SA, int KB>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) conv_kernel_fma(const ConvArgs<float, float, float> c,
                                                          const float* __restrict__ wpa,
                                                          const float* __restrict__ wpb) {
  extern __shared__ __align__(16) float smem_f[];
  const int p0 = blockIdx.x * BN;
  const int oc0 = blockIdx.y * BM;
  const int g = oc0 / c.cog, o0 = oc0 - g * c.cog;
  float acc[2][8][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[h][j][i] = 0.f;
  conv_accumulate_fma<KA, SA>(c.a, wpa, c.cog, g, o0, p0, c.N, c.Tout, smem_f, acc);
  if constexpr (KB > 0) conv_accumulate_fma<KB, 1>(c.b, wpb, c.cog, g, o0, p0, c.N, c.Tout, smem_f, acc);

  // the tile [BM][BN] in shared memory: group 1's sums, then group 0's plus
  // them (a fixed order), read back one output row per warp step, so that
  // conv_store's reads and writes run along positions
  const int tid = threadIdx.x, tx = tid & 7, ty = (tid >> 3) & 7, grp = tid >> 6;
  float* tile = smem_f;
  __syncthreads();  // the pipeline's buffers are consumed
  for (int q = GROUPS - 1; q >= 0; --q) {
    if (grp == q)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float4* t = reinterpret_cast<float4*>(tile + (8 * ty + j) * BN + 32 * h + 4 * tx);
          float4 u = make_float4(0.f, 0.f, 0.f, 0.f);
          if (q < GROUPS - 1) u = *t;
          *t = make_float4(acc[h][j][0] + u.x, acc[h][j][1] + u.y, acc[h][j][2] + u.z, acc[h][j][3] + u.w);
        }
    __syncthreads();
  }
  // both operands' sums are in the tile: the second term is 0
  const int P = c.N * c.Tout;
  for (int e = tid; e < BM * BN; e += THREADS) {
    const int o = e / BN, p = p0 + (e - o * BN);
    if (p < P) conv_store(c, g, o0 + o, p, tile[e], 0.f);
  }
}

inline cudaError_t pack(const Operand<float, float>& a, int cog, int G, float* out, cudaStream_t stream) {
  const long long n = (long long)G * cog * a.cig * a.K;
  pack_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(a, cog, n, out);
  ENC_CHECK(cudaGetLastError());
  return cudaSuccess;
}

template <int KA, int SA, int KB>
cudaError_t launch_conv_k(const ConvArgs<float, float, float>& c, int G, const float* wpa, const float* wpb,
                          cudaStream_t stream) {
  if (c.a.pad != Taps<KA, SA>::PAD) ENC_CHECK(cudaErrorInvalidValue);
  if (KB > 0 && (c.b.stride != 1 || c.b.pad != Taps<KB, 1>::PAD)) ENC_CHECK(cudaErrorInvalidValue);
  int bytes = conv_smem_bytes<KA, SA>(c.Tout);
  if (KB > 0) bytes = bytes > conv_smem_bytes<KB, 1>(c.Tout) ? bytes : conv_smem_bytes<KB, 1>(c.Tout);
  auto kern = &conv_kernel_fma<KA, SA, KB>;
  // every launch: a cache in a function-local static would be one object for
  // both libraries that include this header (the dynamic linker unifies it)
  ENC_CHECK(cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
  const dim3 grid((unsigned)(((long long)c.N * c.Tout + BN - 1) / BN), G * c.cog / BM);
  kern<<<grid, THREADS, bytes, stream>>>(c, wpa, wpb);
  ENC_CHECK(cudaGetLastError());
  return cudaSuccess;
}

// Packs the weights of a (and b) into wpa (wpb), each pack_elems(L) floats,
// and launches the engine for the chain's tap shapes: k7, k3 (with a k1
// second operand or none), k1 (the transposed conv's taps), and k2 s2 (its
// data gradient).
inline cudaError_t launch_conv_fma(const ConvArgs<float, float, float>& c, int G, float* wpa, float* wpb,
                                   cudaStream_t stream) {
  ENC_CHECK(pack(c.a, c.cog, G, wpa, stream));
  const int kb = c.b.x != nullptr ? c.b.K : 0;
  if (kb > 0) ENC_CHECK(pack(c.b, c.cog, G, wpb, stream));
  const int ka = c.a.K, sa = c.a.stride;
  if (sa == 1 && ka == 7 && kb == 0) return launch_conv_k<7, 1, 0>(c, G, wpa, wpb, stream);
  if (sa == 1 && ka == 3 && kb == 0) return launch_conv_k<3, 1, 0>(c, G, wpa, wpb, stream);
  if (sa == 1 && ka == 3 && kb == 1) return launch_conv_k<3, 1, 1>(c, G, wpa, wpb, stream);
  if (sa == 1 && ka == 1 && kb == 0) return launch_conv_k<1, 1, 0>(c, G, wpa, wpb, stream);
  if (sa == 2 && ka == 2 && kb == 0) return launch_conv_k<2, 2, 0>(c, G, wpa, wpb, stream);
  ENC_CHECK(cudaErrorInvalidValue);  // a tap shape the chain does not have
  return cudaErrorInvalidValue;
}

// ------------------------------------------------------ weight-gradient engine
struct DwArgs {
  const float* dy;
  int dyC, dyT, dy_ts, dy_to;
  const float* x;
  int xC, xT, x_gs, x_off;
  int cig, K;                // stride 1, padding (K - 1) / 2
  int N, Tout, cog;
  float* part;               // [range][G*cog][cig*K]
  int per;                   // positions per range, a multiple of DP
};

constexpr int SEG = 16;             // positions per staged segment (inside one sample)
constexpr int NSEG = 2;             // segments per staged chunk
constexpr int DP = SEG * NSEG;      // positions per chunk; ranges are whole chunks
constexpr int DW_THREADS = 64;      // 8 (output channels) x 8 (input channels)

// a row stride of 4k floats with k odd: the 8 channels a warp reads at one
// row fall on distinct banks
constexpr int odd4(int n) { return (n / 4) % 2 ? n : n + 4; }

// per-thread tile OT output x IT input channels (channels og + 8j, ig + 8j)
// for all K taps: K * OT * IT accumulators
template <int K>
struct DwTile {
  static constexpr int OT = K == 7 ? 4 : 8;
  static constexpr int IT = K == 1 ? 8 : 4;
  static constexpr int BO = 8 * OT, BI = 8 * IT;
  static constexpr int PAD = (K - 1) / 2, HALO = PAD > 0 ? 4 : 0, OFF = HALO - PAD;
  static constexpr int XR = SEG + 2 * HALO;          // staged X rows per segment
  static constexpr int XST = odd4(NSEG * XR);        // floats per input channel
  static constexpr int DST = odd4(DP);               // floats per output channel
  static constexpr int BUF = BI * XST + BO * DST;    // floats per buffer
  static constexpr int SUMS = BO * BI * K;
  static constexpr int SMEM = 4 * (2 * BUF > SUMS ? 2 * BUF : SUMS);
};

inline bool dw_ok(int cig, int cog, int K, int stride, int pad, int Tout) {
  const int bi = K == 1 ? 64 : 32, bo = K == 7 ? 32 : 64;
  return (K == 1 || K == 3 || K == 7) && stride == 1 && pad == (K - 1) / 2 && cig % bi == 0 && cog % bo == 0 &&
         Tout % SEG == 0;
}

// (o, i) tiles of a weight gradient: blocks per position range
inline int dw_tiles(int cig, int cog, int K, int G) {
  return (cig / (K == 1 ? 64 : 32)) * (G * cog / (K == 7 ? 32 : 64));
}

inline int dw_smem_bytes(int K) {
  return K == 7 ? DwTile<7>::SMEM : K == 3 ? DwTile<3>::SMEM : DwTile<1>::SMEM;
}

// grid: (cig/BI, G*cog/BO, ranges). A block takes a BO x BI tile of (o, i)
// for all K taps of one position range, in chunks of DP positions.
template <int K>
__global__ void __launch_bounds__(DW_THREADS) dw_kernel_fma(const DwArgs a) {
  using D = DwTile<K>;
  constexpr int OT = D::OT, IT = D::IT;
  extern __shared__ __align__(16) float smem_f[];
  const int tid = threadIdx.x, ig = tid & 7, og = tid >> 3;
  const int i0 = blockIdx.x * D::BI;
  const int oc0 = blockIdx.y * D::BO;
  const int g = oc0 / a.cog, o0 = oc0 - g * a.cog;
  const int P = a.N * a.Tout;
  const int lo = blockIdx.z * a.per, hi = min(P, lo + a.per);
  const bool dy_vec = a.dy_ts == 1 && a.dy_to == 0 && a.dyT % 4 == 0;
  const float* dyg = a.dy + (long long)(g * a.cog + o0) * a.dyT;
  const float* xg = a.x + (long long)(g * a.x_gs + a.x_off + i0) * a.xT;

  // buffer b: X [BI][XST] (segment s at rows s*XR), then dy [BO][DST]
  auto xbuf = [&](int b) { return smem_f + b * D::BUF; };
  auto dbuf = [&](int b) { return smem_f + b * D::BUF + D::BI * D::XST; };
  auto stage = [&](int q0, int b) {
    for (int s = 0; s < NSEG; ++s) {
      const int q = q0 + s * SEG;
      const bool seg_in = q < hi;  // segments lie wholly inside or outside [lo, hi)
      const int n = seg_in ? q / a.Tout : 0, t0 = seg_in ? q - n * a.Tout : 0;
      constexpr int X4 = D::XR / 4;
      for (int e = tid; e < D::BI * X4; e += DW_THREADS) {
        const int i = e / X4, r4 = e - i * X4;
        const int t = t0 - D::HALO + 4 * r4;
        const bool in = seg_in && t >= 0 && t < a.xT;
        cp_async16(smem_u32(xbuf(b) + i * D::XST + s * D::XR + 4 * r4),
                   xg + ((long long)n * a.xC + i) * a.xT + (in ? t : 0), in);
      }
      const float* d = dyg + (long long)n * a.dyC * a.dyT;
      if (dy_vec) {
        for (int e = tid; e < D::BO * (SEG / 4); e += DW_THREADS) {
          const int o = e / (SEG / 4), r4 = e - o * (SEG / 4);
          cp_async16(smem_u32(dbuf(b) + o * D::DST + s * SEG + 4 * r4), d + (long long)o * a.dyT + t0 + 4 * r4,
                     seg_in);
        }
      } else {  // the transposed conv's taps: every other step
        for (int e = tid; e < D::BO * SEG; e += DW_THREADS) {
          const int o = e / SEG, t = e - o * SEG;
          cp_async4(smem_u32(dbuf(b) + o * D::DST + s * SEG + t),
                    d + (long long)o * a.dyT + (t0 + t) * a.dy_ts + a.dy_to, seg_in);
        }
      }
    }
    cp_async_commit();
  };

  float acc[K][OT][IT];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int jo = 0; jo < OT; ++jo)
#pragma unroll
      for (int ji = 0; ji < IT; ++ji) acc[k][jo][ji] = 0.f;

  int b = 0;
  if (lo < hi) stage(lo, 0);
  for (int q0 = lo; q0 < hi; q0 += DP) {
    if (q0 + DP < hi) {
      stage(q0 + DP, b ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    for (int s = 0; s < NSEG; ++s) {
      if (q0 + s * SEG >= hi) break;  // uniform across the block
      const float* xr = xbuf(b) + ig * D::XST + s * D::XR + D::OFF;
      const float* dr = dbuf(b) + og * D::DST + s * SEG;
      // ring[(r) % K]: the X row r of this segment's walk (tap k of position
      // tl is row tl + k)
      float ring[K][IT];
#pragma unroll
      for (int r = 0; r < K - 1; ++r)
#pragma unroll
        for (int ji = 0; ji < IT; ++ji) ring[r][ji] = xr[8 * ji * D::XST + r];
#pragma unroll
      for (int tl = 0; tl < SEG; ++tl) {
#pragma unroll
        for (int ji = 0; ji < IT; ++ji) ring[(tl + K - 1) % K][ji] = xr[8 * ji * D::XST + tl + K - 1];
        float d[OT];
#pragma unroll
        for (int jo = 0; jo < OT; ++jo) d[jo] = dr[8 * jo * D::DST + tl];
#pragma unroll
        for (int k = 0; k < K; ++k)
#pragma unroll
          for (int jo = 0; jo < OT; ++jo)
#pragma unroll
            for (int ji = 0; ji < IT; ++ji) acc[k][jo][ji] = fmaf(d[jo], ring[(tl + k) % K][ji], acc[k][jo][ji]);
      }
    }
    __syncthreads();  // before the next chunk's copy reuses this buffer
    b ^= 1;
  }

  // the tile's rows (i, k) are one contiguous run of BI*K partials per
  // output channel: gather them in shared memory, then write whole rows
  constexpr int ROW = D::BI * K;
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int jo = 0; jo < OT; ++jo)
#pragma unroll
      for (int ji = 0; ji < IT; ++ji) smem_f[(og + 8 * jo) * ROW + (ig + 8 * ji) * K + k] = acc[k][jo][ji];
  __syncthreads();
  const int R = a.cig * K;
  float* part = a.part + (long long)blockIdx.z * gridDim.y * D::BO * R + (long long)oc0 * R + i0 * K;
  for (int e = tid; e < D::BO * ROW; e += DW_THREADS) {
    const int o = e / ROW, r = e - o * ROW;
    part[(long long)o * R + r] = smem_f[e];
  }
}

template <int K>
cudaError_t launch_dw_k(const DwArgs& a, int G, int ranges, cudaStream_t stream) {
  using D = DwTile<K>;
  auto kern = &dw_kernel_fma<K>;
  ENC_CHECK(cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, D::SMEM));
  kern<<<dim3(a.cig / D::BI, G * a.cog / D::BO, ranges), DW_THREADS, D::SMEM, stream>>>(a);
  ENC_CHECK(cudaGetLastError());
  return cudaSuccess;
}

inline cudaError_t launch_dw_fma(const DwArgs& a, int G, int ranges, cudaStream_t stream) {
  if (a.K == 7) return launch_dw_k<7>(a, G, ranges, stream);
  if (a.K == 3) return launch_dw_k<3>(a, G, ranges, stream);
  return launch_dw_k<1>(a, G, ranges, stream);
}

}  // namespace fma
}  // namespace enc
