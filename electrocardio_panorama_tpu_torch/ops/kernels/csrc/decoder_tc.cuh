// The bfloat16 stage kernel of the eval decoder (see decoder_common.cuh): each
// convolution stage as tensor-core matrix products, wgmma m64nNk16 with both
// operands in shared memory and float32 accumulators in registers.
//
// Time is M and the output channels are N: D[t, n] += X[t + k - 1, ci] *
// W_k[n, ci] for the taps k. Activations lie in channel chunks of 8,
// [C / 8][time][8] bfloat16, in shared memory and in the scratch planes: one
// time step's 8 channels are one 16-byte row, 8 rows are one unswizzled
// 8 x 16-byte core matrix, and a tap's shift by one time step is 16 bytes on
// the descriptor's start address. Weights are K-major, [tap][Cin / 8][N][8].
//
// One persistent block per SM keeps its stage's weights in shared memory.
// Its warpgroups are independent workers: each walks over views of its own,
// 64 time steps at a time, with its own double buffer, and meets the others
// at no barrier, so one warpgroup's loads and epilogue run under another's
// products. Per tile a warpgroup issues the tile's wgmmas, forms its next
// tile in the other buffer while they run (the basis mix, the upsample of
// the gate products, or a copy with cp.async), then waits and runs the
// epilogue from registers: a thread's accumulator pair is two adjacent
// channels of one step, so a quad stores one 16-byte row and a warp 8
// adjacent rows.

#pragma once

#include "decoder_common.cuh"

namespace dec {
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int TM = 64;        // time steps per tile: one warpgroup's wgmma rows
constexpr int ROWS = TM + 2;  // with one halo step on each side
constexpr int WG = 128;       // threads of a warpgroup
constexpr int SP_W = T2 + 4;  // conv5 partial sums of one view, zero padded

// shared-memory matrix descriptor, no swizzle: lbo is the byte distance of
// the two core matrices along K, sbo that of 8-row groups along M or N
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

#define DEC_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define DEC_D16(i) DEC_D4(i), DEC_D4(i + 4), DEC_D4(i + 8), DEC_D4(i + 12)

__device__ __forceinline__ void wgmma(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : DEC_D16(0), DEC_D16(16)
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : DEC_D16(0), DEC_D16(16), DEC_D16(32), DEC_D16(48)
      : "l"(da), "l"(db), "r"(scale_d));
}

#undef DEC_D4
#undef DEC_D16

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }
// makes this thread's shared-memory writes visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  f[0] = __uint_as_float(u.x << 16), f[1] = __uint_as_float(u.x & 0xffff0000u);
  f[2] = __uint_as_float(u.y << 16), f[3] = __uint_as_float(u.y & 0xffff0000u);
  f[4] = __uint_as_float(u.z << 16), f[5] = __uint_as_float(u.z & 0xffff0000u);
  f[6] = __uint_as_float(u.w << 16), f[7] = __uint_as_float(u.w & 0xffff0000u);
}
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]), pack2(f[6], f[7]));
}
__device__ __forceinline__ float round_bf16(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

template <int CIN, int NOUT, int TAPS, int OUT, int NWG>
struct Smem {
  static constexpr int W = TAPS * CIN * NOUT * 2;        // weights
  static constexpr int A = (CIN / 8) * ROWS * 16;        // one input tile
  static constexpr int OFF_A = W;                        // [NWG][2] tiles
  static constexpr int OFF_BIAS = OFF_A + NWG * 2 * A;   // NOUT floats
  static constexpr int OFF_BIN = OFF_BIAS + NOUT * 4;    // 128 floats, the loader's b1
  static constexpr int OFF_CORR = OFF_BIN + 128 * 4;     // [NWG][128] floats, OUT_POLY
  static constexpr int OFF_W5 = OFF_CORR + NWG * 128 * 4;  // 3 * 64 floats, OUT_CONV5
  static constexpr int OFF_SP = OFF_W5 + 192 * 4;        // [NWG][2][3][SP_W] floats, OUT_CONV5
  static constexpr int BYTES = OFF_SP + (OUT == OUT_CONV5 ? NWG * 2 * 3 * SP_W * 4 : 0);
};

// barrier of one warpgroup (barrier 0 is __syncthreads')
__device__ __forceinline__ void wg_sync(int wg) { asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory"); }

// relu(v + bias[8 channels of chunk c]) rounded and packed
__device__ __forceinline__ uint4 finish8(float (&v)[8], const float* bias8) {
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = fmaxf(v[i] + bias8[i], 0.f);
  return pack8(v);
}

// y1 of one (view, chunk, step) from the basis planes: U [B][16][J][256] rows
__device__ __forceinline__ void mix_acc(float (&acc)[8], float e, const uint4& u) {
  float f[8];
  unpack8(u, f);
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = fmaf(e, f[i], acc[i]);
}

// y1 of one (view, chunk, step) from the gate stage's products g [3][16][128] rows
__device__ __forceinline__ uint4 g3_item(const uint4* g, int c, int t, const float* sbin) {
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int p = t + k - 1;
    if (p < 0 || p >= T1) continue;
    int s, s2;
    up2_taps(p, s, s2);
    float a[8], b[8];
    unpack8(__ldg(g + (k * (C1 / 8) + c) * T0 + s), a);
    unpack8(__ldg(g + (k * (C1 / 8) + c) * T0 + s2), b);
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] += fmaf(0.25f, b[i], 0.75f * a[i]);
  }
  return finish8(acc, sbin + c * 8);
}

// The y1 tile of view n from the basis planes U [B][16][J][256] rows.
__device__ __forceinline__ void produce_mix(uint4* A, const StageArgs& a, const float* sbin, int tw, int n,
                                            int t0) {
  constexpr int NCH = C1 / 8, T = T1;
  const int J = a.J;
  const uint4* U = static_cast<const uint4*>(a.in) + (size_t)(n / a.views) * NCH * J * T;
  const float* ep = a.ep + (size_t)n * J;
  const int r = tw & (TM - 1), cb = tw >> 6;
  // two chunks at a time; the loads of four basis planes are in flight
  // before their FMAs, so the loop waits on L2 once per four planes
#pragma unroll 1
  for (int q = 0; q < NCH / 2; q += 2) {
    const int c0 = cb + 2 * q, c1 = c0 + 2;
    const uint4* u0 = U + (size_t)c0 * J * T + t0 + r;
    const uint4* u1 = U + (size_t)c1 * J * T + t0 + r;
    float acc0[8], acc1[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc0[i] = acc1[i] = 0.f;
    int j = 0;
#pragma unroll 1
    for (; j + 4 <= J; j += 4) {
      uint4 v0[4], v1[4];
      float e[4];
#pragma unroll
      for (int x = 0; x < 4; ++x)
        v0[x] = __ldg(u0 + (j + x) * T), v1[x] = __ldg(u1 + (j + x) * T), e[x] = __ldg(ep + j + x);
#pragma unroll
      for (int x = 0; x < 4; ++x) mix_acc(acc0, e[x], v0[x]), mix_acc(acc1, e[x], v1[x]);
    }
    for (; j < J; ++j) {
      const float e = __ldg(ep + j);
      mix_acc(acc0, e, __ldg(u0 + j * T)), mix_acc(acc1, e, __ldg(u1 + j * T));
    }
    A[c0 * ROWS + 1 + r] = finish8(acc0, sbin + c0 * 8);
    A[c1 * ROWS + 1 + r] = finish8(acc1, sbin + c1 * 8);
  }
  if (tw < 2 * NCH) {  // the two halo rows
    const int hc = tw & (NCH - 1), hside = tw / NCH;
    const int ht = hside ? t0 + TM : t0 - 1, hr = hside ? TM + 1 : 0;
    uint4 out = make_uint4(0, 0, 0, 0);
    if (ht >= 0 && ht < T) {
      float acc[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] = 0.f;
      for (int jj = 0; jj < J; ++jj) mix_acc(acc, __ldg(ep + jj), __ldg(U + ((size_t)hc * J + jj) * T + ht));
      out = finish8(acc, sbin + hc * 8);
    }
    A[hc * ROWS + hr] = out;
  }
}

// A warpgroup forms the input tile of view n, steps t0 - 1 .. t0 + TM, in A:
// row r holds step t0 - 1 + r, zero outside [0, T). tw is the thread's index
// in the warpgroup. IN_PLANE copies with cp.async (the caller waits); the
// other modes compute and store.
template <int CIN, int T, int IN>
__device__ __forceinline__ void produce(uint4* A, const StageArgs& a, const float* sbin, int tw, int n, int t0) {
  constexpr int NCH = CIN / 8;
  const int r = tw & (TM - 1), cb = tw >> 6;  // step of the tile; first chunk (0 | 1)
  const bool halo = tw < 2 * NCH;             // these threads also fill the two halo rows
  const int hc = tw & (NCH - 1), hside = tw / NCH;
  const int ht = hside ? t0 + TM : t0 - 1, hr = hside ? TM + 1 : 0;
  const bool hvalid = ht >= 0 && ht < T;

  if (IN == IN_PLANE) {
    const uint4* src = static_cast<const uint4*>(a.in) + (size_t)n * NCH * T;
#pragma unroll
    for (int q = 0; q < NCH / 2; ++q) {
      const int c = cb + 2 * q;
      cp_async16(smem_u32(A + c * ROWS + 1 + r), src + c * T + t0 + r);
    }
    if (halo) cp_async16(smem_u32(A + hc * ROWS + hr), src + hc * T + (hvalid ? ht : 0), hvalid);
    cp_async_commit();
  } else if (IN == IN_MIX) {
    produce_mix(A, a, sbin, tw, n, t0);
  } else if (IN == IN_G3) {
    const uint4* g = static_cast<const uint4*>(a.in) + (size_t)n * 3 * NCH * T0;
#pragma unroll 4
    for (int q = 0; q < NCH / 2; ++q) {
      const int c = cb + 2 * q;
      A[c * ROWS + 1 + r] = g3_item(g, c, t0 + r, sbin);
    }
    if (halo) A[hc * ROWS + hr] = hvalid ? g3_item(g, hc, ht, sbin) : make_uint4(0, 0, 0, 0);
  } else if (IN == IN_Y1) {
    const bf16* y = static_cast<const bf16*>(a.in) + (size_t)n * CIN * T;
#pragma unroll 4
    for (int q = 0; q < NCH / 2; ++q) {
      const int c = cb + 2 * q;
      float f[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) f[i] = __bfloat162float(y[(size_t)(c * 8 + i) * T + t0 + r]);
      A[c * ROWS + 1 + r] = pack8(f);
    }
    if (halo) {
      float f[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) f[i] = hvalid ? __bfloat162float(y[(size_t)(hc * 8 + i) * T + ht]) : 0.f;
      A[hc * ROWS + hr] = pack8(f);
    }
  } else {  // IN_GATE: a one-tap stage reads no halo row
    const uint4* lat = static_cast<const uint4*>(a.in) + (size_t)(n / a.views) * NCH * T;
    const float4* gate = reinterpret_cast<const float4*>(a.ep + (size_t)n * CIN);
#pragma unroll 4
    for (int q = 0; q < NCH / 2; ++q) {
      const int c = cb + 2 * q;
      float f[8];
      unpack8(__ldg(lat + c * T + t0 + r), f);
      const float4 g0 = __ldg(gate + 2 * c), g1 = __ldg(gate + 2 * c + 1);
      f[0] *= g0.x, f[1] *= g0.y, f[2] *= g0.z, f[3] *= g0.w;
      f[4] *= g1.x, f[5] *= g1.y, f[6] *= g1.z, f[7] *= g1.w;
      A[c * ROWS + 1 + r] = pack8(f);
    }
  }
}

// One stage over all views. grid.x: persistent blocks of NWG warpgroups;
// grid.y: slices of the output channels that have their own weights and
// output plane (the gate stage's three taps), else 1.
template <int CIN, int NOUT, int T, int TAPS, int IN, int OUT, bool RELU, int NWG>
__global__ void __launch_bounds__(WG * NWG, 1) stage_kernel(const StageArgs a) {
  using L = Smem<CIN, NOUT, TAPS, OUT, NWG>;
  constexpr int NCH = CIN / 8, NACC = NOUT / 2, TILES = T / TM, THREADS = WG * NWG;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sbias = reinterpret_cast<float*>(smem + L::OFF_BIAS);
  float* sbin = reinterpret_cast<float*>(smem + L::OFF_BIN);
  float* sw5 = reinterpret_cast<float*>(smem + L::OFF_W5);

  const int tid = threadIdx.x, lane = tid & 31, wg = tid >> 7, tw = tid & (WG - 1);
  const int quad = lane & 3, row0 = (tw >> 5) * 16 + (lane >> 2);  // row of the warpgroup's 64
  uint4* A[2] = {reinterpret_cast<uint4*>(smem + L::OFF_A + (2 * wg) * L::A),
                 reinterpret_cast<uint4*>(smem + L::OFF_A + (2 * wg + 1) * L::A)};
  float* scorr = reinterpret_cast<float*>(smem + L::OFF_CORR) + wg * 128;
  float* sp = reinterpret_cast<float*>(smem + L::OFF_SP) + wg * 2 * 3 * SP_W;

  // the stage's weights, resident for the block's life
  {
    const uint4* w = static_cast<const uint4*>(a.w) + (size_t)blockIdx.y * (L::W / 16);
    for (int e = tid; e < L::W / 16; e += THREADS) cp_async16(smem_u32(smem) + e * 16, w + e);
    cp_async_commit();
    for (int e = tid; e < NOUT; e += THREADS) sbias[e] = RELU ? a.bias[e] : 0.f;
    if (IN == IN_MIX || IN == IN_G3)
      for (int e = tid; e < C1; e += THREADS) sbin[e] = a.b_in[e];
    if (OUT == OUT_CONV5) {
      const bf16* w5 = static_cast<const bf16*>(a.w5);
      for (int e = tid; e < 3 * C2; e += THREADS) sw5[e] = __bfloat162float(w5[e]);
      for (int e = tw; e < 2 * 3 * SP_W; e += WG) sp[e] = 0.f;
    }
  }
  cp_async_wait_all();
  fence_async_smem();
  __syncthreads();  // the last barrier of the whole block

  // this warpgroup's views: worker, worker + workers, ...
  const int worker = blockIdx.x * NWG + wg, workers = gridDim.x * NWG;
  const int total = worker < a.N ? (a.N - worker + workers - 1) / workers * TILES : 0;
  if (total > 0) produce<CIN, T, IN>(A[0], a, sbin, tw, worker, 0);
  cp_async_wait_all();
  fence_async_smem();
  wg_sync(wg);

  const uint32_t w_base = smem_u32(smem);
  int n = worker, tile = 0, parity = 0;
  for (int it = 0; it < total; ++it) {
    const int t0 = tile * TM;
    const uint4* Acur = A[it & 1];
    float d[NACC];
#pragma unroll
    for (int i = 0; i < NACC; ++i) d[i] = 0.f;

    // the tile's products: per tap and 16 input channels one wgmma
    {
      const uint32_t a_base = smem_u32(Acur) + (TAPS == 1 ? 16 : 0);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < TAPS; ++k)
#pragma unroll
        for (int kk = 0; kk < CIN / 16; ++kk) {
          const uint64_t da = make_desc(a_base + (2 * kk * ROWS + k) * 16, ROWS * 16, 128);
          const uint64_t db = make_desc(w_base + ((k * NCH + 2 * kk) * NOUT) * 16, NOUT * 16, 128);
          wgmma(d, da, db, (k | kk) != 0);
        }
      wgmma_commit();
    }

    // the next tile, while the tensor cores run
    int n_next = n, tile_next = tile + 1;
    if (tile_next == TILES) tile_next = 0, n_next = n + workers;
    if (it + 1 < total) produce<CIN, T, IN>(A[(it + 1) & 1], a, sbin, tw, n_next, tile_next * TM);

    if (OUT == OUT_POLY && (tile == 0 || tile == TILES - 1)) {
      // the clamp's correction on the view's first two or last two output
      // steps: corr[n] = sum_ci C[side][n][ci] * h[ci] at the edge step
      const uint4* ce = static_cast<const uint4*>(a.cedge) + ((tile == 0 ? 0 : NOUT) + tw) * NCH;
      const uint4* h = Acur + (tile == 0 ? 1 : TM);
      uint4 cw[NCH];
#pragma unroll
      for (int c = 0; c < NCH; ++c) cw[c] = __ldg(ce + c);
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        float wv[8], hv[8];
        unpack8(cw[c], wv);
        unpack8(h[c * ROWS], hv);
#pragma unroll
        for (int i = 0; i < 8; ++i) s = fmaf(wv[i], hv[i], s);
      }
      scorr[tw] = s;
      wg_sync(wg);
    }

    wgmma_wait();

    // epilogue: d[4i + 2h + j] is row row0 + 8h, output channel 8i + 2 quad + j
    if (OUT == OUT_PLANE || OUT == OUT_POLY) {
      uint32_t* out = static_cast<uint32_t*>(a.out) +
                      ((size_t)n * gridDim.y + blockIdx.y) * (OUT == OUT_POLY ? C2 * T2 : NOUT * T) / 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = t0 + row0 + 8 * h;
        const bool edge = OUT == OUT_POLY && (t == 0 || t == T - 1);
#pragma unroll
        for (int i = 0; i < NOUT / 8; ++i) {
          const int c = 8 * i + 2 * quad;
          float v0 = d[4 * i + 2 * h], v1 = d[4 * i + 2 * h + 1];
          if (edge) v0 += scorr[c], v1 += scorr[c + 1];
          v0 += sbias[c], v1 += sbias[c + 1];
          if (RELU) v0 = fmaxf(v0, 0.f), v1 = fmaxf(v1, 0.f);
          // OUT_POLY: packed channel 8i.. is chunk i / 2, phase i % 2 -> output step 2t + phase
          const size_t at = OUT == OUT_POLY ? ((size_t)(i >> 1) * T2 + 2 * t + (i & 1)) : ((size_t)i * T + t);
          out[at * 4 + quad] = pack2(v0, v1);
        }
      }
    } else {
      // conv5's three tap sums over this step's 64 channels, per quad
      float* spv = sp + parity * 3 * SP_W;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float p[3] = {0.f, 0.f, 0.f};
#pragma unroll
        for (int i = 0; i < NOUT / 8; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int c = 8 * i + 2 * quad + j;
            const float v = round_bf16(fmaxf(d[4 * i + 2 * h + j] + sbias[c], 0.f));
#pragma unroll
            for (int k = 0; k < 3; ++k) p[k] = fmaf(sw5[k * C2 + c], v, p[k]);
          }
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          p[k] += __shfl_xor_sync(0xffffffffu, p[k], 1);
          p[k] += __shfl_xor_sync(0xffffffffu, p[k], 2);
        }
        if (quad == 0) {
          const int t = t0 + row0 + 8 * h;
#pragma unroll
          for (int k = 0; k < 3; ++k) spv[k * SP_W + 1 + t] = p[k];
        }
      }
    }

    cp_async_wait_all();
    fence_async_smem();
    wg_sync(wg);

    if (OUT == OUT_CONV5 && tile == TILES - 1) {
      // out[t] = p0[t - 1] + p1[t] + p2[t + 1]; the other half of sp takes the next view
      const float* spv = sp + parity * 3 * SP_W;
      float* out = static_cast<float*>(a.out) + (size_t)n * T;
      const float b5 = a.b5[0];
      for (int t = tw; t < T; t += WG)
        out[t] = sigmoid_third(spv[t] + spv[SP_W + 1 + t] + spv[2 * SP_W + 2 + t] + b5);
      parity ^= 1;
    }
    n = n_next, tile = tile_next;
  }
}

// three warpgroups where they fit beside the weights in 227 KB, else two
// (a fourth gained nothing where it fits, in conv4)
template <int CIN, int NOUT, int TAPS, int OUT>
struct Layout {
  static constexpr int NWG = Smem<CIN, NOUT, TAPS, OUT, 3>::BYTES <= 232448 ? 3 : 2;
  using L = Smem<CIN, NOUT, TAPS, OUT, NWG>;
};

template <int CIN, int NOUT, int T, int TAPS, int IN, int OUT, bool RELU>
cudaError_t launch_stage(const StageArgs& a, int slices, cudaStream_t stream) {
  constexpr int NWG = Layout<CIN, NOUT, TAPS, OUT>::NWG;
  using L = typename Layout<CIN, NOUT, TAPS, OUT>::L;
  auto kernel = stage_kernel<CIN, NOUT, T, TAPS, IN, OUT, RELU, NWG>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (err != cudaSuccess) return err;
  const int blocks = min((a.N + NWG - 1) / NWG, max(sm_count() / slices, 1));
  kernel<<<dim3(blocks, slices), dim3(WG * NWG), L::BYTES, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace tc
}  // namespace dec
