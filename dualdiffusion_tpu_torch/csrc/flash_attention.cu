// K7 flash_attention: online-softmax attention over (B, H, L, D), forward only.
//
// Replaces dualdiffusion_tpu/ops/pallas/flash_attention.py _attn_kernel (via
// flash_attention), which the JAX package's scaled_dot_product_attention
// takes at L >= 2048: the UNet's "full" and "time" attention axes, and
// sliding_window_attention.
//
// o[b, h, i] = sum_j softmax_j(q[b, h, i] . k[b, h, j] * scale, masked) v[b, h, j]
// with the mask |i - j| <= window when a window is given, j <= i when causal,
// and j < L always. The softmax and the accumulation are fp32; o is written
// in q's dtype. A row whose keys are all masked emits 0, not NaN.
//
// What bounds it on the H100: at the path's shape (B = 2, H = 8, L = 5504,
// D = 64, bf16, dense) one call is 4 B H L^2 D = 124 GFLOP of products,
// 0.126 ms at 989 TFLOP/s bf16, and B H L^2 = 0.48 G exponentials, one per
// score, about 0.12 ms on the SFUs (16 per SM per clock at 1.98 GHz). The
// bytes, 4 x 11.3 MB, take ~0.013 ms. So the tensor cores and the softmax
// together bound it, not the memory.
//
// bf16 design (Hopper: wgmma, TMA, mbarriers, one producer warpgroup). One
// block of 3 warpgroups per (b*h, 128-row q tile):
// - warpgroup 0 is the producer: setmaxnreg lowers it to 24 registers and
//   one thread issues every load as a TMA copy of a 4-D tensor map (D, L,
//   H, B) built on the host from each view's strides. Q is loaded once; K
//   and V tiles of BK keys run through a two-stage ring of full and empty
//   mbarriers, so the next tile's copy is in flight while this one is
//   consumed. TMA zero-fills rows past L and columns past D, so a ragged L
//   and any D up to 256 need no host padding: the tile width Dp is D
//   rounded up to 32, 64, 128 or 256, zero columns change neither q . k nor
//   the kept outputs, and the epilogue writes only D columns.
// - warpgroups 1 and 2 are consumers (setmaxnreg raises them), 64 q rows
//   each. S = Q K^T is one wgmma m64n{BK}k16 per 16 columns of Dp, both
//   operands K-major in 128-byte swizzled shared memory (64-byte at Dp =
//   32), stored as 64-column atoms, one TMA box each. The online softmax
//   runs on S's fp32 accumulator registers in the log2 domain: row maxima
//   of the raw scores in independent chains, then the quad shuffles, and
//   p = 2^(s * scale * log2 e - max) as one FFMA and one ex2 per score; the
//   row sum is kept per thread and reduced once at the end, and a row whose
//   max is still -inf uses 0 as its offset (p = alpha = 0). P is rounded to
//   bf16 in pairs straight from the accumulators, whose m64nNk16 layout per
//   16 columns is the register A-fragment layout of O += P V: wgmma
//   m64n{Dp}k16 with A from registers and V as an MN-major B (the transpose
//   bit). P's bf16 rounding matches the JAX einsum route's rounding of its
//   probabilities (models/attention.py:113) and sets the tolerance against
//   the fp32 plain version (2e-2 of max |o|).
// - the consumers share the ring, so within a block they run in lockstep:
//   both wait for the same tile, then both use the tensor cores, then both
//   the SFUs. At Dp <= 64 two blocks of 64-key tiles share an SM (Tile), and
//   the blocks' consumers overlap one another's phases; explicit ping-pong
//   between the warpgroups is the next step. A block walks only the key
//   tiles its rows' band meets (O(L w) for bands); a consumer skips the
//   products of a tile its own 64 rows cannot see, and tiles wholly inside
//   the band take no mask.
// - the epilogue divides once (l == 0 gives 0), stages each consumer's rows
//   in its own part of the Q tile and stores 16-byte vectors with o's
//   strides. Any (b, h, l) strides are taken, with unit stride along D,
//   16-byte aligned rows and D a multiple of 8 (the wrapper copies other
//   views), so the UNet's transposed (B, L, H, D) views need no copies.
//
// fp32 inputs take a second kernel with fp32 FMA on the CUDA cores (no
// TF32, which would change the numbers): 4 threads per q row, each holding
// a quarter of the row's q and o, 32-key tiles in shared memory (16 at
// Dp = 256), loads and stores predicated on d < D.
//
// Heads wider than 256, bf16 or fp32, take a third kernel that walks D in
// chunks (flash_attention_wide.cu, its own source so that the builds run in
// parallel). Every kernel's grid is q tiles x B*H in gridDim.x, so B*H has
// no 65535 limit.

#include "common.cuh"
#include "flash_attention.cuh"
#include "hopper.cuh"

#include <math.h>

namespace {

using namespace dd;
using namespace dd_attn;

using bf16 = __nv_bfloat16;

constexpr int kMaxD = 256;  // the widest head of these kernels; wider ones: flash_attention_wide.cu

// ---------------------------------------------------------------------------
// bf16: wgmma, TMA and an mbarrier ring
// ---------------------------------------------------------------------------

constexpr int kBQ = 128;            // q rows per block, 64 per consumer warpgroup
constexpr int kThreads = 3 * 128;   // producer warpgroup + 2 consumer warpgroups
constexpr int kStages = 2;          // K/V ring depth

// tile geometry for a padded head width DP
template <int DP>
struct Tile {
  // keys per tile and blocks per SM: at Dp <= 64 two blocks of 64-key
  // tiles share an SM, so the two blocks' consumers drift apart and one's
  // softmax overlaps the other's products (faster than one block of 128-key
  // tiles at the path's shape: scripts/k7_ablation.py, one_block_bk128)
  static constexpr int BK = DP <= 64 ? 64 : DP <= 128 ? 128 : 64;
  static constexpr int BLOCKS = DP <= 64 ? 2 : 1;
  // registers per thread at launch (__launch_bounds__), and the consumers'
  // after setmaxnreg: registers move only within the block, so the two
  // consumer warpgroups take what the producer frees going down to 24
  // (240 at one block per SM, 104 at two)
  static constexpr int ENTRY = 65536 / (kThreads * BLOCKS) / 8 * 8;
  static constexpr int REGS = (ENTRY + (ENTRY - 24) / 2) / 8 * 8;
  static constexpr int SW = DP == 32 ? 64 : 128;    // swizzle span: bytes per atom row
  static constexpr int AC = SW / 2;                 // columns per atom (one TMA box)
  static constexpr int NA = DP / AC;                // atoms per row
  static constexpr int Q_BYTES = kBQ * DP * 2;
  static constexpr int KV_BYTES = BK * DP * 2;      // one K or V tile
  // Q, the K and V stages, 1 KB to align the tiles to the swizzle pattern,
  // and the barriers (q_full, full[kStages], empty[kStages])
  static constexpr int SMEM = Q_BYTES + 2 * kStages * KV_BYTES + 1024 + 8 * (1 + 2 * kStages);
};

// 2^x on the SFU; results below 2^-126 flush to 0 (probabilities that small vanish
// against the row's maximum of 1 anyway)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// one consumer warpgroup: 64 q rows from r0 over the block's n_tiles key tiles
template <int DP>
__device__ __forceinline__ void consume(const Params& p, unsigned char* smem, uint32_t sQ,
                                        uint32_t sK, uint32_t sV, uint32_t q_full, uint32_t full,
                                        uint32_t empty, int c, int r0, int t_lo, int n_tiles,
                                        int b, int h) {
  using T = Tile<DP>;
  constexpr int BK = T::BK, SW = T::SW;
  const int L = p.L;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = r0 + warp * 16 + g, row1 = row0 + 8;
  // the key range this warpgroup's rows see; its other tiles are waited
  // for and released, but not computed
  int w_lo = 0, w_hi = -1;
  if (r0 < L) key_range(p, r0, min(r0 + 63, L - 1), w_lo, w_hi);

  float o[DP / 2];
  float s[BK / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of rows g, g + 8 (raw scores)
  // scale * log2(e); the wrapper makes the scale >= 0, and 0 becomes a
  // scale too small to move any score (so -inf * scale stays -inf)
  const float scale = fmaxf(p.scale_log2, 1e-30f);
  float l[2] = {0.f, 0.f};              // this thread's part of the running sums
  const uint32_t qa = sQ + c * 64 * SW;  // this warpgroup's rows in Q's first atom

  mbar_wait(q_full, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % kStages;
    const int k0 = (t_lo + it) * BK;
    mbar_wait(full + 8 * st, (it / kStages) & 1);
    if (k0 <= w_hi && k0 + BK - 1 >= w_lo) {
      const uint32_t tK = sK + st * T::KV_BYTES, tV = sV + st * T::KV_BYTES;
      // S = Q K^T: 16 columns of Dp per wgmma; an atom holds AC columns
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const int a = kk / (T::AC / 16), off = (kk % (T::AC / 16)) * 32;
        wgmma_ss(s, make_desc<SW>(qa + a * kBQ * SW + off, 16, 8 * SW),
                 make_desc<SW>(tK + a * BK * SW + off, 16, 8 * SW), kk > 0);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(s);

      // online softmax in the log2 domain; s[4 n + e] is row (e < 2 ? g : g + 8),
      // column 8 n + 2 t + (e & 1)
      const bool need_mask = k0 + BK > L || (p.causal && k0 + BK - 1 > r0) ||
                             (p.window >= 0 && (k0 < r0 + 63 - p.window ||
                                                k0 + BK - 1 > r0 + p.window));
      if (need_mask) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i)
          if (!visible(p, (i & 2) ? row1 : row0, k0 + (i / 4) * 8 + 2 * t + (i & 1)))
            s[i] = -INFINITY;
      }
      // row maxima of the raw scores and sums, in four independent chains per
      // row; the scale (> 0) is applied inside the exponent, one FFMA each
      float mq[2][4], lq[2][4];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mq[r][j] = m[r];
          lq[r][j] = 0.f;
        }
#pragma unroll
      for (int i = 0; i < BK / 2; ++i)
        mq[(i >> 1) & 1][(i >> 2) & 3] = fmaxf(mq[(i >> 1) & 1][(i >> 2) & 3], s[i]);
      float m_use[2], alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = fmaxf(fmaxf(mq[r][0], mq[r][1]), fmaxf(mq[r][2], mq[r][3]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        m_use[r] = mx == -INFINITY ? 0.f : mx;  // all masked so far: p = alpha = 0
        alpha[r] = exp2_ftz((m[r] - m_use[r]) * scale);
        m[r] = mx;
        m_use[r] *= scale;
      }
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const float pv = exp2_ftz(fmaf(s[i], scale, -m_use[(i >> 1) & 1]));
        s[i] = pv;
        lq[(i >> 1) & 1][(i >> 2) & 3] += pv;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r)
        l[r] = l[r] * alpha[r] + ((lq[r][0] + lq[r][1]) + (lq[r][2] + lq[r][3]));
      // P rounded to bf16: the accumulators of columns 16 kk .. 16 kk + 15
      // are the A fragment of k-step kk
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

      // O += P V: V [keys, Dp] is B in MN-major order (the transpose bit)
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs(o, pa[kk], make_desc<SW>(tV + kk * 16 * SW, BK * SW, 8 * SW));
      wgmma_commit();
      wgmma_wait();
      fence_regs(o);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * st);  // this warp is done with stage st
  }

  // divide once; fully masked rows (l == 0) emit 0
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = l[r] == 0.f ? 0.f : 1.f / l[r];
  }
  // stage the rows in this warpgroup's own part of the Q tile (same atoms,
  // 16-byte chunks XOR-swizzled by row), then store 16-byte vectors
  constexpr int CH = SW / 16;  // 16-byte chunks per atom row
  auto staged = [&](int r, int col) {
    const int a = col / T::AC, ch = (col % T::AC) / 8;
    return smem + a * kBQ * SW + (c * 64 + r) * SW + ((ch ^ (r % CH)) * 16) + (col % 8) * 2;
  };
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    const int r = warp * 16 + g, col = n * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(staged(r, col)) =
        pack_bf16(o[4 * n + 0] * inv[0], o[4 * n + 1] * inv[0]);
    *reinterpret_cast<uint32_t*>(staged(r + 8, col)) =
        pack_bf16(o[4 * n + 2] * inv[1], o[4 * n + 3] * inv[1]);
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");  // this warpgroup only
  bf16* ob = static_cast<bf16*>(p.o) + b * p.so[0] + h * p.so[1];
  for (int i = tid; i < 64 * (DP / 8); i += 128) {
    const int r = i / (DP / 8), col = (i % (DP / 8)) * 8;
    const int row = r0 + r;
    if (row < L && col < p.D)
      *reinterpret_cast<uint4*>(ob + (int64_t)row * p.so[2] + col) =
          *reinterpret_cast<const uint4*>(staged(r, col));
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads, Tile<DP>::BLOCKS)
    flash_attn_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv, const Params p) {
  using T = Tile<DP>;
  extern __shared__ unsigned char smem_raw[];
  // tiles aligned to 1 KB, the period of the 128-byte swizzle
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sQ = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (sQ - raw);
  const uint32_t sK = sQ + T::Q_BYTES;           // stage st at sK + st * KV_BYTES
  const uint32_t sV = sK + kStages * T::KV_BYTES;
  const uint32_t q_full = sV + kStages * T::KV_BYTES;
  const uint32_t full = q_full + 8, empty = full + 8 * kStages;

  // gridDim.x = q tiles x B*H, q tiles fastest: no 65535 limit on B*H
  const int nq = (p.L + kBQ - 1) / kBQ;
  const int q0 = (blockIdx.x % nq) * kBQ;
  const int b = blockIdx.x / nq / p.H, h = blockIdx.x / nq % p.H;
  int k_lo, k_hi;
  key_range(p, q0, min(q0 + kBQ, p.L) - 1, k_lo, k_hi);
  const int t_lo = k_lo / T::BK, n_tiles = k_hi / T::BK - t_lo + 1;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full + 8 * st, 1);        // the producer's expect_tx
      mbar_init(empty + 8 * st, 8);       // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer: one thread issues every TMA copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, T::Q_BYTES);
#pragma unroll
      for (int a = 0; a < T::NA; ++a)
        tma_load(sQ + a * kBQ * T::SW, &tq, q_full, a * T::AC, q0, h, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % kStages;
        const int k0 = (t_lo + it) * T::BK;
        mbar_wait(empty + 8 * st, ((it / kStages) & 1) ^ 1);  // passes at once on the first lap
        mbar_expect_tx(full + 8 * st, 2 * T::KV_BYTES);
#pragma unroll
        for (int a = 0; a < T::NA; ++a) {
          const uint32_t off = st * T::KV_BYTES + a * T::BK * T::SW;
          tma_load(sK + off, &tk, full + 8 * st, a * T::AC, k0, h, b);
          tma_load(sV + off, &tv, full + 8 * st, a * T::AC, k0, h, b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(T::REGS) : "memory");
    const int c = threadIdx.x / 128 - 1;
    consume<DP>(p, smem, sQ, sK, sV, q_full, full, empty, c, q0 + 64 * c, t_lo, n_tiles, b, h);
  }
}

// a 4-D (D, L, H, B) tensor map of one bf16 operand; boxes of `cols` x `rows`
bool encode_map(CUtensorMap* map, const void* ptr, const int64_t* st, int B, int H, int L, int D,
                int cols, int rows, int swizzle) {
  const uint64_t dims[4] = {(uint64_t)D, (uint64_t)L, (uint64_t)H, (uint64_t)B};
  const uint64_t strides[3] = {(uint64_t)st[2] * 2, (uint64_t)st[1] * 2, (uint64_t)st[0] * 2};
  const uint32_t box[4] = {(uint32_t)cols, (uint32_t)rows, 1, 1};
  return encode_bf16_map(map, ptr, 4, dims, strides, box, swizzle);
}

template <int DP>
int launch_bf16(const Params& p, int B, cudaStream_t stream) {
  using T = Tile<DP>;
  CUtensorMap tq, tk, tv;
  if (!encode_map(&tq, p.q, p.sq, B, p.H, p.L, p.D, T::AC, kBQ, T::SW) ||
      !encode_map(&tk, p.k, p.sk, B, p.H, p.L, p.D, T::AC, T::BK, T::SW) ||
      !encode_map(&tv, p.v, p.sv, B, p.H, p.L, p.D, T::AC, T::BK, T::SW))
    return (int)cudaErrorInvalidValue;
  auto kernel = flash_attn_bf16_kernel<DP>;
  cudaError_t err = dd_allow_smem(kernel, T::SMEM);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(p.L + kBQ - 1) / kBQ * B * p.H, kThreads, T::SMEM, stream>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32: FMA on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kF32Rows = 64;                  // q rows per block
constexpr int kF32Threads = 4 * kF32Rows;     // 4 threads per row

template <int DP>
__global__ void __launch_bounds__(kF32Threads) flash_attn_f32_kernel(const Params p) {
  constexpr int KEYS = DP <= 128 ? 32 : 16;  // keys per tile
  constexpr int NP = DP / 4;                 // dims per thread: c, c + 4, c + 8, ...
  __shared__ float sK[KEYS][DP];
  __shared__ float sV[KEYS][DP];

  const int L = p.L, D = p.D;
  const int nq = (p.L + kF32Rows - 1) / kF32Rows;
  const int q0 = (blockIdx.x % nq) * kF32Rows;
  const int b = blockIdx.x / nq / p.H, h = blockIdx.x / nq % p.H;
  const float* qb = static_cast<const float*>(p.q) + b * p.sq[0] + h * p.sq[1];
  const float* kb = static_cast<const float*>(p.k) + b * p.sk[0] + h * p.sk[1];
  const float* vb = static_cast<const float*>(p.v) + b * p.sv[0] + h * p.sv[1];
  float* ob = static_cast<float*>(p.o) + b * p.so[0] + h * p.so[1];

  const int c = threadIdx.x & 3;
  const int row = q0 + (threadIdx.x >> 2);
  const int q_hi = min(q0 + kF32Rows, L) - 1;
  int k_lo, k_hi;
  key_range(p, q0, q_hi, k_lo, k_hi);

  float qr[NP], o[NP];
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    qr[i] = row < L && c + 4 * i < D ? qb[(int64_t)row * p.sq[2] + c + 4 * i] : 0.f;
    o[i] = 0.f;
  }
  float m = -INFINITY, l = 0.f;
  const float scale_log2 = p.scale_log2;

  for (int k0 = k_lo / KEYS * KEYS; k0 <= k_hi; k0 += KEYS) {
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < KEYS * DP; i += kF32Threads) {
      const int r = i / DP, d = i % DP;
      const bool in = k0 + r < L && d < D;
      sK[r][d] = in ? kb[(int64_t)(k0 + r) * p.sk[2] + d] : 0.f;
      sV[r][d] = in ? vb[(int64_t)(k0 + r) * p.sv[2] + d] : 0.f;
    }
    __syncthreads();
    float s[KEYS];
    float mx = m;
#pragma unroll
    for (int jj = 0; jj < KEYS; ++jj) {
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < NP; ++i) acc = fmaf(qr[i], sK[jj][c + 4 * i], acc);
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      const float x = visible(p, row, k0 + jj) ? acc * scale_log2 : -INFINITY;
      s[jj] = x;
      mx = fmaxf(mx, x);
    }
    const float m_use = mx == -INFINITY ? 0.f : mx;
    const float alpha = exp2f(m - m_use);
    m = mx;
    l *= alpha;
#pragma unroll
    for (int i = 0; i < NP; ++i) o[i] *= alpha;
#pragma unroll
    for (int jj = 0; jj < KEYS; ++jj) {
      const float pj = exp2f(s[jj] - m_use);
      l += pj;
#pragma unroll
      for (int i = 0; i < NP; ++i) o[i] = fmaf(pj, sV[jj][c + 4 * i], o[i]);
    }
  }
  const float inv = l == 0.f ? 0.f : 1.f / l;
  if (row < L) {
#pragma unroll
    for (int i = 0; i < NP; ++i)
      if (c + 4 * i < D) ob[(int64_t)row * p.so[2] + c + 4 * i] = o[i] * inv;
  }
}

template <int DP>
int launch_f32(const Params& p, int B, cudaStream_t stream) {
  flash_attn_f32_kernel<DP><<<(p.L + kF32Rows - 1) / kF32Rows * B * p.H, kF32Threads, 0,
                              stream>>>(p);
  return (int)cudaGetLastError();
}

template <int DP>
int launch(const Params& p, int B, int is_bf16, cudaStream_t stream) {
  return is_bf16 ? launch_bf16<DP>(p, B, stream) : launch_f32<DP>(p, B, stream);
}

}  // namespace

// strides: 12 element strides, (b, h, l) of q, k, v and o in that order. bf16
// needs 16-byte aligned pointers, strides that are multiples of 8 elements
// and D a multiple of 8 (TMA's and the 16-byte stores' rules). D <= 256.
extern "C" int dd_flash_attention(const void* q, const void* k, const void* v, void* o,
                                  const long long* strides, int B, int H, int L, int D,
                                  float scale, int window, int causal, int is_bf16, void* stream) {
  Params p;
  const int err = make_params(p, q, k, v, o, strides, B, H, L, D, scale, window, causal, is_bf16);
  if (err != 0) return err;
  if (D > kMaxD) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (D <= 32) return launch<32>(p, B, is_bf16, s);
  if (D <= 64) return launch<64>(p, B, is_bf16, s);
  if (D <= 128) return launch<128>(p, B, is_bf16, s);
  return launch<256>(p, B, is_bf16, s);
}
