// K4 on Hopper: the weight gradient of K1 (3x3, stride-1, zero-padded
// grouped conv), NHWC bf16 activations and output gradient, fp32
// accumulation, result in K1's weight layout and the activations' dtype, on
// wgmma fed by TMA through an mbarrier ring.
//
// Replaces the wgrad half of dualdiffusion_tpu/ops/pallas/grouped_conv.py
// _vjp_bwd (its exact 9-tap reduction _wgrad). Shapes whose channel counts
// are not multiples of 8, or tensors that are not 16-byte aligned, take the
// WMMA kernel of grouped_conv3x3_wgrad.cu; the wrapper makes that choice
// (hopper_takes).
//
// dW[g, (dy*3 + dx)*cig + i, o] = sum_{b, h, w} x[b, h+dy-1, w+dx-1, g*cig + i]
//                                              * gy[b, h, w, g*cog + o]
// i.e. per group and tap, dW (cig x cog) = im2col(x)^T . gy reduced over
// M = B*H*W pixels (176,128 at batch 8 on the reference UNet's level 0).
//
// What bounds it on the H100: the operations (2.9 ms at the tensor cores'
// peak per UNet backward at batch 8); the output is small and M huge, so
// the sum over M is split across blocks.
//
// Design: a block of 4 warpgroups owns one group, 64 input channels (wgmma
// M), BN output channels (wgmma N: 64, or 32 when cog is not a multiple of
// 64) and one contiguous run of image rows (b, h), its share of M.
// - warpgroup 0 is the producer (setmaxnreg 24): one thread issues TMA
//   loads into a 4-slot ring with full and empty mbarriers. A slot holds one
//   64-pixel run of one row: the 64 x BN tile of gy and the 3 x 66 pixel
//   halo of x for the block's 64 channels, as two boxes of 32 channels
//   (64-byte rows, 64-byte swizzle) from a 5-D tensor map (cig, G, W, H, B):
//   a box never leaves its group, and TMA's zero fill of the coordinates
//   w = -1, W and h = -1, H is the conv's zero padding.
// - warpgroups 1..3 are consumers, one kernel row dy each, so each holds
//   three taps' accumulators (3 x BN/2 fp32 registers, 96 at BN 64, beside
//   12 of A fragments; setmaxnreg gives them 160, 0 spills; nine taps in one
//   warpgroup would need 288 for the accumulators alone). A = the halo
//   transposed (M = channels, K = pixels), shifted by the tap's dx pixels
//   along K. A shift of one 64-byte row is not a multiple of the 8-row core
//   matrices a wgmma shared-memory descriptor addresses, so A comes from
//   registers: ldmatrix.trans with one row address per lane (any shift),
//   conflict-free on the swizzled halo. B = gy (K = pixels, N = cog,
//   MN-major: the transpose bit). The halo is loaded once per run and read
//   by all nine taps.
// - the blocks of one tile write fp32 partial tiles; a second pass sums
//   them in a fixed order and rounds once to bf16, so the result is
//   deterministic (no atomics).

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace dd;
using bf16 = __nv_bfloat16;

constexpr int kRun = 64;                     // pixels per stage (wgmma K: 4 x 16)
constexpr int kCols = kRun + 2;              // halo columns
constexpr int kCK = 32;                      // channels per halo box: 64-byte rows
constexpr int kMC = 2 * kCK;                 // input channels per block (wgmma M)
constexpr int kHalo = kCK * kCols * 3 * 2;   // one box: 3 rows x 66 pixels, 12672 bytes
constexpr int kHaloSlot = 12800;             // ... rounded up to the 512-byte swizzle period
constexpr int kStages = 4;
constexpr int kThreads = 4 * 128;            // producer + 3 consumer warpgroups
constexpr int kConsumerRegs = 160;           // setmaxnreg: (128 * 4 - 24) / 3, down to 8
constexpr int kMaxDevices = 64;              // per-device host caches

template <int BN>
struct WTile {
  static constexpr int SW = BN == 64 ? 128 : 64;  // gy swizzle: one atom of BN columns
  static constexpr int GY = kRun * SW;
  static constexpr int STAGE = (GY + 2 * kHaloSlot + 1023) / 1024 * 1024;
  static constexpr int SMEM = 1024 + kStages * STAGE + 16 * kStages;
};

struct Params {
  float* partial;
  int H, W, G, cig, cog;
  int nW;              // 64-pixel runs per image row
  int rows;            // B * H
  int rows_per_split;
  int n_ci, n_co;      // channel tiles per group
};

// partial[split, g, tap*cig + i, o]: this block's share of the sum over M
template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
    wgrad_hopper_kernel(const __grid_constant__ CUtensorMap tx,
                        const __grid_constant__ CUtensorMap tg, const Params p) {
  using T = WTile<BN>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t full = base + kStages * T::STAGE, empty = full + 8 * kStages;

  const int split = blockIdx.x;
  const int co_t = blockIdx.y % p.n_co;
  const int ci_t = blockIdx.y / p.n_co % p.n_ci;
  const int g = blockIdx.y / (p.n_co * p.n_ci);
  const int c0 = ci_t * kMC, n0 = co_t * BN;
  const int row_begin = split * p.rows_per_split;
  const int row_end = min(row_begin + p.rows_per_split, p.rows);
  const int n_it = max(row_end - row_begin, 0) * p.nW;
  const bool two = c0 + kCK < p.cig;  // the second box holds channels

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full + 8 * st, 1);    // the producer's expect_tx
      mbar_init(empty + 8 * st, 12);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x != 0) return;
    for (int it = 0; it < n_it; ++it) {
      const int st = it % kStages;
      const int row = row_begin + it / p.nW, w0 = (it % p.nW) * kRun;
      const int b = row / p.H, h = row % p.H;
      mbar_wait(empty + 8 * st, ((it / kStages) & 1) ^ 1);  // free at once on the first lap
      mbar_expect_tx(full + 8 * st, kRun * BN * 2 + (two ? 2 : 1) * kHalo);
      const uint32_t dst = base + st * T::STAGE;
      tma_load(dst, &tg, full + 8 * st, n0, g, w0, h, b);
      tma_load(dst + T::GY, &tx, full + 8 * st, c0, g, w0 - 1, h - 1, b);
      if (two) tma_load(dst + T::GY + kHaloSlot, &tx, full + 8 * st, c0 + kCK, g, w0 - 1, h - 1, b);
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs) : "memory");
  const int dy = threadIdx.x / 128 - 1;
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  // this warp's 16 channels: box warp / 2, 16-byte chunks 2 (warp % 2) + 0..1;
  // ldmatrix.trans row addresses: matrices (channels 0-7 | 8-15) x (pixels
  // 0-7 | 8-15), the transposed halo as the m16n8k16 A fragment
  const int a_px = (lane & 7) + (lane >> 4) * 8 + dy * kCols;
  const int a_chunk = (warp & 1) * 2 + ((lane >> 3) & 1);
  float acc[3][BN / 2];
#pragma unroll
  for (int dx = 0; dx < 3; ++dx)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[dx][i] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int st = it % kStages;
    mbar_wait(full + 8 * st, (it / kStages) & 1);
    const uint32_t gy = base + st * T::STAGE;
    const uint32_t halo = gy + T::GY + (warp >> 1) * kHaloSlot;
#pragma unroll
    for (int kk = 0; kk < kRun / 16; ++kk) {
      uint32_t a[3][4];
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        ldmatrix_x4_trans(a[dx], halo + swz64(a_px + 16 * kk + dx, a_chunk));
      const uint64_t db = make_desc<T::SW>(gy + kk * 16 * T::SW, kRun * T::SW, 8 * T::SW);
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) fence_regs(acc[dx]);
      wgmma_fence();
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) wgmma_rs(acc[dx], a[dx], db);
      wgmma_commit();
      wgmma_wait();
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) fence_regs(acc[dx]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * st);  // this warp is done with the slot
  }

  // accumulator (4n + e): channel 16 warp + lane/4 (+8 for e >= 2), output
  // channel 8n + 2 (lane % 4) + (e & 1)
  const int gq = lane >> 2, t = lane & 3;
  float* pg = p.partial + ((int64_t)split * p.G + g) * 9 * p.cig * p.cog;
#pragma unroll
  for (int dx = 0; dx < 3; ++dx) {
    float* pt = pg + (int64_t)(dy * 3 + dx) * p.cig * p.cog;
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
      const int co = n0 + 8 * n + 2 * t;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int ci = c0 + 16 * warp + gq + 8 * hf;
        if (ci < p.cig && co < p.cog)
          *reinterpret_cast<float2*>(pt + (int64_t)ci * p.cog + co) =
              make_float2(acc[dx][4 * n + 2 * hf], acc[dx][4 * n + 2 * hf + 1]);
      }
    }
  }
}

// out[i] = bf16(sum over splits of partial[split, i]), splits in order
__global__ void wgrad_reduce_kernel(const float* __restrict__ partial, bf16* __restrict__ out,
                                    int64_t n, int nsplit) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < nsplit; ++k) s += partial[(int64_t)k * n + i];
    out[i] = __float2bfloat16(s);
  }
}

template <int BN>
int launch(const void* x, const void* gy, void* partial, void* out, int B, int H, int W, int G,
           int cig, int cog, int nsplit, int dev, cudaStream_t stream) {
  using T = WTile<BN>;
  CUtensorMap tx, tg;
  const uint64_t e = 2;  // bytes per element
  const uint64_t xd[5] = {(uint64_t)cig, (uint64_t)G, (uint64_t)W, (uint64_t)H, (uint64_t)B};
  const uint64_t xs[4] = {cig * e, (uint64_t)G * cig * e, (uint64_t)W * G * cig * e,
                          (uint64_t)H * W * G * cig * e};
  const uint32_t xb[5] = {kCK, 1, kCols, 3, 1};
  const uint64_t gd[5] = {(uint64_t)cog, (uint64_t)G, (uint64_t)W, (uint64_t)H, (uint64_t)B};
  const uint64_t gs[4] = {cog * e, (uint64_t)G * cog * e, (uint64_t)W * G * cog * e,
                          (uint64_t)H * W * G * cog * e};
  const uint32_t gb[5] = {BN, 1, kRun, 1, 1};
  if (!cached_bf16_map(&tx, x, 5, xd, xs, xb, 64) ||
      !cached_bf16_map(&tg, gy, 5, gd, gs, gb, T::SW))
    return (int)cudaErrorInvalidValue;
  auto kernel = wgrad_hopper_kernel<BN>;
  cudaError_t err = cudaSuccess;
  static bool smem_set[kMaxDevices] = {};  // the attribute is set once per device
  if (!smem_set[dev]) {
    err = dd_allow_smem(kernel, T::SMEM);
    if (err != cudaSuccess) return (int)err;
    smem_set[dev] = true;
  }
  Params p;
  p.partial = static_cast<float*>(partial);
  p.H = H;
  p.W = W;
  p.G = G;
  p.cig = cig;
  p.cog = cog;
  p.nW = (W + kRun - 1) / kRun;
  p.rows = B * H;
  p.rows_per_split = (p.rows + nsplit - 1) / nsplit;
  p.n_ci = (cig + kMC - 1) / kMC;
  p.n_co = (cog + BN - 1) / BN;
  dim3 grid(nsplit, G * p.n_ci * p.n_co);
  kernel<<<grid, kThreads, T::SMEM, stream>>>(tx, tg, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t n = (int64_t)G * 9 * cig * cog;
  const int threads = 256;
  const int blocks = (int)((n + threads - 1) / threads < 4096 ? (n + threads - 1) / threads : 4096);
  wgrad_reduce_kernel<<<blocks, threads, 0, stream>>>((const float*)partial, (bf16*)out, n,
                                                      nsplit);
  return (int)cudaGetLastError();
}

}  // namespace

// The same contract as dd_grouped_conv3x3_wgrad; needs cig and cog multiples
// of 8 and 16-byte aligned x and gy. Every split must own at least one row.
extern "C" int dd_grouped_conv3x3_wgrad_hopper(const void* x, const void* gy, void* partial,
                                               void* out, int B, int H, int W, int G, int cig,
                                               int cog, int nsplit, void* stream) {
  if (cig % 8 || cog % 8 || cig <= 0 || cog <= 0 || nsplit <= 0 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(gy)) % 16)
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  cudaStream_t s = (cudaStream_t)stream;
  if (cog % 64 == 0)
    return launch<64>(x, gy, partial, out, B, H, W, G, cig, cog, nsplit, dev, s);
  return launch<32>(x, gy, partial, out, B, H, W, G, cig, cog, nsplit, dev, s);
}
