// K1 on Hopper: the 3x3, stride-1, zero-padded grouped conv, NHWC bf16
// activations, fp32 accumulation, bf16 output, on wgmma fed by TMA through
// an mbarrier ring. dgrad is this kernel on io-swapped, tap-reversed weights
// (ops/kernels/grouped_conv.py dgrad_weights).
//
// Replaces dualdiffusion_tpu/ops/pallas/grouped_conv.py _kernel_v2 (via
// _pallas_grouped_conv_v2) and _kernel (via _pallas_grouped_conv). Shapes
// whose channel counts are not multiples of 8, or tensors that are not
// 16-byte aligned (TMA's rules), take the WMMA kernel of
// grouped_conv3x3.cu; the wrapper makes that choice (hopper_takes).
//
// out[b, h, w, g*cog + o] = sum_{dy, dx, i} x[b, h+dy-1, w+dx-1, g*cig + i]
//                                          * wt[g, (dy*3 + dx)*cig + i, o]
//
// What bounds it on the H100: per group an implicit GEMM with M = B*H*W
// pixels, N = cog, K = 9*cig; at the reference scale (cig, cog 32..320)
// the main path's operations take 0.73 ms per UNet forward at the tensor
// cores' peak, and its bytes less. So it is bound by feeding the tensor
// cores: the 3x3 neighbourhood and the weights into shared memory.
//
// Design: a persistent grid of 3-warpgroup blocks (one per SM, two at BN <=
// 64) walks work
// items (group g, N tile of BN output channels, a pair of 64-pixel runs of
// image rows). Per item it runs K in stages of (32 input channels, one
// kernel row dy):
// - warpgroup 0 is the producer (setmaxnreg 24): one thread issues TMA
//   loads into a ring of STAGES slots with full and empty mbarriers. A slot
//   holds, for each of the two runs, one halo row of x (66 pixels x 32
//   channels) from a 5-D tensor map (cig, G, W, H, B): a box never leaves its
//   group, and TMA's zero fill of the coordinates w = -1, W and h = -1, H is
//   the conv's zero padding, so no load is predicated. Beside them the
//   slot holds the weights of the three taps (dy, 0..2) for those channels,
//   from a 5-D map (cog, cig, 3, 3, G), cog contiguous.
// - warpgroups 1 and 2 are consumers, one 64-pixel run each (M = 64). The
//   tap shift dx moves the A operand by dx pixel rows of the halo, which is
//   not a multiple of the 8-row core matrices a wgmma shared-memory
//   descriptor addresses. So A comes from registers: each warp reads its
//   16 pixels x 16 channels with ldmatrix, one row address per lane (any
//   shift is fine), from the 64-byte-swizzled halo (conflict-free), and the
//   product is wgmma m64nBNk16 with A from registers and the weights as an
//   MN-major B in shared memory (the transpose bit; 128-byte swizzled
//   64-column atoms when BN is a multiple of 64, else 64-byte swizzled
//   32-column atoms). The halo is loaded once per (channel slice, dy) and
//   read by all three taps.
// - registers: a consumer thread holds BN/2 fp32 accumulators and 24
//   registers of A fragments (6 k-steps of 16 per stage); setmaxnreg gives
//   the consumers 240 registers (104 at two blocks per SM), 0 spills.
// - the epilogue rounds the accumulators to bf16 into the consumer's own
//   shared-memory tile, then stores 16-byte vectors, while the producer
//   already loads the next item.
// BN is the whole of cog up to 256 (160 above), so the halo is staged once
// per group; for grids smaller than the card (the UNet's deep levels) the
// host narrows BN in steps of 32 until the items cover the SMs.

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace dd;
using bf16 = __nv_bfloat16;

constexpr int kRun = 64;                 // output pixels per consumer (wgmma M)
constexpr int kCols = kRun + 2;          // halo columns
constexpr int kCK = 32;                  // input channels per stage: 64-byte halo rows
constexpr int kXBox = kCK * kCols * 2;   // one halo row of one run: 4224 bytes
constexpr int kXSlot = 4608;             // ... rounded up to the 512-byte swizzle period
constexpr int kThreads = 3 * 128;        // producer + 2 consumer warpgroups
constexpr int kSmemPerSM = 233472;       // 228 KB, of which the system keeps 1 KB a block
constexpr int kMaxDevices = 64;          // per-device host caches

template <int BN>
struct FTile {
  // blocks per SM: two at narrow N, whose stages are short, so that one
  // block's waits overlap the other's products
  static constexpr int BLOCKS = BN <= 64 ? 2 : 1;
  // registers per thread at launch (__launch_bounds__) and the consumers'
  // after setmaxnreg: the two consumer warpgroups take what the producer
  // frees going down to 24 (240 at one block per SM, 104 at two)
  static constexpr int ENTRY = 65536 / (kThreads * BLOCKS) / 8 * 8;
  static constexpr int REGS = (ENTRY * 3 - 24) / 2 / 8 * 8;
  static constexpr int SW = BN % 64 == 0 ? 128 : 64;  // weight swizzle: bytes per atom row
  static constexpr int AC = SW / 2;                   // columns per atom (one TMA box)
  static constexpr int NA = BN / AC;
  static constexpr int W_ATOM = 3 * kCK * SW;         // rows (dx, ci) of one atom
  static constexpr int W_BYTES = NA * W_ATOM;
  static constexpr int STAGE = (W_BYTES + 2 * kXSlot + 1023) / 1024 * 1024;
  static constexpr int TX = W_BYTES + 2 * kXBox;      // bytes TMA writes per stage
  static constexpr int EPI_LD = BN * 2 + 16;          // epilogue row bytes (conflict-free)
  static constexpr int EPI = 2 * kRun * EPI_LD;
  static constexpr int FIT = (kSmemPerSM / BLOCKS - 1024 - 1024 - EPI - 128) / STAGE;
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static constexpr int SMEM = 1024 + STAGES * STAGE + EPI + 16 * STAGES;
  static_assert(STAGES >= 2, "the ring needs two stages");
};

struct Params {
  bf16* out;
  int H, W, G, cig, cog;
  int nW;      // 64-pixel runs per image row
  int runs;    // B * H * nW
  int pairs;   // runs / 2, rounded up
  int n_nt;    // N tiles per group
  int items;   // pairs * n_nt * G
  int n_it;    // stages per item: 3 per 32-channel slice of cig
};

// (b, h, w0) of run r; a missing second run of the last pair repeats the first
__device__ __forceinline__ void run_coords(const Params& p, int r, int& b, int& h, int& w0) {
  r = min(r, p.runs - 1);
  const int row = r / p.nW;
  w0 = (r % p.nW) * kRun;
  b = row / p.H;
  h = row % p.H;
}

template <int BN>
__global__ void __launch_bounds__(kThreads, FTile<BN>::BLOCKS)
    conv3x3_hopper_kernel(const __grid_constant__ CUtensorMap tx,
                          const __grid_constant__ CUtensorMap tw, const Params p) {
  using T = FTile<BN>;
  extern __shared__ unsigned char smem_raw[];
  // slots aligned to 1 KB, the period of the 128-byte swizzle
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t epi = base + T::STAGES * T::STAGE;
  const uint32_t full = epi + T::EPI, empty = full + 8 * T::STAGES;

  if (threadIdx.x == 0) {
    for (int st = 0; st < T::STAGES; ++st) {
      mbar_init(full + 8 * st, 1);   // the producer's expect_tx
      mbar_init(empty + 8 * st, 8);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x != 0) return;
    int it = 0;  // stages issued by this block, across items
    for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
      const int pair = item % p.pairs, nt = item / p.pairs % p.n_nt, g = item / p.pairs / p.n_nt;
      int b[2], h[2], w0[2];
      for (int j = 0; j < 2; ++j) run_coords(p, 2 * pair + j, b[j], h[j], w0[j]);
      for (int s = 0; s < p.n_it; ++s, ++it) {
        const int st = it % T::STAGES, c0 = s / 3 * kCK, dy = s % 3;
        mbar_wait(empty + 8 * st, ((it / T::STAGES) & 1) ^ 1);  // free at once on the first lap
        mbar_expect_tx(full + 8 * st, T::TX);
        const uint32_t dst = base + st * T::STAGE;
#pragma unroll
        for (int a = 0; a < T::NA; ++a)
          tma_load(dst + a * T::W_ATOM, &tw, full + 8 * st, nt * BN + a * T::AC, c0, 0, dy, g);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          tma_load(dst + T::W_BYTES + j * kXSlot, &tx, full + 8 * st, c0, g, w0[j] - 1,
                   h[j] + dy - 1, b[j]);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(T::REGS) : "memory");
  const int c = threadIdx.x / 128 - 1;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  // ldmatrix row addresses: matrices (pixels 0-7 | 8-15) x (channels 0-7 |
  // 8-15) of this warp's 16 pixels, i.e. the m16n8k16 A fragment
  const int a_row = 16 * warp + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_chunk = lane >> 4;
  unsigned char* ep = smem + (epi - base) + c * kRun * T::EPI_LD;
  float acc[BN / 2];
  int it = 0;
  for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
    const int pair = item % p.pairs, nt = item / p.pairs % p.n_nt, g = item / p.pairs / p.n_nt;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int s = 0; s < p.n_it; ++s, ++it) {
      const int st = it % T::STAGES;
      mbar_wait(full + 8 * st, (it / T::STAGES) & 1);
      const uint32_t w = base + st * T::STAGE, x = w + T::W_BYTES + c * kXSlot;
      uint32_t a[6][4];
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
#pragma unroll
        for (int kh = 0; kh < 2; ++kh)
          ldmatrix_x4(a[dx * 2 + kh], x + swz64(a_row + dx, 2 * kh + a_chunk));
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
#pragma unroll
        for (int kh = 0; kh < 2; ++kh)
          wgmma_rs(acc, a[dx * 2 + kh],
                   make_desc<T::SW>(w + (dx * kCK + kh * 16) * T::SW, T::W_ATOM, 8 * T::SW));
      wgmma_commit();
      wgmma_wait();
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * st);  // this warp is done with the slot
    }

    // epilogue: bf16 pairs into this consumer's tile (row = pixel), then
    // 16-byte stores of whole rows
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");  // the last item's stores read it
    const int gq = lane >> 2, t = lane & 3, r = 16 * warp + gq;
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
      *reinterpret_cast<uint32_t*>(ep + r * T::EPI_LD + (8 * n + 2 * t) * 2) =
          pack_bf16(acc[4 * n + 0], acc[4 * n + 1]);
      *reinterpret_cast<uint32_t*>(ep + (r + 8) * T::EPI_LD + (8 * n + 2 * t) * 2) =
          pack_bf16(acc[4 * n + 2], acc[4 * n + 3]);
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
    if (2 * pair + c < p.runs) {
      int b, h, w0;
      run_coords(p, 2 * pair + c, b, h, w0);
      const int cout = p.G * p.cog;
      bf16* orow = p.out + ((int64_t)(b * p.H + h) * p.W) * cout + g * p.cog;
      for (int i = tid; i < kRun * (BN / 8); i += 128) {
        const int m = i / (BN / 8), ch = i % (BN / 8);
        const int ww = w0 + m, co = nt * BN + ch * 8;
        if (ww < p.W && co < p.cog)
          *reinterpret_cast<uint4*>(orow + (int64_t)ww * cout + co) =
              *reinterpret_cast<const uint4*>(ep + m * T::EPI_LD + ch * 16);
      }
    }
  }
}

int sm_count(int dev) {
  static int sms[kMaxDevices] = {0};
  if (sms[dev] == 0) cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  return sms[dev];
}

template <int BN>
int launch(const void* x, const void* wt, void* out, int B, int H, int W, int G, int cig, int cog,
           int dev, int sms, cudaStream_t stream) {
  using T = FTile<BN>;
  CUtensorMap tx, tw;
  const uint64_t e = 2;  // bytes per element
  const uint64_t xd[5] = {(uint64_t)cig, (uint64_t)G, (uint64_t)W, (uint64_t)H, (uint64_t)B};
  const uint64_t xs[4] = {cig * e, (uint64_t)G * cig * e, (uint64_t)W * G * cig * e,
                          (uint64_t)H * W * G * cig * e};
  const uint32_t xb[5] = {kCK, 1, kCols, 1, 1};
  const uint64_t wd[5] = {(uint64_t)cog, (uint64_t)cig, 3, 3, (uint64_t)G};
  const uint64_t ws[4] = {cog * e, (uint64_t)cig * cog * e, 3ull * cig * cog * e,
                          9ull * cig * cog * e};
  const uint32_t wb[5] = {(uint32_t)T::AC, kCK, 3, 1, 1};
  if (!cached_bf16_map(&tx, x, 5, xd, xs, xb, 64) ||
      !cached_bf16_map(&tw, wt, 5, wd, ws, wb, T::SW))
    return (int)cudaErrorInvalidValue;
  auto kernel = conv3x3_hopper_kernel<BN>;
  cudaError_t err = cudaSuccess;
  static bool smem_set[kMaxDevices] = {};  // the attribute is set once per device
  if (!smem_set[dev]) {
    err = dd_allow_smem(kernel, T::SMEM);
    if (err != cudaSuccess) return (int)err;
    smem_set[dev] = true;
  }
  Params p;
  p.out = static_cast<bf16*>(out);
  p.H = H;
  p.W = W;
  p.G = G;
  p.cig = cig;
  p.cog = cog;
  p.nW = (W + kRun - 1) / kRun;
  p.runs = B * H * p.nW;
  p.pairs = (p.runs + 1) / 2;
  p.n_nt = (cog + BN - 1) / BN;
  p.items = p.pairs * p.n_nt * G;
  p.n_it = (cig + kCK - 1) / kCK * 3;
  const int grid = p.items < sms * T::BLOCKS ? p.items : sms * T::BLOCKS;
  kernel<<<grid, kThreads, T::SMEM, stream>>>(tx, tw, p);
  return (int)cudaGetLastError();
}

}  // namespace

// The same contract as dd_grouped_conv3x3; needs cig and cog multiples of 8
// and 16-byte aligned x, wt and out.
extern "C" int dd_grouped_conv3x3_hopper(const void* x, const void* wt, void* out, int B, int H,
                                         int W, int G, int cig, int cog, void* stream) {
  if (cig % 8 || cog % 8 || cig <= 0 || cog <= 0 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(wt) |
       reinterpret_cast<uintptr_t>(out)) % 16)
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  const int sms = sm_count(dev);
  // N tile: the whole of cog up to 256, else 160; narrower while the items
  // (pairs of runs x N tiles x groups) would not cover the SMs
  const int64_t pairs = ((int64_t)B * H * ((W + kRun - 1) / kRun) + 1) / 2;
  int bn = cog <= 256 ? (cog + 31) / 32 * 32 : 160;
  while (bn > 32 && pairs * G * ((cog + bn - 1) / bn) < sms) bn -= 32;
  cudaStream_t s = (cudaStream_t)stream;
  switch (bn) {
    case 32: return launch<32>(x, wt, out, B, H, W, G, cig, cog, dev, sms, s);
    case 64: return launch<64>(x, wt, out, B, H, W, G, cig, cog, dev, sms, s);
    case 96: return launch<96>(x, wt, out, B, H, W, G, cig, cog, dev, sms, s);
    case 128: return launch<128>(x, wt, out, B, H, W, G, cig, cog, dev, sms, s);
    case 160: return launch<160>(x, wt, out, B, H, W, G, cig, cog, dev, sms, s);
    case 192: return launch<192>(x, wt, out, B, H, W, G, cig, cog, dev, sms, s);
    case 224: return launch<224>(x, wt, out, B, H, W, G, cig, cog, dev, sms, s);
    default: return launch<256>(x, wt, out, B, H, W, G, cig, cog, dev, sms, s);
  }
}
