// K1 grouped_conv3x3: 3x3, stride-1, zero-padded grouped convolution,
// NHWC bf16 activations, fp32 accumulation, bf16 output.
//
// Replaces dualdiffusion_tpu/ops/pallas/grouped_conv.py _kernel_v2 (via
// _pallas_grouped_conv_v2) and _kernel (via _pallas_grouped_conv), the two
// TPU schedules behind grouped_conv2d_3x3_pre, which every EDM2 MLP conv
// pair of the UNet takes at mlp_groups > 1.
//
// out[b, h, w, g*cog + o] = sum_{dy, dx, i} x[b, h+dy-1, w+dx-1, g*cig + i]
//                                          * wt[g, (dy*3 + dx)*cig + i, o]
// with the weights pre-arranged once per module into wt (G, 9*cig, cog).
//
// What bounds it on the H100: per group this is an implicit GEMM with
// M = B*H*W pixels, N = cog, K = 9*cig. At the reference scale (cig, cog
// 32..320) K and N are small, so the kernel is bound by moving the 3x3
// neighbourhood and the weights into shared memory, not by the tensor
// cores. Design: a block owns a 64-pixel run of one output row and BN
// (64, or 32 when cog is not a multiple of 64, so the 32-wide convs waste
// no MMA columns) output channels of one group. Per 32-channel slice of K
// it stages the 3 x 66 halo of that run and the slice's 9 x 32 x BN weights
// in shared memory once, with 16-byte cp.async copies (zero-filled at the
// edges), then all nine taps read their A operand straight from the halo
// tile (a tap is the tile shifted by dx rows): every activation is loaded
// once per slice instead of nine times. The products run on the tensor
// cores through WMMA bf16 16x16x16 fragments with fp32 accumulators; the
// fp32 tile is staged over the same shared memory and stored as 16-byte
// bf16 vectors. Shared memory stays at 46-64 KB so three or four blocks
// share an SM and hide each other's copies. Shapes whose channel counts are
// not multiples of 8 take the same kernel with 2-byte copies.

#include "common.cuh"

#include <mma.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kBM = 64;    // output pixels (along W) per block
constexpr int kKC = 32;    // input channels per K slice
constexpr int kLDA = 48;   // halo row stride in bf16 (32-byte aligned rows)
constexpr int kThreads = 128;
constexpr int kHaloCols = kBM + 2;

constexpr size_t cmax(size_t a, size_t b) { return a > b ? a : b; }

template <int BN>
struct Tile {
  static constexpr int kLDB = BN + 16;  // weight row stride (32-byte aligned rows)
  static constexpr int kLDC = BN + 4;   // fp32 staging row stride
  static constexpr size_t kHaloBytes = 3 * kHaloCols * kLDA * sizeof(bf16);
  static constexpr size_t kWeightBytes = 9 * kKC * kLDB * sizeof(bf16);
  static constexpr size_t kStageBytes = kBM * kLDC * sizeof(float);
  static constexpr size_t kSmemBytes = cmax(kHaloBytes + kWeightBytes, kStageBytes);
};

// 16-byte global -> shared copy; copies zeros when !pred
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <int BN, bool VEC>
__global__ void __launch_bounds__(kThreads)
grouped_conv3x3_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wt,
                       bf16* __restrict__ out, int H, int W, int G, int cig, int cog) {
  using T = Tile<BN>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* halo = reinterpret_cast<bf16*>(smem);
  bf16* wts = reinterpret_cast<bf16*>(smem + T::kHaloBytes);
  float* stage = reinterpret_cast<float*>(smem);  // reuses the tiles after the K loop

  const int n_tiles = (cog + BN - 1) / BN;
  const int w0 = blockIdx.x * kBM;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int g = blockIdx.z / n_tiles;
  const int n0 = (blockIdx.z % n_tiles) * BN;
  const int cin = G * cig;
  const int cout = G * cog;
  const int warp = threadIdx.x / 32;
  const bf16* xb = x + (int64_t)b * H * W * cin + g * cig;
  const bf16* wg = wt + (int64_t)g * 9 * cig * cog;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BN / 16];
#pragma unroll
  for (int j = 0; j < BN / 16; ++j) wmma::fill_fragment(acc[j], 0.f);

  for (int c0 = 0; c0 < cig; c0 += kKC) {
    __syncthreads();  // the previous slice's products are done with smem
    if (VEC) {
      constexpr int kc = kKC / 8;  // 16-byte chunks per halo pixel
      for (int q = threadIdx.x; q < 3 * kHaloCols * kc; q += kThreads) {
        const int k8 = (q % kc) * 8;
        const int col = (q / kc) % kHaloCols;
        const int dy = q / (kc * kHaloCols);
        const int hh = h + dy - 1, ww = w0 + col - 1, ci = c0 + k8;
        const bool in = hh >= 0 && hh < H && ww >= 0 && ww < W && ci < cig;
        cp_async16(halo + (dy * kHaloCols + col) * kLDA + k8,
                   in ? xb + ((int64_t)hh * W + ww) * cin + ci : x, in);
      }
      constexpr int nc = BN / 8;  // 16-byte chunks per weight row
      for (int q = threadIdx.x; q < 9 * kKC * nc; q += kThreads) {
        const int n8 = (q % nc) * 8;
        const int k = (q / nc) % kKC;
        const int tap = q / (nc * kKC);
        const int ci = c0 + k, co = n0 + n8;
        const bool in = ci < cig && co < cog;
        cp_async16(wts + (tap * kKC + k) * T::kLDB + n8,
                   in ? wg + ((int64_t)tap * cig + ci) * cog + co : wt, in);
      }
      cp_async_wait_all();
    } else {
      const bf16 zero = __float2bfloat16(0.f);
      for (int q = threadIdx.x; q < 3 * kHaloCols * kKC; q += kThreads) {
        const int k = q % kKC;
        const int col = (q / kKC) % kHaloCols;
        const int dy = q / (kKC * kHaloCols);
        const int hh = h + dy - 1, ww = w0 + col - 1, ci = c0 + k;
        const bool in = hh >= 0 && hh < H && ww >= 0 && ww < W && ci < cig;
        halo[(dy * kHaloCols + col) * kLDA + k] = in ? xb[((int64_t)hh * W + ww) * cin + ci] : zero;
      }
      for (int q = threadIdx.x; q < 9 * kKC * BN; q += kThreads) {
        const int nn = q % BN;
        const int k = (q / BN) % kKC;
        const int tap = q / (BN * kKC);
        const int ci = c0 + k, co = n0 + nn;
        const bool in = ci < cig && co < cog;
        wts[(tap * kKC + k) * T::kLDB + nn] = in ? wg[((int64_t)tap * cig + ci) * cog + co] : zero;
      }
    }
    __syncthreads();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
#pragma unroll
      for (int kk = 0; kk < kKC; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, halo + (dy * kHaloCols + dx + 16 * warp) * kLDA + kk, kLDA);
#pragma unroll
        for (int j = 0; j < BN / 16; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bm;
          wmma::load_matrix_sync(bm, wts + (tap * kKC + kk) * T::kLDB + 16 * j, T::kLDB);
          wmma::mma_sync(acc[j], a, bm, acc[j]);
        }
      }
    }
  }
  __syncthreads();  // every warp is done with the tiles before they become the stage
#pragma unroll
  for (int j = 0; j < BN / 16; ++j)
    wmma::store_matrix_sync(stage + 16 * warp * T::kLDC + 16 * j, acc[j], T::kLDC,
                            wmma::mem_row_major);
  __syncthreads();
  bf16* orow = out + (int64_t)(b * H + h) * W * cout + g * cog;
  if (VEC) {
    constexpr int nc = BN / 8;
    for (int q = threadIdx.x; q < kBM * nc; q += kThreads) {
      const int m = q / nc, n8 = (q % nc) * 8;
      const int ww = w0 + m, co = n0 + n8;
      if (ww < W && co < cog) {
        const float* s = stage + m * T::kLDC + n8;
        __align__(16) bf16 v[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = __float2bfloat16(s[i]);
        *reinterpret_cast<uint4*>(orow + (int64_t)ww * cout + co) = *reinterpret_cast<uint4*>(v);
      }
    }
  } else {
    for (int q = threadIdx.x; q < kBM * BN; q += kThreads) {
      const int m = q / BN, nn = q % BN;
      const int ww = w0 + m, co = n0 + nn;
      if (ww < W && co < cog)
        orow[(int64_t)ww * cout + co] = __float2bfloat16(stage[m * T::kLDC + nn]);
    }
  }
}

template <int BN, bool VEC>
int launch(const void* x, const void* wt, void* out, int B, int H, int W, int G, int cig,
           int cog, cudaStream_t stream) {
  auto kernel = grouped_conv3x3_kernel<BN, VEC>;
  cudaError_t err = dd_allow_smem(kernel, Tile<BN>::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + kBM - 1) / kBM, B * H, G * ((cog + BN - 1) / BN));
  kernel<<<grid, kThreads, Tile<BN>::kSmemBytes, stream>>>(
      (const bf16*)x, (const bf16*)wt, (bf16*)out, H, W, G, cig, cog);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" int dd_grouped_conv3x3(const void* x, const void* wt, void* out, int B, int H, int W,
                                  int G, int cig, int cog, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = cig % 8 == 0 && cog % 8 == 0 && aligned16(x) && aligned16(wt) &&
                   aligned16(out);
  if (cog % 64 == 0)
    return vec ? launch<64, true>(x, wt, out, B, H, W, G, cig, cog, s)
               : launch<64, false>(x, wt, out, B, H, W, G, cig, cog, s);
  return vec ? launch<32, true>(x, wt, out, B, H, W, G, cig, cog, s)
             : launch<32, false>(x, wt, out, B, H, W, G, cig, cog, s);
}
