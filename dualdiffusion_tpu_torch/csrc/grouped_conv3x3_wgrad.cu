// K4 grouped_conv3x3_wgrad: the weight gradient of K1 (3x3, stride-1,
// zero-padded grouped conv), NHWC bf16 activations and output gradient,
// fp32 accumulation, result in K1's weight layout and the activations' dtype.
//
// Replaces the wgrad half of dualdiffusion_tpu/ops/pallas/grouped_conv.py
// _vjp_bwd (its exact 9-tap reduction _wgrad); the dgrad half is K1 itself on
// io-swapped, tap-reversed weights (ops/kernels/grouped_conv.py dgrad_weights).
//
// dW[g, (dy*3 + dx)*cig + i, o] = sum_{b, h, w} x[b, h+dy-1, w+dx-1, g*cig + i]
//                                              * gy[b, h, w, g*cog + o]
// i.e. per group dW[g] (9*cig x cog) = im2col(x)[g]^T . gy[g], reduced over
// M = B*H*W pixels (176,128 at batch 8 on the reference UNet's level 0).
//
// What bounds it on the H100: the output is small (at most 9*320 x 320 per
// group) and M is huge, so the work has to be split along M across blocks,
// and each block streams its rows of x and gy through shared memory. Design:
// a block owns one group, one 32-channel slice of cig, one BN-wide slice of
// cog (BN 64, or 32 when cog is not a multiple of 64) and one contiguous run
// of output rows (b, h) -- its share of M. Per 64-pixel run of a row it
// stages the 3 x 66 x 32 halo of x and the 64 x BN tile of gy in shared memory
// with 16-byte cp.async copies (zero-filled at the edges), and all nine taps
// read their A operand (the transposed im2col tile, a column-major view of
// the halo) straight from the one halo, as K1 does. Each warp keeps nine fp32
// WMMA accumulators (one per tap) for its 16 input x 16 output channels.
// The blocks of one tile write fp32 partial tiles; a second pass sums them in
// a fixed order and rounds once to bf16, so the result is deterministic (no
// atomics) and matches a single fp32 reduction rounded once.

#include "common.cuh"

#include <mma.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kBM = 64;    // output pixels (along W) per staged run
constexpr int kKC = 32;    // input channels per block
constexpr int kLDA = 48;   // halo row stride in bf16 (32-byte aligned rows)
constexpr int kHaloCols = kBM + 2;

constexpr size_t cmax(size_t a, size_t b) { return a > b ? a : b; }

template <int BN>
struct WTile {
  static constexpr int kColFrags = BN / 16;
  static constexpr int kWarps = 2 * kColFrags;  // x 2 halves of the 32 input channels
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kLDB = BN + 16;          // gy row stride (32-byte aligned rows)
  static constexpr size_t kHaloBytes = 3 * kHaloCols * kLDA * sizeof(bf16);
  static constexpr size_t kGyBytes = kBM * kLDB * sizeof(bf16);
  static constexpr size_t kStageBytes = kWarps * 16 * 16 * sizeof(float);
  static constexpr size_t kSmemBytes = cmax(kHaloBytes + kGyBytes, kStageBytes);
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// partial[split, g, tap*cig + i, o]: this block's share of the sum over M
template <int BN, bool VEC>
__global__ void __launch_bounds__(WTile<BN>::kThreads)
wgrad_partial_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gy,
                     float* __restrict__ partial, int B, int H, int W, int G, int cig,
                     int cog, int rows_per_split) {
  using T = WTile<BN>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* halo = reinterpret_cast<bf16*>(smem);
  bf16* gys = reinterpret_cast<bf16*>(smem + T::kHaloBytes);
  float* stage = reinterpret_cast<float*>(smem);  // reuses the tiles after the loop

  const int n_co = (cog + BN - 1) / BN;
  const int n_ci = (cig + kKC - 1) / kKC;
  const int split = blockIdx.x;
  const int co_t = blockIdx.y % n_co;
  const int ci_t = (blockIdx.y / n_co) % n_ci;
  const int g = blockIdx.y / (n_co * n_ci);
  const int c0 = ci_t * kKC, n0 = co_t * BN;
  const int cin = G * cig, cout = G * cog;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int jf = warp % T::kColFrags;  // this warp's 16 output channels
  const int kh = warp / T::kColFrags;  // this warp's 16 input channels (half of 32)

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) wmma::fill_fragment(acc[t], 0.f);

  const int row_begin = split * rows_per_split;
  const int row_end = min(row_begin + rows_per_split, B * H);
  for (int row = row_begin; row < row_end; ++row) {
    const int b = row / H, h = row % H;
    const bf16* xb = x + (int64_t)b * H * W * cin + g * cig;
    const bf16* gyr = gy + (int64_t)row * W * cout + g * cog;
    for (int w0 = 0; w0 < W; w0 += kBM) {
      __syncthreads();  // the previous run's products are done with smem
      if (VEC) {
        constexpr int kc = kKC / 8;  // 16-byte chunks per halo pixel
        for (int q = threadIdx.x; q < 3 * kHaloCols * kc; q += T::kThreads) {
          const int k8 = (q % kc) * 8;
          const int col = (q / kc) % kHaloCols;
          const int dy = q / (kc * kHaloCols);
          const int hh = h + dy - 1, ww = w0 + col - 1, ci = c0 + k8;
          const bool in = hh >= 0 && hh < H && ww >= 0 && ww < W && ci < cig;
          cp_async16(halo + (dy * kHaloCols + col) * kLDA + k8,
                     in ? xb + ((int64_t)hh * W + ww) * cin + ci : x, in);
        }
        constexpr int nc = BN / 8;  // 16-byte chunks per gy pixel
        for (int q = threadIdx.x; q < kBM * nc; q += T::kThreads) {
          const int n8 = (q % nc) * 8;
          const int m = q / nc;
          const int ww = w0 + m, co = n0 + n8;
          const bool in = ww < W && co < cog;
          cp_async16(gys + m * T::kLDB + n8, in ? gyr + (int64_t)ww * cout + co : gy, in);
        }
        cp_async_wait_all();
      } else {
        const bf16 zero = __float2bfloat16(0.f);
        for (int q = threadIdx.x; q < 3 * kHaloCols * kKC; q += T::kThreads) {
          const int k = q % kKC;
          const int col = (q / kKC) % kHaloCols;
          const int dy = q / (kKC * kHaloCols);
          const int hh = h + dy - 1, ww = w0 + col - 1, ci = c0 + k;
          const bool in = hh >= 0 && hh < H && ww >= 0 && ww < W && ci < cig;
          halo[(dy * kHaloCols + col) * kLDA + k] =
              in ? xb[((int64_t)hh * W + ww) * cin + ci] : zero;
        }
        for (int q = threadIdx.x; q < kBM * BN; q += T::kThreads) {
          const int nn = q % BN, m = q / BN;
          const int ww = w0 + m, co = n0 + nn;
          gys[m * T::kLDB + nn] = (ww < W && co < cog) ? gyr[(int64_t)ww * cout + co] : zero;
        }
      }
      __syncthreads();
#pragma unroll
      for (int mm = 0; mm < kBM; mm += 16) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bm;
        wmma::load_matrix_sync(bm, gys + mm * T::kLDB + 16 * jf, T::kLDB);
#pragma unroll
        for (int t = 0; t < 9; ++t) {
          const int dy = t / 3, dx = t % 3;
          // A (16 input channels x 16 pixels) = the halo shifted by the tap,
          // read column-major: element (i, m) lies at halo[(pixel m) * kLDA + i]
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;
          wmma::load_matrix_sync(a, halo + (dy * kHaloCols + dx + mm) * kLDA + 16 * kh, kLDA);
          wmma::mma_sync(acc[t], a, bm, acc[t]);
        }
      }
    }
  }

  __syncthreads();  // every warp is done with the tiles before they become the stage
  float* ws = stage + warp * 256;
  float* pg = partial + ((int64_t)split * G + g) * 9 * cig * cog;
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    wmma::store_matrix_sync(ws, acc[t], 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int ci = c0 + 16 * kh + e / 16, co = n0 + 16 * jf + e % 16;
      if (ci < cig && co < cog) pg[((int64_t)t * cig + ci) * cog + co] = ws[e];
    }
    __syncwarp();
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

template <int BN, bool VEC>
int launch(const void* x, const void* gy, void* partial, void* out, int B, int H, int W, int G,
           int cig, int cog, int nsplit, cudaStream_t stream) {
  using T = WTile<BN>;
  auto kernel = wgrad_partial_kernel<BN, VEC>;
  cudaError_t err = dd_allow_smem(kernel, T::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int rows_per_split = (B * H + nsplit - 1) / nsplit;
  dim3 grid(nsplit, G * ((cig + kKC - 1) / kKC) * ((cog + BN - 1) / BN));
  kernel<<<grid, T::kThreads, T::kSmemBytes, stream>>>(
      (const bf16*)x, (const bf16*)gy, (float*)partial, B, H, W, G, cig, cog, rows_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t n = (int64_t)G * 9 * cig * cog;
  const int threads = 256;
  const int blocks = (int)((n + threads - 1) / threads < 4096 ? (n + threads - 1) / threads : 4096);
  wgrad_reduce_kernel<<<blocks, threads, 0, stream>>>((const float*)partial, (bf16*)out, n,
                                                      nsplit);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// partial: nsplit * G * 9 * cig * cog fp32 scratch; out: (G, 9*cig, cog) bf16
extern "C" int dd_grouped_conv3x3_wgrad(const void* x, const void* gy, void* partial, void* out,
                                        int B, int H, int W, int G, int cig, int cog, int nsplit,
                                        void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = cig % 8 == 0 && cog % 8 == 0 && aligned16(x) && aligned16(gy);
  if (cog % 64 == 0)
    return vec ? launch<64, true>(x, gy, partial, out, B, H, W, G, cig, cog, nsplit, s)
               : launch<64, false>(x, gy, partial, out, B, H, W, G, cig, cog, nsplit, s);
  return vec ? launch<32, true>(x, gy, partial, out, B, H, W, G, cig, cog, nsplit, s)
             : launch<32, false>(x, gy, partial, out, B, H, W, G, cig, cog, nsplit, s);
}
