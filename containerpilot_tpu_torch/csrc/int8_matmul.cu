// Weight-only int8 dequant GEMM: out[m, n] = bf16((x[m, k] . w_q[k, n])
// * scales[n]), x and out bf16, w_q int8, scales float32, the sum in
// float32. Kernel K2 of the port.
//
// Replaces: containerpilot_tpu/ops/quant.py:_int8_matmul_kernel
// (launched by int8_matmul_pallas' pl.pallas_call, reached through
// int8_matmul_padded), the TPU kernel behind every decode projection of
// an --int8 model.
//
// What bounds it on the H100: bytes at small m. In decode m is the batch
// (1 to 256 rows) and each weight byte is used m times, 2m operations;
// the card does ~295 operations (989 TFLOP/s bf16) in the time it reads
// a byte (3.35 TB/s). Over a flagship decode layer the bytes (weights,
// plus x and out in bf16) set the least time below m ~ 190, the
// operations above: at m = 256, 0.035 ms against 0.027 ms of bytes.
//
// The design (sm90.cuh holds the TMA, mbarrier and wgmma helpers):
// - A and B swapped: each block computes out^T[128 n, N] = W^T[128 n, k]
//   . x^T[k, N] as two wgmma.m64nNk16 products, the weights as A (the
//   64-row side) and x as B. N is m rounded up to 8, 16, 32 or 64; m > 64
//   takes 64-row tiles of x (blockIdx.x). So m = 1 wastes 7 of 8 columns
//   instead of 63 of 64 rows.
// - A from registers, dequantized: the consumer warpgroup reads its int8
//   fragments from the shared-memory weight tile and turns each byte into
//   bf16 exactly (every integer in [-127, 127] is a bf16): the byte, sign
//   flipped, becomes the low mantissa byte of the float32 2^23 + 128 + b,
//   one subtraction gives b, and one byte permute packs the upper halves
//   of two such floats (exact: their low 16 bits are zero). bf16 x bf16
//   products are exact in the float32 accumulator, so the result differs
//   from the plain version only in the order of the float32 sum and the
//   final rounding.
// - The rows of an A tile may stand for any of the block's n columns, as
//   long as the epilogue writes each accumulator row to its own column.
//   Thread group g = warp * 8 + lane / 4 owns the 4 adjacent columns
//   n0 + 4g .. 4g + 3: rows r and r + 8 of product 0 and of product 1. So
//   one 32-bit shared-memory word holds a thread's 4 bytes of one k row,
//   4 such loads give it both products' fragments of a 16-deep k-step,
//   and its 4 outputs of one x row are one 8-byte store. TMA's 128-byte
//   swizzle spreads the 4 k rows a warp reads across all 32 banks.
// - B is x, K-major: TMA brings x's [N rows][64 k] bf16 box with 128-byte
//   swizzle; rows at or past m come from TMA's out-of-bounds zero fill,
//   so nothing is padded and nothing is copied.
// - A producer warpgroup (one thread of it) streams [64 k][128 n] int8
//   weight tiles (8 KB) and their x tiles through a four-stage ring under
//   mbarriers; it hands registers to the consumer warpgroup (setmaxnreg).
//   Two blocks an SM keep 64 KB of weights in flight per SM, over the
//   ~25 KB that 3.35 TB/s x ~1 us of latency over 132 SMs asks for. The
//   consumer builds the next half-stage's fragments while the products
//   of the last one run (fragments double-buffered, fenced with
//   sm90::fence_regs, since the products read them asynchronously).
// - Split k, deterministic: n = 2048 gives only 16 column tiles for 132
//   SMs, so blockIdx.y takes a contiguous share of k (the split count
//   comes from the wrapper's plan). Every thread writes its float32
//   partial values to a workspace and bumps a counter of its own slot;
//   the thread that arrives last sums the slot's partials in split order,
//   multiplies by the scales, rounds to bf16 once and resets the counter.
//   No float atomics: two launches on the same inputs give the same bits.
// - Programmatic dependent launch: the next kernel in the stream may start
//   when this one's blocks are past their main loops, and this one
//   streams its first weight tile before waiting for the previous kernel
//   (griddepcontrol): back-to-back projections overlap their tails.

#include "sm90.cuh"

namespace {

constexpr int TILE_N = 128;    // output columns per block: two m64 products
constexpr int TILE_K = 64;     // k rows per ring stage
constexpr int NT = 256;        // a consumer and a producer warpgroup
constexpr int W_TILE = TILE_K * TILE_N;  // bytes of one int8 weight tile
// Two blocks of 256 threads share an SM (128 registers a thread at
// launch); the producer warpgroup hands back 104 a thread, the consumer
// warpgroup takes them.
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 232;

template <int N>
struct Layout {
  // ring depth: 4 stages (32 KB of weights). Deeper rings (8, or 6 at
  // N = 64) measured slower: every block's requests for the whole ring go
  // out at once, and a block's first tile then waits behind them.
  static constexpr int STAGES = 4;
  static constexpr int X_TILE = N * 128;  // one [N][64] bf16 x tile
  static constexpr int W = 0;                           // [STAGES] tiles
  static constexpr int X = STAGES * W_TILE;             // [STAGES] tiles
  static constexpr int BAR = X + STAGES * X_TILE;       // 2 * STAGES mbarriers
  static constexpr int BYTES = BAR + 2 * STAGES * 8 + 1024;  // + alignment
};

// Byte I of a word whose sign bits were flipped (b + 128), as the bits
// of the float32 b: 0x4B0000xx is 2^23 + xx, and 2^23 + 128 is
// subtracted exactly.
template <int I>
__device__ __forceinline__ uint32_t flipped_byte(uint32_t word) {
  return __float_as_uint(
      __uint_as_float(__byte_perm(word, 0x4B000000u, 0x7650 | I)) - 8388736.f);
}

// two such floats as bf16x2 (lo in the low half): an integer in
// [-127, 127] is a bf16, so the upper 16 bits of its float32 are exact
__device__ __forceinline__ uint32_t upper_halves(uint32_t lo, uint32_t hi) {
  return __byte_perm(lo, hi, 0x7632);
}

// the A fragments of product P (columns 4g + 2P, 4g + 2P + 1) from the
// words of k rows c, c + 1, c + 8, c + 9
template <int P>
__device__ __forceinline__ void dequant_fragment(const uint32_t (&wd)[4],
                                                 uint32_t (&a)[4]) {
  a[0] = upper_halves(flipped_byte<2 * P>(wd[0]), flipped_byte<2 * P>(wd[1]));
  a[1] = upper_halves(flipped_byte<2 * P + 1>(wd[0]),
                      flipped_byte<2 * P + 1>(wd[1]));
  a[2] = upper_halves(flipped_byte<2 * P>(wd[2]), flipped_byte<2 * P>(wd[3]));
  a[3] = upper_halves(flipped_byte<2 * P + 1>(wd[2]),
                      flipped_byte<2 * P + 1>(wd[3]));
}

template <int N>
__global__ void __launch_bounds__(NT, 2)
int8_matmul_kernel(const __grid_constant__ CUtensorMap tw,
                   const __grid_constant__ CUtensorMap tx,
                   const float* __restrict__ scales,
                   __nv_bfloat16* __restrict__ out, float* __restrict__ ws,
                   int* __restrict__ counters, int m, int n, int k_tiles) {
  using L = Layout<N>;
  constexpr int STAGES = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* empty = full + STAGES;

  const int mt = blockIdx.x;      // tile of N rows of x
  const int split = blockIdx.y;   // share of k
  const int nt = blockIdx.z;      // tile of 128 output columns
  const int splits = gridDim.y;
  const int m0 = mt * N;
  const int n0 = nt * TILE_N;
  const int kt0 = split * k_tiles;

  if (threadIdx.x == 128) {  // the producer's maps, while barriers init
    asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&tw))
                 : "memory");
    asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&tx))
                 : "memory");
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 128);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // ---- producer warpgroup: one thread streams the ring
    sm90::reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 128) {
      // The weights do not depend on the kernel before this one in the
      // stream, x may: the first weight tile is requested before waiting
      // for that kernel (griddepcontrol.wait returns at once unless this
      // launch overlaps it), everything else after. (Requesting the whole
      // first ring before the wait measured slower.)
      sm90::mbar_expect_tx(&full[0], W_TILE + L::X_TILE);
      sm90::tma_load_2d(smem + L::W, &tw, &full[0], n0, kt0 * TILE_K);
      asm volatile("griddepcontrol.wait;" ::: "memory");
      for (int j = 0; j < k_tiles; ++j) {
        const int s = j % STAGES;
        const int k_row = (kt0 + j) * TILE_K;
        if (j > 0) {
          sm90::mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
          sm90::mbar_expect_tx(&full[s], W_TILE + L::X_TILE);
          sm90::tma_load_2d(smem + L::W + s * W_TILE, &tw, &full[s], n0, k_row);
        }
        sm90::tma_load_2d(smem + L::X + s * L::X_TILE, &tx, &full[s], k_row, m0);
      }
    }
  } else {
    // ---- consumer warpgroup: 128 output columns, N rows of x
    sm90::reg_alloc<kConsumerRegs>();
    const int t = threadIdx.x;
    const int g = (t / 32) * 8 + (t % 32) / 4;  // columns n0 + 4g .. 4g + 3
    const int c = (t % 4) * 2;                  // k rows c, c+1, c+8, c+9
    float acc[2][N / 2];
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[p][i] = 0.f;

    // Each stage is two halves of two k-steps. A half's fragments are
    // built while the previous half's products run: the products of half
    // h are committed as one group, and waiting until one group is
    // pending frees the other half's fragments (and, after a stage's
    // last products, its ring slot).
    uint32_t a[2][4][4];  // [half][2 * k-step + p]
    for (int j = 0; j < k_tiles; ++j) {
      const int s = j % STAGES;
      const uint8_t* wt = smem + L::W + s * W_TILE;
      const uint64_t x_desc =
          sm90::desc_sw128(smem + L::X + s * L::X_TILE, 16, 1024);
      sm90::mbar_wait(&full[s], (j / STAGES) & 1);
      __syncwarp();
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int kh = 0; kh < 2; ++kh) {
          const int kk = 2 * h + kh;
          uint32_t wd[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = 16 * kk + c + (e & 1) + 8 * (e >> 1);
            const int chunk = (g >> 2) ^ (r & 7);  // the 128-byte swizzle
            wd[e] = *reinterpret_cast<const uint32_t*>(
                        wt + r * 128 + chunk * 16 + (g & 3) * 4) ^
                    0x80808080u;
          }
          dequant_fragment<0>(wd, a[h][2 * kh]);
          dequant_fragment<1>(wd, a[h][2 * kh + 1]);
        }
        sm90::fence_regs(a[h]);
        sm90::wgmma_fence();
#pragma unroll
        for (int kh = 0; kh < 2; ++kh) {
          const uint64_t b = sm90::desc_add(x_desc, (2 * h + kh) * 32);
          sm90::wgmma_rs_kb<N>(acc[0], a[h][2 * kh], b, 1);
          sm90::wgmma_rs_kb<N>(acc[1], a[h][2 * kh + 1], b, 1);
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait_pending<1>();
        sm90::fence_regs(a[h ^ 1]);
        if (h == 0 && j > 0) sm90::mbar_arrive(&empty[(j - 1) % STAGES]);
      }
    }
    sm90::wgmma_wait();
    // the next kernel in the stream may start once every block of this
    // one is past its main loop: its weights stream in while this one's
    // splits are summed, and it waits (griddepcontrol.wait) for this one
    // to finish before it reads anything this one writes
    asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
    sm90::fence_regs(acc[0]);
    sm90::fence_regs(acc[1]);
    sm90::fence_regs(a[0]);
    sm90::fence_regs(a[1]);

    if (splits > 1) {
      // Each thread's values go to the workspace in accumulator order:
      // value q = p * N / 2 + i of thread t of split s at (s * N + q) *
      // 128 + t of its tile's slab, so every store and load is coalesced.
      // Thread t of every split then bumps its tile's counter t (release
      // and acquire); the thread that arrives last holds every split's
      // values for its slot, sums them in split order (the same bits on
      // every launch), writes its outputs and resets the counter.
      const int tile = nt * gridDim.x + mt;
      float* slab = ws + (size_t)tile * splits * (TILE_N * N);
      float* mine = slab + (size_t)split * (TILE_N * N);
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int i = 0; i < N / 2; ++i)
          mine[(p * (N / 2) + i) * 128 + t] = acc[p][i];
      int* counter = counters + tile * 128 + t;
      int arrived;
      asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;"
                   : "=r"(arrived) : "l"(counter) : "memory");
      if (arrived != splits - 1) return;
      *counter = 0;
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int i = 0; i < N / 2; ++i) acc[p][i] = 0.f;
      constexpr int U = 64 / N;  // splits whose loads are in flight at once
      for (int sp0 = 0; sp0 < splits; sp0 += U) {
        float v[U][N];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const float* part = slab + (size_t)(sp0 + u) * (TILE_N * N);
#pragma unroll
          for (int q = 0; q < N; ++q)
            v[u][q] = sp0 + u < splits ? __ldcg(part + q * 128 + t) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int q = 0; q < N; ++q) acc[q / (N / 2)][q % (N / 2)] += v[u][q];
      }
    }

    // out[row, n0 + 4g .. 4g + 3] = (p0 r, p0 r+8, p1 r, p1 r+8) * scales
    const float4 sc = *reinterpret_cast<const float4*>(scales + n0 + 4 * g);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      if ((i >> 1) & 1) continue;  // row r + 8's values go with row r's
      const int row = m0 + sm90::acc_col(t, i);
      if (row < m) {
        uint2 v;
        v.x = sm90::pack_bf16(acc[0][i] * sc.x, acc[0][i + 2] * sc.y);
        v.y = sm90::pack_bf16(acc[1][i] * sc.z, acc[1][i + 2] * sc.w);
        *reinterpret_cast<uint2*>(out + (size_t)row * n + n0 + 4 * g) = v;
      }
    }
  }
}

template <int N>
cudaError_t launch(const void* x, const void* w_q, const void* scales,
                   void* out, void* ws, void* counters, int m, int k, int n,
                   int row_tiles, int splits, cudaStream_t stream) {
  constexpr int smem = Layout<N>::BYTES;
  static bool configured = false;  // the attribute is per function
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        int8_matmul_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  CUtensorMap maps[2];
  cudaError_t err = sm90::make_int8_map(&maps[0], w_q, k, n, TILE_K);
  if (err == cudaSuccess) err = sm90::make_bf16_map(&maps[1], x, m, k, N);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(row_tiles, splits, n / TILE_N);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  // programmatic dependent launch: may overlap the previous kernel's tail
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, int8_matmul_kernel<N>, maps[0], maps[1],
                           static_cast<const float*>(scales),
                           static_cast<__nv_bfloat16*>(out),
                           static_cast<float*>(ws), static_cast<int*>(counters),
                           m, n, k / TILE_K / splits);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: [m, k] bf16, w_q: [k, n] int8, scales: [n] float32, out: [m, n]
// bf16, all contiguous and 16-byte aligned. rows (the wgmma's N) in {8,
// 16, 32, 64} and row_tiles with (row_tiles - 1) * rows < m <=
// row_tiles * rows; n % 128 == 0; k % 64 == 0 and (k / 64) % splits ==
// 0. With splits > 1, ws holds row_tiles * (n / 128) * splits * 128 *
// rows floats and counters row_tiles * (n / 128) * 128 ints, all zero
// before the first launch (each launch leaves them zero; launches that
// share them must run in one stream). Returns the launch's cudaError_t
// (0 on success). Allocates nothing and never synchronises, so a CUDA
// graph can capture it.
int int8_matmul_bf16(const void* x, const void* w_q, const void* scales,
                     void* out, void* ws, void* counters, int m, int k, int n,
                     int rows, int row_tiles, int splits, void* stream) {
  if (m < 1 || row_tiles < 1 || (row_tiles - 1) * rows >= m ||
      row_tiles * rows < m || n < TILE_N || n % TILE_N != 0 || k < TILE_K ||
      k % TILE_K != 0 || splits < 1 || (k / TILE_K) % splits != 0 ||
      (splits > 1 && (ws == nullptr || counters == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (rows) {
    case 8:
      return (int)launch<8>(x, w_q, scales, out, ws, counters, m, k, n,
                            row_tiles, splits, st);
    case 16:
      return (int)launch<16>(x, w_q, scales, out, ws, counters, m, k, n,
                             row_tiles, splits, st);
    case 32:
      return (int)launch<32>(x, w_q, scales, out, ws, counters, m, k, n,
                             row_tiles, splits, st);
    case 64:
      return (int)launch<64>(x, w_q, scales, out, ws, counters, m, k, n,
                             row_tiles, splits, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* int8_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
