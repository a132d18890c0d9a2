// Causal (optionally sliding-window) flash attention backward, the dq
// half: bf16 q, k, v, dO in, float32 lse and D = rowsum(dO * O) in, bf16
// dq out. Kernel K3 of the port.
//
// Replaces: containerpilot_tpu/ops/flash.py:_dq_kernel (launched by
// _bwd_rows' first pl.pallas_call), the TPU kernel behind the dq of
// flash_attention's custom_vjp.
//
// What bounds it on the H100: at the training shape (b = 8, s = 2048,
// h = 8, hd = 128) it does 6 * hd FLOPs per kept (q, k) pair (q.k^T,
// dO.v^T and ds.k: 0.10 ms at 989 TFLOP/s) against ~0.05 ms of bytes
// (q, k, v, dO read once, dq written once, lse and D), so it is
// operations-bound: the products have to run on the tensor cores.
//
// The design (sm90.cuh holds the TMA, mbarrier and wgmma helpers):
// - One block owns one (batch*head row, 64-query tile) and loops over
//   the kv tiles from the first one the window needs to the diagonal,
//   the TPU's sequential kv grid axis. dq (64 x hd float32) stays in the
//   registers of one consumer warpgroup; nothing carries across blocks
//   and nothing is atomic, so dq is the same bits on every run.
// - All three products are wgmma on bf16 tiles: S = Q.K^T and
//   dP = dO.V^T with both operands K-major in shared memory, then
//   dQ += dS.K with dS as the register A operand and the same K tile read
//   MN-major through wgmma's transpose flag. Each tile lands in shared
//   memory once, as TMA wrote it (128-byte swizzle), and serves both of
//   its products; scores, probabilities and dS never leave registers.
// - A producer warpgroup (one thread of it) brings Q and dO once and
//   streams K and V through a two-stage ring under mbarriers, so the
//   next tile's copy overlaps this tile's products; it drops its
//   register budget (setmaxnreg) and the consumer warpgroup raises its
//   own. ~97 KB of shared memory at hd = 128, so two blocks share an SM
//   and hide each other's softmax behind their products.
// - Only the diagonal tile and a window's edge tiles compare positions;
//   interior tiles skip the mask.
// - blockIdx.y runs from the last q tile (the most kv tiles) to the
//   first, so the longest blocks start first.
//
// Numerics: s = q.k in float32 (times hd^-0.5), p = exp(s - lse) where
// the _causal_mask keeps the pair and exactly 0 where it does not (the
// reference's where, never exp(NEG_INF - lse)), ds = p * (dO.v - D),
// dq = scale * sum ds.k, accumulated in float32. Precision difference
// from the reference, as in every tensor-core flash backward: ds is
// rounded to bf16 before the ds.k product, where the reference contracts
// it in float32. Rows fully masked inside a visited tile add exact zeros.

#include "sm90.cuh"

namespace {

constexpr int BQ = 64;       // query rows per block (one warpgroup)
constexpr int BK = 64;       // keys per kv tile
constexpr int STAGES = 2;    // kv ring depth
constexpr int NT = 256;      // a consumer and a producer warpgroup
constexpr int BOX = 64 * 128;  // bytes of one [64][64] bf16 box
constexpr float LOG2E = 1.4426950408889634f;
// Register budgets after setmaxnreg. Two blocks of 256 threads share an
// SM, so every thread starts with 65536 / 512 = 128 registers; the
// producer warpgroup (one thread of it starts the copies) hands back 104 a
// thread and the consumer warpgroup takes them: 128 + 104 = 232.
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 232;

template <int HD>
struct Layout {
  static constexpr int TILE = 64 * HD * 2;  // one [64][HD] bf16 tile
  static constexpr int Q = 0;
  static constexpr int DO = TILE;
  static constexpr int K = 2 * TILE;                // [STAGES] tiles
  static constexpr int V = K + STAGES * TILE;       // [STAGES] tiles
  static constexpr int BAR = V + STAGES * TILE;     // 1 + 2 * STAGES mbarriers
  static constexpr int BYTES = BAR + 64 + 1024;     // + alignment slack
};

template <int HD>
__global__ void __launch_bounds__(NT, 2)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, int S, int H, int window,
                    float scale) {
  using L = Layout<HD>;
  constexpr int NB = HD / 64;  // 64-column boxes in a row
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  const int r = blockIdx.x;  // b * H + head
  const int qt = S / BQ - 1 - blockIdx.y;
  const int b = r / H;
  const int head = r % H;
  const int q_start = qt * BQ;
  const int row0 = b * S;      // the map's row of position 0 in batch b
  const int col0 = head * HD;  // the map's column of this head
  int first_key = 0;
  if (window > 0) {
    first_key = q_start - (window - 1);
    if (first_key < 0) first_key = 0;
  }
  const int kt_first = first_key / BK;
  const int n_tiles = qt - kt_first + 1;  // up to the diagonal tile

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 128);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // ---- producer warpgroup: one thread brings Q and dO, then the ring
    sm90::reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 128) {
      sm90::mbar_expect_tx(q_full, 2 * L::TILE);
      for (int c = 0; c < NB; ++c) {
        sm90::tma_load_2d(smem + L::Q + c * BOX, &tq, q_full, col0 + 64 * c,
                          row0 + q_start);
        sm90::tma_load_2d(smem + L::DO + c * BOX, &tdo, q_full, col0 + 64 * c,
                          row0 + q_start);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        sm90::mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
        const int k_row = row0 + (kt_first + j) * BK;
        sm90::mbar_expect_tx(&full[s], 2 * L::TILE);
        for (int c = 0; c < NB; ++c) {
          sm90::tma_load_2d(smem + L::K + s * L::TILE + c * BOX, &tk, &full[s],
                            col0 + 64 * c, k_row);
          sm90::tma_load_2d(smem + L::V + s * L::TILE + c * BOX, &tv, &full[s],
                            col0 + 64 * c, k_row);
        }
      }
    }
  } else {
    // ---- consumer warpgroup: 64 query rows
    sm90::reg_alloc<kConsumerRegs>();
    const int t = threadIdx.x;
    const float scale_log2 = scale * LOG2E;
    const int r_lo = sm90::acc_row(t, 0);  // this thread's rows: r_lo, r_lo + 8
    float lse2[2], dd[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long at = (long)r * S + q_start + r_lo + 8 * h;
      lse2[h] = lse[at] * LOG2E;
      dd[h] = delta[at];
    }
    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    const uint64_t q_desc = sm90::desc_sw128(smem + L::Q, 16, 1024);
    const uint64_t do_desc = sm90::desc_sw128(smem + L::DO, 16, 1024);
    sm90::mbar_wait(q_full, 0);
    __syncwarp();

    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % STAGES;
      const int k_start = (kt_first + j) * BK;
      uint8_t* k_tile = smem + L::K + s * L::TILE;
      const uint64_t k_desc = sm90::desc_sw128(k_tile, 16, 1024);
      const uint64_t v_desc = sm90::desc_sw128(smem + L::V + s * L::TILE, 16, 1024);
      const uint64_t k_mn = sm90::desc_sw128(k_tile, BOX, 1024);
      sm90::mbar_wait(&full[s], (j / STAGES) & 1);
      __syncwarp();

      // S = Q.K^T and dP = dO.V^T, 64 x 64 each
      float sc[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        sc[i] = 0.f;
        dp[i] = 0.f;
      }
      sm90::fence_regs(sc);
      sm90::fence_regs(dp);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk / 4) * BOX + (kk % 4) * 32;
        sm90::wgmma_ss_n64(sc, sm90::desc_add(q_desc, off),
                           sm90::desc_add(k_desc, off), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk / 4) * BOX + (kk % 4) * 32;
        sm90::wgmma_ss_n64(dp, sm90::desc_add(do_desc, off),
                           sm90::desc_add(v_desc, off), kk > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait();
      sm90::fence_regs(sc);
      sm90::fence_regs(dp);

      // ds = where(mask, exp(s - lse), 0) * (dp - D), into sc
      const bool edge = k_start == q_start ||
                        (window > 0 && q_start + BQ - 1 - k_start >= window);
      if (edge) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int h = (i >> 1) & 1;
          const int q_pos = q_start + r_lo + 8 * h;
          const int k_pos = k_start + sm90::acc_col(t, i);
          bool ok = q_pos >= k_pos;
          if (window > 0) ok = ok && (q_pos - k_pos < window);
          const float p = ok ? exp2f(fmaf(sc[i], scale_log2, -lse2[h])) : 0.f;
          sc[i] = p * (dp[i] - dd[h]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int h = (i >> 1) & 1;
          const float p = exp2f(fmaf(sc[i], scale_log2, -lse2[h]));
          sc[i] = p * (dp[i] - dd[h]);
        }
      }
      uint32_t a[4][4];
      sm90::acc_to_a(sc, a);

      // dQ += dS.K: K read MN-major from the same tile
      sm90::fence_regs(acc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        sm90::wgmma_rs_tb<HD>(acc, a[kk], sm90::desc_add(k_mn, kk * 16 * 128));
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait();
      sm90::fence_regs(acc);
      sm90::mbar_arrive(&empty[s]);  // this stage's K and V are read
    }

    // dq = scale * acc, bf16
#pragma unroll
    for (int i = 0; i < HD / 2; i += 2) {
      const int q_pos = q_start + sm90::acc_row(t, i);
      __nv_bfloat16* out = dq + ((long)(row0 + q_pos) * H + head) * HD +
                           sm90::acc_col(t, i);
      *reinterpret_cast<__nv_bfloat162*>(out) =
          __floats2bfloat162_rn(acc[i] * scale, acc[i + 1] * scale);
    }
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dq, int B, int S,
                   int H, int window, float scale, cudaStream_t stream) {
  constexpr int smem = Layout<HD>::BYTES;
  static bool configured = false;  // the attribute is per function
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  CUtensorMap maps[4];
  const void* srcs[4] = {q, k, v, dout};
  for (int i = 0; i < 4; ++i) {
    cudaError_t err = sm90::make_bshd_map(&maps[i], srcs[i], B, S, H, HD);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(B * H, S / BQ);
  flash_bwd_dq_kernel<HD><<<grid, NT, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dq), S, H,
      window, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, dout, dq: [B, S, H, HD] bf16 (contiguous, full heads, 16-byte
// aligned); lse, delta: [B*H, S] float32. S % 64 == 0, HD in {64, 128},
// window >= 0 (0 = full causal). Returns the launch's cudaError_t (0 on
// success). Allocates nothing and never synchronises, so a CUDA graph
// can capture it.
int flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int B, int S, int H, int HD, int window,
                      float scale, void* stream) {
  if (S % BQ != 0 || window < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (HD) {
    case 64:
      return (int)launch<64>(q, k, v, dout, lse, delta, dq, B, S, H, window,
                             scale, st);
    case 128:
      return (int)launch<128>(q, k, v, dout, lse, delta, dq, B, S, H, window,
                              scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* flash_bwd_dq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
