// Causal (optionally sliding-window) flash attention backward, the dk/dv
// half: bf16 q, k, v, dO in, float32 lse and D = rowsum(dO * O) in, bf16
// dk and dv out. Kernel K4 of the port.
//
// Replaces: containerpilot_tpu/ops/flash.py:_dkdv_kernel (launched by
// _bwd_rows' second pl.pallas_call over the transposed grid, with the
// windowed q span of _q_block_base / _windowed_q_grid), the TPU kernel
// behind the dk and dv of flash_attention's custom_vjp.
//
// What bounds it on the H100: at the training shape (b = 8, s = 2048,
// h = 8, hd = 128) it does 8 * hd FLOPs per kept (q, k) pair (k.q^T,
// v.dO^T, p^T.dO and ds^T.q: 0.14 ms at 989 TFLOP/s) against ~0.05 ms of
// bytes, so it is operations-bound: the products have to run on the
// tensor cores.
//
// The design (sm90.cuh holds the TMA, mbarrier and wgmma helpers):
// - One block owns one (batch*head row, 64-key tile) and loops over the
//   q tiles from the diagonal to the last query the window lets see this
//   key tile, the TPU's sequential q grid axis. dk and dv (2 x 64 x hd
//   float32) stay in the registers of one consumer warpgroup. Nothing
//   carries across blocks and nothing is atomic: the TPU's two-kernel
//   split (dq in K3, dk/dv here) is kept, so all three gradients are the
//   same bits on every run.
// - The products are taken transposed so that keys are the 64 rows of
//   every product: S^T = K.Q^T and dP^T = V.dO^T (both operands K-major
//   in shared memory), after which p^T and ds^T are already in registers
//   as the A operand of dV += p^T.dO and dK += ds^T.Q, whose B operands
//   are the same Q and dO tiles read MN-major through wgmma's transpose
//   flag. Each tile lands in shared memory once, as TMA wrote it
//   (128-byte swizzle), and serves both of its products.
// - A producer warpgroup (one thread of it) brings K and V once and
//   streams Q and dO (with their 64 lse and D values) through a two-stage
//   ring under mbarriers, so the next tile's copy overlaps this tile's
//   products; it drops its register budget (setmaxnreg) and the consumer
//   warpgroup raises its own. ~98 KB of shared memory at hd = 128, so two
//   blocks share an SM and hide each other's softmax behind their
//   products.
// - Only the diagonal tile and a window's edge tiles compare positions;
//   interior tiles skip the mask.
// - blockIdx.y runs from the first k tile (the most q tiles) to the
//   last, so the longest blocks start first.
//
// Numerics: s = q.k in float32 (times hd^-0.5), p = exp(s - lse) where
// the _causal_mask keeps the pair and exactly 0 where it does not, dv =
// sum p^T dO, ds = p * (dO.v - D), dk = scale * sum ds^T q, accumulated
// in float32. Precision difference from the reference, as in every
// tensor-core flash backward: p and ds are rounded to bf16 before the
// p^T.dO and ds^T.q products, where the reference contracts them in
// float32. Queries fully masked for this key tile add exact zeros.

#include "sm90.cuh"

namespace {

constexpr int BQ = 64;       // queries per q tile
constexpr int BK = 64;       // keys per block (one warpgroup)
constexpr int STAGES = 2;    // q ring depth
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
  static constexpr int K = 0;
  static constexpr int V = TILE;
  static constexpr int Q = 2 * TILE;                 // [STAGES] tiles
  static constexpr int DO = Q + STAGES * TILE;       // [STAGES] tiles
  static constexpr int LSE = DO + STAGES * TILE;     // [STAGES][BQ] float
  static constexpr int DD = LSE + STAGES * BQ * 4;   // [STAGES][BQ] float
  static constexpr int BAR = DD + STAGES * BQ * 4;   // 1 + 2 * STAGES mbarriers
  static constexpr int BYTES = BAR + 64 + 1024;      // + alignment slack
};

template <int HD>
__global__ void __launch_bounds__(NT, 2)
flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, int S, int H, int window,
                      float scale) {
  using L = Layout<HD>;
  constexpr int NB = HD / 64;  // 64-column boxes in a row
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;
  const float* lse_s = reinterpret_cast<const float*>(smem + L::LSE);
  const float* dd_s = reinterpret_cast<const float*>(smem + L::DD);

  const int r = blockIdx.x;  // b * H + head
  const int kt = blockIdx.y;
  const int b = r / H;
  const int head = r % H;
  const int k_start = kt * BK;
  const int row0 = b * S;      // the map's row of position 0 in batch b
  const int col0 = head * HD;  // the map's column of this head
  // queries that can see keys [k_start, k_start + BK): the diagonal up to
  // the newest key + window - 1 (the whole tail without a window)
  int last_query = S - 1;
  if (window > 0) {
    const int newest = k_start + BK - 1 + window - 1;
    if (newest < last_query) last_query = newest;
  }
  const int n_tiles = last_query / BQ - kt + 1;

  if (threadIdx.x == 0) {
    sm90::mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 128);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // ---- producer warpgroup: one thread brings K and V, then the ring
    sm90::reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 128) {
      sm90::mbar_expect_tx(kv_full, 2 * L::TILE);
      for (int c = 0; c < NB; ++c) {
        sm90::tma_load_2d(smem + L::K + c * BOX, &tk, kv_full, col0 + 64 * c,
                          row0 + k_start);
        sm90::tma_load_2d(smem + L::V + c * BOX, &tv, kv_full, col0 + 64 * c,
                          row0 + k_start);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        sm90::mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
        const int q_start = (kt + j) * BQ;
        sm90::mbar_expect_tx(&full[s], 2 * L::TILE + 2 * BQ * 4);
        for (int c = 0; c < NB; ++c) {
          sm90::tma_load_2d(smem + L::Q + s * L::TILE + c * BOX, &tq, &full[s],
                            col0 + 64 * c, row0 + q_start);
          sm90::tma_load_2d(smem + L::DO + s * L::TILE + c * BOX, &tdo,
                            &full[s], col0 + 64 * c, row0 + q_start);
        }
        const long at = (long)r * S + q_start;
        sm90::bulk_load(smem + L::LSE + s * BQ * 4, lse + at, BQ * 4, &full[s]);
        sm90::bulk_load(smem + L::DD + s * BQ * 4, delta + at, BQ * 4, &full[s]);
      }
    }
  } else {
    // ---- consumer warpgroup: 64 keys
    sm90::reg_alloc<kConsumerRegs>();
    const int t = threadIdx.x;
    const float scale_log2 = scale * LOG2E;
    const int r_lo = sm90::acc_row(t, 0);  // this thread's keys: r_lo, r_lo + 8
    float dk_acc[HD / 2], dv_acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) {
      dk_acc[i] = 0.f;
      dv_acc[i] = 0.f;
    }
    const uint64_t k_desc = sm90::desc_sw128(smem + L::K, 16, 1024);
    const uint64_t v_desc = sm90::desc_sw128(smem + L::V, 16, 1024);
    sm90::mbar_wait(kv_full, 0);
    __syncwarp();

    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % STAGES;
      const int q_start = (kt + j) * BQ;
      uint8_t* q_tile = smem + L::Q + s * L::TILE;
      uint8_t* do_tile = smem + L::DO + s * L::TILE;
      const uint64_t q_desc = sm90::desc_sw128(q_tile, 16, 1024);
      const uint64_t do_desc = sm90::desc_sw128(do_tile, 16, 1024);
      const uint64_t q_mn = sm90::desc_sw128(q_tile, BOX, 1024);
      const uint64_t do_mn = sm90::desc_sw128(do_tile, BOX, 1024);
      const float* lse_t = lse_s + s * BQ;
      const float* dd_t = dd_s + s * BQ;
      sm90::mbar_wait(&full[s], (j / STAGES) & 1);
      __syncwarp();

      // S^T = K.Q^T and dP^T = V.dO^T, 64 keys x 64 queries each
      float st[32], dpt[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        st[i] = 0.f;
        dpt[i] = 0.f;
      }
      sm90::fence_regs(st);
      sm90::fence_regs(dpt);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk / 4) * BOX + (kk % 4) * 32;
        sm90::wgmma_ss_n64(st, sm90::desc_add(k_desc, off),
                           sm90::desc_add(q_desc, off), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk / 4) * BOX + (kk % 4) * 32;
        sm90::wgmma_ss_n64(dpt, sm90::desc_add(v_desc, off),
                           sm90::desc_add(do_desc, off), kk > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait();
      sm90::fence_regs(st);
      sm90::fence_regs(dpt);

      // p^T = where(mask, exp(s - lse), 0) into st, ds^T = p^T (dp^T - D)
      // into dpt; the columns are queries
      const bool edge = q_start == k_start ||
                        (window > 0 && q_start + BQ - 1 - k_start >= window);
      if (edge) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int col = sm90::acc_col(t, i);
          const int q_pos = q_start + col;
          const int k_pos = k_start + r_lo + 8 * ((i >> 1) & 1);
          bool ok = q_pos >= k_pos;
          if (window > 0) ok = ok && (q_pos - k_pos < window);
          const float p =
              ok ? exp2f(fmaf(st[i], scale_log2, -lse_t[col] * LOG2E)) : 0.f;
          st[i] = p;
          dpt[i] = p * (dpt[i] - dd_t[col]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int col = sm90::acc_col(t, i);
          const float p = exp2f(fmaf(st[i], scale_log2, -lse_t[col] * LOG2E));
          st[i] = p;
          dpt[i] = p * (dpt[i] - dd_t[col]);
        }
      }
      uint32_t pa[4][4], da[4][4];
      sm90::acc_to_a(st, pa);
      sm90::acc_to_a(dpt, da);

      // dV += p^T.dO and dK += ds^T.Q: dO and Q read MN-major
      sm90::fence_regs(dv_acc);
      sm90::fence_regs(dk_acc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        sm90::wgmma_rs_tb<HD>(dv_acc, pa[kk], sm90::desc_add(do_mn, kk * 16 * 128));
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        sm90::wgmma_rs_tb<HD>(dk_acc, da[kk], sm90::desc_add(q_mn, kk * 16 * 128));
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait();
      sm90::fence_regs(dv_acc);
      sm90::fence_regs(dk_acc);
      sm90::mbar_arrive(&empty[s]);  // this stage's Q, dO, lse and D are read
    }

    // dk = scale * dk_acc, dv = dv_acc, bf16
#pragma unroll
    for (int i = 0; i < HD / 2; i += 2) {
      const long off =
          ((long)(row0 + k_start + sm90::acc_row(t, i)) * H + head) * HD +
          sm90::acc_col(t, i);
      *reinterpret_cast<__nv_bfloat162*>(dk + off) =
          __floats2bfloat162_rn(dk_acc[i] * scale, dk_acc[i + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + off) =
          __floats2bfloat162_rn(dv_acc[i], dv_acc[i + 1]);
    }
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dk, void* dv,
                   int B, int S, int H, int window, float scale,
                   cudaStream_t stream) {
  constexpr int smem = Layout<HD>::BYTES;
  static bool configured = false;  // the attribute is per function
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkdv_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
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
  dim3 grid(B * H, S / BK);
  flash_bwd_dkdv_kernel<HD><<<grid, NT, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), S, H, window, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, dout, dk, dv: [B, S, H, HD] bf16 (contiguous, full heads,
// 16-byte aligned); lse, delta: [B*H, S] float32. S % 64 == 0, HD in
// {64, 128}, window >= 0 (0 = full causal). Returns the launch's
// cudaError_t (0 on success). Allocates nothing and never synchronises,
// so a CUDA graph can capture it.
int flash_bwd_dkdv_bf16(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dk, void* dv, int B, int S, int H, int HD,
                        int window, float scale, void* stream) {
  if (S % BK != 0 || window < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (HD) {
    case 64:
      return (int)launch<64>(q, k, v, dout, lse, delta, dk, dv, B, S, H,
                             window, scale, st);
    case 128:
      return (int)launch<128>(q, k, v, dout, lse, delta, dk, dv, B, S, H,
                              window, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* flash_bwd_dkdv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
