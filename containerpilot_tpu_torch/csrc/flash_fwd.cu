// Causal (optionally sliding-window) flash attention forward, bf16 in,
// bf16 out plus float32 logsumexp, GQA-native. Kernel K1 of the port.
//
// Replaces: containerpilot_tpu/ops/flash.py:_fwd_kernel (launched by
// _fwd_rows' pl.pallas_call), the TPU forward behind
// flash_attention_forward and flash_attention's custom_vjp.
//
// What bounds it on the H100: 4 * hd FLOPs per kept (q, k) pair (q.k^T
// and p.v). At the training shape (b = 8, s = 2048, h = 8, hd = 128)
// that is 68.7 GFLOP, 0.070 ms at 989 TFLOP/s, against ~0.03 ms of bytes
// (q, k, v read once, out written once, lse), so it is operations-bound:
// both products have to run on the tensor cores. At the serving shape
// (s = 1024, 16 heads) bytes and operations give nearly the same ~5 us.
//
// The design (sm90.cuh holds the TMA, mbarrier and wgmma helpers; it is
// flash_bwd_dq.cu without dO and dP):
// - One block owns one (batch*head row, 64-query tile) and loops over
//   the kv tiles from the first one the window needs to the diagonal,
//   the TPU's sequential kv grid axis. The running max m, the running
//   sum l and the 64 x hd output accumulator stay in the registers of
//   one consumer warpgroup; scores and probabilities never leave them.
//   Nothing carries across blocks and nothing is atomic, so out and lse
//   are the same bits on every run.
// - Both products are wgmma on bf16 tiles: S = Q.K^T with both operands
//   K-major in shared memory, then O += P.V with P as the register A
//   operand and the V tile read MN-major through wgmma's transpose flag.
//   Each tile lands in shared memory once, as TMA wrote it (128-byte
//   swizzle). The K and V maps span the KVH kv heads: q head h reads kv
//   head h / (H / KVH) straight from the caller's tensors (GQA lives in
//   the map, never in a repeated copy).
// - A producer warpgroup (one thread of it) brings Q once and streams K
//   and V through a two-stage ring under mbarriers, so the next tile's
//   copy overlaps this tile's products; it drops its register budget
//   (setmaxnreg) and the consumer warpgroup raises its own. ~81 KB of
//   shared memory at hd = 128, so two blocks share an SM and hide each
//   other's softmax behind their products (three stages would not leave
//   room for two blocks).
// - Only the diagonal tile and a window's edge tiles compare positions;
//   interior tiles skip the mask.
// - blockIdx.y runs from the last q tile (the most kv tiles) to the
//   first, so the longest blocks start first.
//
// Numerics: the online softmax runs in the log2 domain, s2 = (q.k) *
// hd^-0.5 * log2(e) in float32, masked pairs NEG_INF (-1e30, finite, so
// a row fully masked in a visited tile takes p = exp2(0) = 1 there and
// the next tile's corr = exp2(NEG_INF - m) = 0 erases it, exactly as in
// the reference), p = exp2(s2 - m_new), corr = exp2(m_prev - m_new), l
// clamped at 1e-30, out = acc / l, lse = m * ln(2) + log(l) in natural
// units of the scaled scores. Two precision differences from the
// reference, as in every tensor-core flash forward: the scale multiplies
// S after the bf16 product (accumulated in float32), where the reference
// multiplies q by the scale in float32 first; and p is rounded to bf16
// before the p.v product, where the reference contracts it in float32.

#include "sm90.cuh"

namespace {

constexpr int BQ = 64;       // query rows per block (one warpgroup)
constexpr int BK = 64;       // keys per kv tile
constexpr int STAGES = 2;    // kv ring depth
constexpr int NT = 256;      // a consumer and a producer warpgroup
constexpr int BOX = 64 * 128;  // bytes of one [64][64] bf16 box
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float NEG_INF = -1e30f;
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
  static constexpr int K = TILE;                    // [STAGES] tiles
  static constexpr int V = K + STAGES * TILE;       // [STAGES] tiles
  static constexpr int BAR = V + STAGES * TILE;     // 1 + 2 * STAGES mbarriers
  static constexpr int BYTES = BAR + 64 + 1024;     // + alignment slack
};

// max (or sum) of a row's values over the four lanes that hold it
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int HD>
__global__ void __launch_bounds__(NT, 2)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                 int S, int H, int KVH, int window, float scale) {
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
  const int row0 = b * S;      // the maps' row of position 0 in batch b
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
    // ---- producer warpgroup: one thread brings Q, then the K/V ring
    sm90::reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 128) {
      const int q_col = head * HD;
      const int kv_col = (head / (H / KVH)) * HD;
      sm90::mbar_expect_tx(q_full, L::TILE);
      for (int c = 0; c < NB; ++c) {
        sm90::tma_load_2d(smem + L::Q + c * BOX, &tq, q_full, q_col + 64 * c,
                          row0 + q_start);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        sm90::mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
        const int k_row = row0 + (kt_first + j) * BK;
        sm90::mbar_expect_tx(&full[s], 2 * L::TILE);
        for (int c = 0; c < NB; ++c) {
          sm90::tma_load_2d(smem + L::K + s * L::TILE + c * BOX, &tk, &full[s],
                            kv_col + 64 * c, k_row);
          sm90::tma_load_2d(smem + L::V + s * L::TILE + c * BOX, &tv, &full[s],
                            kv_col + 64 * c, k_row);
        }
      }
    }
  } else {
    // ---- consumer warpgroup: 64 query rows
    sm90::reg_alloc<kConsumerRegs>();
    const int t = threadIdx.x;
    const float scale_log2 = scale * LOG2E;
    const int r_lo = sm90::acc_row(t, 0);  // this thread's rows: r_lo, r_lo + 8
    // m in the log2 domain; l is this thread's share of the row sum (its
    // 16 columns of each tile), summed over the quad at the end
    float m[2] = {NEG_INF, NEG_INF};
    float l[2] = {0.f, 0.f};
    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    const uint64_t q_desc = sm90::desc_sw128(smem + L::Q, 16, 1024);
    sm90::mbar_wait(q_full, 0);
    __syncwarp();

    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % STAGES;
      const int k_start = (kt_first + j) * BK;
      const uint64_t k_desc =
          sm90::desc_sw128(smem + L::K + s * L::TILE, 16, 1024);
      const uint64_t v_mn = sm90::desc_sw128(smem + L::V + s * L::TILE, BOX, 1024);
      sm90::mbar_wait(&full[s], (j / STAGES) & 1);
      __syncwarp();

      // S = Q.K^T, 64 x 64
      float sc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = 0.f;
      sm90::fence_regs(sc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk / 4) * BOX + (kk % 4) * 32;
        sm90::wgmma_ss_n64(sc, sm90::desc_add(q_desc, off),
                           sm90::desc_add(k_desc, off), kk > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait();
      sm90::fence_regs(sc);

      // scale (log2 domain) and mask
      const bool edge = k_start == q_start ||
                        (window > 0 && q_start + BQ - 1 - k_start >= window);
      if (edge) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int q_pos = q_start + r_lo + 8 * ((i >> 1) & 1);
          const int k_pos = k_start + sm90::acc_col(t, i);
          bool ok = q_pos >= k_pos;
          if (window > 0) ok = ok && (q_pos - k_pos < window);
          sc[i] = ok ? sc[i] * scale_log2 : NEG_INF;
        }
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[i] *= scale_log2;
      }

      // online softmax: row max over the quad, p = exp2(s2 - m_new)
      float corr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = m[h];
#pragma unroll
        for (int i = 2 * h; i < 32; i += 4) {
          mx = fmaxf(mx, fmaxf(sc[i], sc[i + 1]));
        }
        const float m_new = quad_max(mx);
        corr[h] = exp2f(m[h] - m_new);
        m[h] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int i = 2 * h; i < 32; i += 4) {
          sc[i] = exp2f(sc[i] - m_new);
          sc[i + 1] = exp2f(sc[i + 1] - m_new);
          sum += sc[i] + sc[i + 1];
        }
        l[h] = l[h] * corr[h] + sum;
      }
      uint32_t a[4][4];
      sm90::acc_to_a(sc, a);

      // O = O * corr + P.V: V read MN-major. The previous P.V has
      // completed (wgmma_wait below), so acc is safe to rescale.
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
      sm90::fence_regs(acc);
      sm90::fence_regs(a);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        sm90::wgmma_rs_tb<HD>(acc, a[kk], sm90::desc_add(v_mn, kk * 16 * 128));
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait();
      sm90::fence_regs(acc);
      sm90::fence_regs(a);
      sm90::mbar_arrive(&empty[s]);  // this stage's K and V are read
    }

    // out = acc / max(l, 1e-30) in bf16; lse = m ln 2 + log(l)
    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float lh = fmaxf(quad_sum(l[h]), 1e-30f);
      inv[h] = 1.f / lh;
      if ((t & 3) == 0) {
        lse[(long)r * S + q_start + r_lo + 8 * h] = m[h] * LN2 + logf(lh);
      }
    }
#pragma unroll
    for (int i = 0; i < HD / 2; i += 2) {
      const int q_pos = q_start + sm90::acc_row(t, i);
      const float f = inv[(i >> 1) & 1];
      __nv_bfloat16* o = out + ((long)(row0 + q_pos) * H + head) * HD +
                         sm90::acc_col(t, i);
      *reinterpret_cast<__nv_bfloat162*>(o) =
          __floats2bfloat162_rn(acc[i] * f, acc[i + 1] * f);
    }
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, int B, int S, int H, int KVH, int window,
                   float scale, cudaStream_t stream) {
  constexpr int smem = Layout<HD>::BYTES;
  static bool configured = false;  // the attribute is per function
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  CUtensorMap maps[3];
  cudaError_t err = sm90::make_bshd_map(&maps[0], q, B, S, H, HD);
  if (err == cudaSuccess) err = sm90::make_bshd_map(&maps[1], k, B, S, KVH, HD);
  if (err == cudaSuccess) err = sm90::make_bshd_map(&maps[2], v, B, S, KVH, HD);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, S / BQ);
  flash_fwd_kernel<HD><<<grid, NT, smem, stream>>>(
      maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), S, H, KVH, window, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, out: [B, S, H, HD] bf16; k, v: [B, S, KVH, HD] bf16 (contiguous,
// 16-byte aligned); lse: [B*H, S] float32. S % 64 == 0, H % KVH == 0,
// HD in {64, 128}, window >= 0 (0 = full causal). Returns the launch's
// cudaError_t (0 on success). Allocates nothing and never synchronises,
// so a CUDA graph can capture it.
int flash_fwd_bf16(const void* q, const void* k, const void* v, void* out,
                   void* lse, int B, int S, int H, int KVH, int HD,
                   int window, float scale, void* stream) {
  if (S % BQ != 0 || KVH < 1 || H % KVH != 0 || window < 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (HD) {
    case 64:
      return (int)launch<64>(q, k, v, out, lse, B, S, H, KVH, window, scale, st);
    case 128:
      return (int)launch<128>(q, k, v, out, lse, B, S, H, KVH, window, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
