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
// operations-bound, and more so at longer sequences.
//
// What this simple design does about it: the same shape as K1
// (csrc/flash_fwd.cu). One block owns one (batch*head row, 64-query
// tile); the TPU's sequential kv grid axis becomes a loop inside the
// block from the first kv tile the window needs to the diagonal tile,
// so the dq accumulator (64 x hd float32, 4 rows x hd/16 columns per
// thread) stays in registers and is scaled once at the end. Nothing
// carries across blocks and nothing is atomic, so dq is deterministic.
// Q (pre-scaled) and dO sit transposed in shared memory for the whole
// block; each kv tile is loaded transposed (for the score and dP
// products) and K once more row-major (for ds @ K). Scores,
// probabilities and ds never reach device memory. Inner products are
// plain float32 FMAs from shared memory (no tensor cores yet), so the
// kernel runs far below the tensor-core bound.
//
// Numerics copy the reference: s = (q * hd^-0.5) . k in float32,
// p = exp(s - lse) where the _causal_mask keeps the pair and exactly 0
// where it does not (the where, never exp(NEG_INF - lse)), ds = p *
// (dO . v - D), dq = scale * sum ds . k. Rows fully masked inside a
// visited tile (a window narrower than the tile) add exact zeros.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // keys per kv tile
constexpr int NT = 256;  // threads: 16 row groups x 16 column groups

__device__ __forceinline__ void bf16x8_to_f32(const uint4 raw, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// Load a [64][HD] bf16 tile (row stride `stride` elements) into shared
// memory transposed, dst[d * 64 + n] = src[n][d] * mul. Consecutive
// threads take consecutive rows, so the transposed writes do not
// conflict.
template <int HD>
__device__ __forceinline__ void load_tile_t(const __nv_bfloat16* src, long stride,
                                            float* dst, float mul) {
  for (int idx = threadIdx.x; idx < 64 * (HD / 8); idx += NT) {
    const int n = idx % 64;
    const int dc = idx / 64;
    const uint4 raw = *reinterpret_cast<const uint4*>(src + n * stride + dc * 8);
    float f[8];
    bf16x8_to_f32(raw, f);
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[(dc * 8 + i) * 64 + n] = f[i] * mul;
  }
}

// Load a [64][HD] bf16 tile row-major: dst[n * HD + d] = src[n][d] * mul.
template <int HD>
__device__ __forceinline__ void load_tile(const __nv_bfloat16* src, long stride,
                                          float* dst, float mul) {
  for (int idx = threadIdx.x; idx < 64 * (HD / 8); idx += NT) {
    const int dc = idx % (HD / 8);
    const int n = idx / (HD / 8);
    const uint4 raw = *reinterpret_cast<const uint4*>(src + n * stride + dc * 8);
    float f[8];
    bf16x8_to_f32(raw, f);
    float4* out = reinterpret_cast<float4*>(dst + n * HD + dc * 8);
    out[0] = make_float4(f[0] * mul, f[1] * mul, f[2] * mul, f[3] * mul);
    out[1] = make_float4(f[4] * mul, f[5] * mul, f[6] * mul, f[7] * mul);
  }
}

// Shared memory (floats): QT, dOT [HD][BQ]; KT, VT [HD][BK]; KS [BK][HD];
// DST [BK][BQ]
template <int HD>
constexpr int smem_floats() {
  return 2 * HD * BQ + 3 * HD * BK + BK * BQ;
}

template <int HD>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, int S, int H, int window,
                    float scale) {
  constexpr int DPT = HD / 16;  // dq columns per thread
  extern __shared__ float smem[];
  float* QT = smem;              // [HD][BQ], q * scale
  float* dOT = QT + HD * BQ;     // [HD][BQ]
  float* KT = dOT + HD * BQ;     // [HD][BK]
  float* VT = KT + HD * BK;      // [HD][BK]
  float* KS = VT + HD * BK;      // [BK][HD]
  float* DST = KS + BK * HD;     // [BK][BQ], ds transposed

  const int t = threadIdx.x;
  const int ty = t / 16;  // rows ty*4 .. ty*4+3 of the q tile
  const int tx = t % 16;  // score cols tx*4.., dq cols tx*DPT..
  const int q_start = blockIdx.x * BQ;
  const int r = blockIdx.y;  // b * H + head
  const int b = r / H;
  const int head = r % H;
  const long row_stride = (long)H * HD;
  const long base = (long)b * S * row_stride + (long)head * HD;

  load_tile_t<HD>(q + base + q_start * row_stride, row_stride, QT, scale);
  load_tile_t<HD>(dout + base + q_start * row_stride, row_stride, dOT, 1.f);

  float lse_r[4], d_r[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q_pos = q_start + ty * 4 + i;
    lse_r[i] = lse[(long)r * S + q_pos];
    d_r[i] = delta[(long)r * S + q_pos];
#pragma unroll
    for (int d = 0; d < DPT; ++d) acc[i][d] = 0.f;
  }

  int first_key = 0;
  if (window > 0) {
    first_key = q_start - (window - 1);
    if (first_key < 0) first_key = 0;
  }
  const int kt_first = first_key / BK;
  const int kt_last = (q_start + BQ - 1) / BK;

  for (int kt = kt_first; kt <= kt_last; ++kt) {
    const int k_start = kt * BK;
    __syncthreads();  // the previous tile's reads of KT/VT/KS/DST are done
    load_tile_t<HD>(k + base + k_start * row_stride, row_stride, KT, 1.f);
    load_tile_t<HD>(v + base + k_start * row_stride, row_stride, VT, 1.f);
    load_tile<HD>(k + base + k_start * row_stride, row_stride, KS, 1.f);
    __syncthreads();

    // s[i][j] = q.k and dp[i][j] = dO.v for rows ty*4+i, keys tx*4+j
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = 0.f;
        dp[i][j] = 0.f;
      }
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(QT + d * BQ + ty * 4);
      const float4 ov = *reinterpret_cast<const float4*>(dOT + d * BQ + ty * 4);
      const float4 kv = *reinterpret_cast<const float4*>(KT + d * BK + tx * 4);
      const float4 vv = *reinterpret_cast<const float4*>(VT + d * BK + tx * 4);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
      const float oa[4] = {ov.x, ov.y, ov.z, ov.w};
      const float ka[4] = {kv.x, kv.y, kv.z, kv.w};
      const float va[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
          dp[i][j] = fmaf(oa[i], va[j], dp[i][j]);
        }
    }

    // p = where(mask, exp(s - lse), 0); ds = p * (dp - D)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q_pos = q_start + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k_pos = k_start + tx * 4 + j;
        bool ok = q_pos >= k_pos;
        if (window > 0) ok = ok && (q_pos - k_pos < window);
        const float p = ok ? expf(s[i][j] - lse_r[i]) : 0.f;
        s[i][j] = p * (dp[i][j] - d_r[i]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<float4*>(DST + (tx * 4 + j) * BQ + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    __syncthreads();

    // acc += ds @ K
#pragma unroll 4
    for (int n = 0; n < BK; ++n) {
      const float4 dv4 = *reinterpret_cast<const float4*>(DST + n * BQ + ty * 4);
      const float da[4] = {dv4.x, dv4.y, dv4.z, dv4.w};
      float ka[DPT];
#pragma unroll
      for (int d4 = 0; d4 < DPT / 4; ++d4) {
        const float4 kk =
            *reinterpret_cast<const float4*>(KS + n * HD + tx * DPT + d4 * 4);
        ka[d4 * 4 + 0] = kk.x;
        ka[d4 * 4 + 1] = kk.y;
        ka[d4 * 4 + 2] = kk.z;
        ka[d4 * 4 + 3] = kk.w;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int d = 0; d < DPT; ++d) acc[i][d] = fmaf(da[i], ka[d], acc[i][d]);
    }
  }

  // dq = acc * scale, bf16
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q_pos = q_start + ty * 4 + i;
    __nv_bfloat16* row = dq + base + (long)q_pos * row_stride + tx * DPT;
#pragma unroll
    for (int d = 0; d < DPT; d += 2) {
      *reinterpret_cast<__nv_bfloat162*>(row + d) =
          __floats2bfloat162_rn(acc[i][d] * scale, acc[i][d + 1] * scale);
    }
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dq, int B, int S,
                   int H, int window, float scale, cudaStream_t stream) {
  const int smem = smem_floats<HD>() * (int)sizeof(float);
  static bool configured = false;  // the attribute is per function
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  dim3 grid(S / BQ, B * H);
  flash_bwd_dq_kernel<HD><<<grid, NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dq), S, H,
      window, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, dout, dq: [B, S, H, HD] bf16 (contiguous, full heads);
// lse, delta: [B*H, S] float32. S % 64 == 0, HD in {64, 128}, window >= 0
// (0 = full causal). Returns the launch's cudaError_t (0 on success).
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
