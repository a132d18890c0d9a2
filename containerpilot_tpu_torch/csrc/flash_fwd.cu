// Causal (optionally sliding-window) flash attention forward, bf16 in,
// bf16 out plus float32 logsumexp, GQA-native. Kernel K1 of the port.
//
// Replaces: containerpilot_tpu/ops/flash.py:_fwd_kernel (launched by
// _fwd_rows' pl.pallas_call), the TPU forward behind
// flash_attention_forward.
//
// What bounds it on the H100: at the serving shape (s = 1024, hd = 128)
// the bytes (q, k, v, out once: 5.0 us at 3.35 TB/s for 16 heads) and
// the causal FLOPs (4 * hd * s(s+1)/2 per head: 4.4 us at 989 TFLOP/s)
// give nearly the same least time; longer prompts make it
// operations-bound, since each K/V tile serves a whole 64-row q tile.
//
// What this simple design does about it: it keeps every intermediate
// on chip. One block owns one (batch*head row, 64-query tile); the
// TPU's sequential kv grid axis becomes a loop inside the block from
// the first kv tile the window needs to the diagonal tile, so nothing
// carries across blocks. Q (pre-scaled, float32, transposed) and each
// K (transposed) / V tile sit in shared memory; the running max m,
// running sum l and the 64 x hd output accumulator live in float32
// registers (4 rows x hd/16 columns per thread); scores never reach
// device memory. Inner products are plain float32 FMAs from shared
// memory (no tensor cores yet: wgmma/TMA are later work), so the
// kernel runs far below the tensor-core bound.
//
// Numerics copy the reference: scores from q * hd^-0.5 in float32, the
// _causal_mask with NEG_INF = -1e30 (not -inf), online softmax with
// p = exp(s - m_new), corr = exp(m_prev - m_new), l clamped at 1e-30,
// out = acc / l, lse = m + log(l). q row r = b*H + head reads kv head
// head / (H / KVH), the reference's r // group.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per kv tile
constexpr int NT = 256;       // threads: 16 row groups x 16 column groups
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ void bf16x8_to_f32(const uint4 raw, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// Shared memory (floats): QT[HD][BQ] + KT[HD][BK] + VS[BK][HD] + PT[BK][BQ]
template <int HD>
constexpr int smem_floats() {
  return HD * BQ + HD * BK + BK * HD + BK * BQ;
}

template <int HD>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                 int S, int H, int KVH, int window, float scale) {
  constexpr int DPT = HD / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* QT = smem;                 // [HD][BQ], q * scale, transposed
  float* KT = QT + HD * BQ;         // [HD][BK], transposed
  float* VS = KT + HD * BK;         // [BK][HD]
  float* PT = VS + BK * HD;         // [BK][BQ], probabilities transposed

  const int t = threadIdx.x;
  const int ty = t / 16;  // rows ty*4 .. ty*4+3 of the q tile
  const int tx = t % 16;  // score cols tx*4.., output cols tx*DPT..
  const int q_start = blockIdx.x * BQ;
  const int r = blockIdx.y;  // b * H + head
  const int b = r / H;
  const int head = r % H;
  const int kv_head = head / (H / KVH);
  const long q_row_stride = (long)H * HD;
  const long kv_row_stride = (long)KVH * HD;
  const __nv_bfloat16* qb = q + (long)b * S * q_row_stride + (long)head * HD;
  const __nv_bfloat16* kb = k + (long)b * S * kv_row_stride + (long)kv_head * HD;
  const __nv_bfloat16* vb = v + (long)b * S * kv_row_stride + (long)kv_head * HD;

  // Q tile -> QT (consecutive threads take consecutive rows, so the
  // transposed shared-memory writes do not conflict)
  for (int idx = t; idx < BQ * (HD / 8); idx += NT) {
    const int n = idx % BQ;
    const int dc = idx / BQ;
    const uint4 raw = *reinterpret_cast<const uint4*>(
        qb + (long)(q_start + n) * q_row_stride + dc * 8);
    float f[8];
    bf16x8_to_f32(raw, f);
#pragma unroll
    for (int i = 0; i < 8; ++i) QT[(dc * 8 + i) * BQ + n] = f[i] * scale;
  }

  float m[4], l[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
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
    __syncthreads();  // the previous tile's PV reads of VS/PT are done
    for (int idx = t; idx < BK * (HD / 8); idx += NT) {
      const int n = idx % BK;
      const int dc = idx / BK;
      const uint4 raw = *reinterpret_cast<const uint4*>(
          kb + (long)(k_start + n) * kv_row_stride + dc * 8);
      float f[8];
      bf16x8_to_f32(raw, f);
#pragma unroll
      for (int i = 0; i < 8; ++i) KT[(dc * 8 + i) * BK + n] = f[i];
    }
    for (int idx = t; idx < BK * (HD / 8); idx += NT) {
      const int dc = idx % (HD / 8);
      const int n = idx / (HD / 8);
      const uint4 raw = *reinterpret_cast<const uint4*>(
          vb + (long)(k_start + n) * kv_row_stride + dc * 8);
      float f[8];
      bf16x8_to_f32(raw, f);
      float4* dst = reinterpret_cast<float4*>(VS + n * HD + dc * 8);
      dst[0] = make_float4(f[0], f[1], f[2], f[3]);
      dst[1] = make_float4(f[4], f[5], f[6], f[7]);
    }
    __syncthreads();

    // scores s[i][j] for rows ty*4+i, keys tx*4+j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(QT + d * BQ + ty * 4);
      const float4 kv = *reinterpret_cast<const float4*>(KT + d * BK + tx * 4);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
      const float ka[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
    }

    // mask, online softmax update (rows are shared by the 16 lanes with
    // the same ty: lanes 0-15 or 16-31 of a warp)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q_pos = q_start + ty * 4 + i;
      float row_max = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k_pos = k_start + tx * 4 + j;
        bool ok = q_pos >= k_pos;
        if (window > 0) ok = ok && (q_pos - k_pos < window);
        if (!ok) s[i][j] = NEG_INF;
        row_max = fmaxf(row_max, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off >= 1; off >>= 1)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
      const float m_new = fmaxf(m[i], row_max);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        row_sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off >= 1; off >>= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
      const float corr = expf(m[i] - m_new);
      m[i] = m_new;
      l[i] = l[i] * corr + row_sum;
#pragma unroll
      for (int d = 0; d < DPT; ++d) acc[i][d] *= corr;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<float4*>(PT + (tx * 4 + j) * BQ + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    __syncthreads();

    // acc += P @ V
#pragma unroll 4
    for (int n = 0; n < BK; ++n) {
      const float4 pv = *reinterpret_cast<const float4*>(PT + n * BQ + ty * 4);
      const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
      float va[DPT];
#pragma unroll
      for (int d4 = 0; d4 < DPT / 4; ++d4) {
        const float4 vv =
            *reinterpret_cast<const float4*>(VS + n * HD + tx * DPT + d4 * 4);
        va[d4 * 4 + 0] = vv.x;
        va[d4 * 4 + 1] = vv.y;
        va[d4 * 4 + 2] = vv.z;
        va[d4 * 4 + 3] = vv.w;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int d = 0; d < DPT; ++d) acc[i][d] = fmaf(pa[i], va[d], acc[i][d]);
    }
  }

  // finalize: out = acc / max(l, 1e-30), lse = m + log(l)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q_pos = q_start + ty * 4 + i;
    const float li = fmaxf(l[i], 1e-30f);
    __nv_bfloat16* orow =
        out + ((long)b * S + q_pos) * q_row_stride + (long)head * HD + tx * DPT;
#pragma unroll
    for (int d = 0; d < DPT; d += 2) {
      *reinterpret_cast<__nv_bfloat162*>(orow + d) =
          __floats2bfloat162_rn(acc[i][d] / li, acc[i][d + 1] / li);
    }
    if (tx == 0) lse[(long)r * S + q_pos] = m[i] + logf(li);
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, int B, int S, int H, int KVH, int window,
                   float scale, cudaStream_t stream) {
  const int smem = smem_floats<HD>() * (int)sizeof(float);
  static bool configured = false;  // the attribute is per function
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  dim3 grid(S / BQ, B * H);
  flash_fwd_kernel<HD><<<grid, NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), S, H, KVH, window, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, out: [B, S, H, HD] bf16; k, v: [B, S, KVH, HD] bf16 (contiguous);
// lse: [B*H, S] float32. S % 64 == 0, H % KVH == 0, HD in {64, 128}.
// Returns the launch's cudaError_t (0 on success).
int flash_fwd_bf16(const void* q, const void* k, const void* v, void* out,
                   void* lse, int B, int S, int H, int KVH, int HD,
                   int window, float scale, void* stream) {
  if (S % BQ != 0 || KVH < 1 || H % KVH != 0) return (int)cudaErrorInvalidValue;
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
