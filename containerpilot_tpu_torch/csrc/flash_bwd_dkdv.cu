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
// bytes, so it is operations-bound.
//
// What this simple design does about it: one block owns one (batch*head
// row, 64-key tile); the TPU's sequential q grid axis becomes a loop
// inside the block from the diagonal q tile up to the last query the
// window lets see this key tile, so dk and dv (2 x 64 x hd float32, 4
// keys x hd/16 columns each per thread) accumulate in registers and are
// written once. Nothing carries across blocks and nothing is atomic: the
// TPU's two-kernel split (dq in K3, dk/dv here) is kept, so all three
// gradients are deterministic run to run. K and V sit transposed in
// shared memory for the whole block; each q tile brings q (pre-scaled)
// and dO both transposed (for the k.q^T and v.dO^T products) and
// row-major (for p^T.dO and ds^T.q), plus its 64 lse and D values. The
// 64 x 64 p tile, then the ds tile, pass through one shared buffer;
// neither reaches device memory. Inner products are plain float32 FMAs
// from shared memory (no tensor cores yet).
//
// Numerics copy the reference: s = (q * hd^-0.5) . k in float32,
// p = exp(s - lse) where the _causal_mask keeps the pair and exactly 0
// where it does not, dv = sum p^T dO, ds = p * (dO . v - D),
// dk = sum ds^T (q * hd^-0.5). Queries fully masked for this key tile
// add exact zeros.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;   // queries per q tile
constexpr int BK = 64;   // keys per block
constexpr int NT = 256;  // threads: 16 key groups x 16 column groups

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
// memory twice: transposed, dst_t[d * 64 + n], and (when dst is not
// null) row-major, dst[n * HD + d]; both times multiplied by mul.
template <int HD>
__device__ __forceinline__ void load_tile(const __nv_bfloat16* src, long stride,
                                          float* dst_t, float* dst, float mul) {
  for (int idx = threadIdx.x; idx < 64 * (HD / 8); idx += NT) {
    const int n = idx % 64;
    const int dc = idx / 64;
    const uint4 raw = *reinterpret_cast<const uint4*>(src + n * stride + dc * 8);
    float f[8];
    bf16x8_to_f32(raw, f);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      f[i] *= mul;
      dst_t[(dc * 8 + i) * 64 + n] = f[i];
    }
    if (dst != nullptr) {
      float4* out = reinterpret_cast<float4*>(dst + n * HD + dc * 8);
      out[0] = make_float4(f[0], f[1], f[2], f[3]);
      out[1] = make_float4(f[4], f[5], f[6], f[7]);
    }
  }
}

// Shared memory (floats): KT, VT [HD][BK]; QT, dOT [HD][BQ]; QS, dOS
// [BQ][HD]; PS [BQ][BK] (p, then ds); LSE, DD [BQ]
template <int HD>
constexpr int smem_floats() {
  return 2 * HD * BK + 4 * HD * BQ + BQ * BK + 2 * BQ;
}

template <int HD>
__global__ void __launch_bounds__(NT)
flash_bwd_dkdv_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const __nv_bfloat16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, int S, int H, int window,
                      float scale) {
  constexpr int DPT = HD / 16;  // dk/dv columns per thread
  extern __shared__ float smem[];
  float* KT = smem;              // [HD][BK]
  float* VT = KT + HD * BK;      // [HD][BK]
  float* QT = VT + HD * BK;      // [HD][BQ], q * scale
  float* dOT = QT + HD * BQ;     // [HD][BQ]
  float* QS = dOT + HD * BQ;     // [BQ][HD], q * scale
  float* dOS = QS + BQ * HD;     // [BQ][HD]
  float* PS = dOS + BQ * HD;     // [BQ][BK]: p, then ds
  float* LSE = PS + BQ * BK;     // [BQ]
  float* DD = LSE + BQ;          // [BQ]

  const int t = threadIdx.x;
  const int ty = t / 16;  // keys ty*4 .. ty*4+3 of the tile
  const int tx = t % 16;  // score queries tx*4.., dk/dv cols tx*DPT..
  const int k_start = blockIdx.x * BK;
  const int r = blockIdx.y;  // b * H + head
  const int b = r / H;
  const int head = r % H;
  const long row_stride = (long)H * HD;
  const long base = (long)b * S * row_stride + (long)head * HD;

  load_tile<HD>(k + base + k_start * row_stride, row_stride, KT, nullptr, 1.f);
  load_tile<HD>(v + base + k_start * row_stride, row_stride, VT, nullptr, 1.f);

  float dk_acc[4][DPT], dv_acc[4][DPT];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int d = 0; d < DPT; ++d) {
      dk_acc[j][d] = 0.f;
      dv_acc[j][d] = 0.f;
    }

  // queries that can see keys [k_start, k_start + BK): the diagonal up to
  // the newest key + window - 1 (the whole tail without a window)
  int last_query = S - 1;
  if (window > 0) {
    const int newest = k_start + BK - 1 + window - 1;
    if (newest < last_query) last_query = newest;
  }
  const int qt_first = k_start / BQ;
  const int qt_last = last_query / BQ;

  for (int qt = qt_first; qt <= qt_last; ++qt) {
    const int q_start = qt * BQ;
    __syncthreads();  // the previous tile's reads of QS/dOS/PS are done
    load_tile<HD>(q + base + q_start * row_stride, row_stride, QT, QS, scale);
    load_tile<HD>(dout + base + q_start * row_stride, row_stride, dOT, dOS, 1.f);
    if (t < BQ) {
      LSE[t] = lse[(long)r * S + q_start + t];
    } else if (t < 2 * BQ) {
      DD[t - BQ] = delta[(long)r * S + q_start + t - BQ];
    }
    __syncthreads();

    // s[j][i] = k.q and dp[j][i] = v.dO for keys ty*4+j, queries tx*4+i
    float s[4][4], dp[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[j][i] = 0.f;
        dp[j][i] = 0.f;
      }
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      const float4 kv = *reinterpret_cast<const float4*>(KT + d * BK + ty * 4);
      const float4 vv = *reinterpret_cast<const float4*>(VT + d * BK + ty * 4);
      const float4 qv = *reinterpret_cast<const float4*>(QT + d * BQ + tx * 4);
      const float4 ov = *reinterpret_cast<const float4*>(dOT + d * BQ + tx * 4);
      const float ka[4] = {kv.x, kv.y, kv.z, kv.w};
      const float va[4] = {vv.x, vv.y, vv.z, vv.w};
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
      const float oa[4] = {ov.x, ov.y, ov.z, ov.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[j][i] = fmaf(ka[j], qa[i], s[j][i]);
          dp[j][i] = fmaf(va[j], oa[i], dp[j][i]);
        }
    }

    // p = where(mask, exp(s - lse), 0) -> PS[query][key]; ds kept in dp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = tx * 4 + i;
      const int q_pos = q_start + qi;
      const float lse_i = LSE[qi];
      const float d_i = DD[qi];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k_pos = k_start + ty * 4 + j;
        bool ok = q_pos >= k_pos;
        if (window > 0) ok = ok && (q_pos - k_pos < window);
        const float p = ok ? expf(s[j][i] - lse_i) : 0.f;
        s[j][i] = p;
        dp[j][i] = p * (dp[j][i] - d_i);
      }
      *reinterpret_cast<float4*>(PS + qi * BK + ty * 4) =
          make_float4(s[0][i], s[1][i], s[2][i], s[3][i]);
    }
    __syncthreads();

    // dv += p^T @ dO
#pragma unroll 4
    for (int n = 0; n < BQ; ++n) {
      const float4 p4 = *reinterpret_cast<const float4*>(PS + n * BK + ty * 4);
      const float pa[4] = {p4.x, p4.y, p4.z, p4.w};
      float oa[DPT];
#pragma unroll
      for (int d4 = 0; d4 < DPT / 4; ++d4) {
        const float4 o4 =
            *reinterpret_cast<const float4*>(dOS + n * HD + tx * DPT + d4 * 4);
        oa[d4 * 4 + 0] = o4.x;
        oa[d4 * 4 + 1] = o4.y;
        oa[d4 * 4 + 2] = o4.z;
        oa[d4 * 4 + 3] = o4.w;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int d = 0; d < DPT; ++d)
          dv_acc[j][d] = fmaf(pa[j], oa[d], dv_acc[j][d]);
    }
    __syncthreads();  // every thread is done reading p

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      *reinterpret_cast<float4*>(PS + (tx * 4 + i) * BK + ty * 4) =
          make_float4(dp[0][i], dp[1][i], dp[2][i], dp[3][i]);
    }
    __syncthreads();

    // dk += ds^T @ (q * scale)
#pragma unroll 4
    for (int n = 0; n < BQ; ++n) {
      const float4 d4v = *reinterpret_cast<const float4*>(PS + n * BK + ty * 4);
      const float da[4] = {d4v.x, d4v.y, d4v.z, d4v.w};
      float qa[DPT];
#pragma unroll
      for (int d4 = 0; d4 < DPT / 4; ++d4) {
        const float4 q4 =
            *reinterpret_cast<const float4*>(QS + n * HD + tx * DPT + d4 * 4);
        qa[d4 * 4 + 0] = q4.x;
        qa[d4 * 4 + 1] = q4.y;
        qa[d4 * 4 + 2] = q4.z;
        qa[d4 * 4 + 3] = q4.w;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int d = 0; d < DPT; ++d)
          dk_acc[j][d] = fmaf(da[j], qa[d], dk_acc[j][d]);
    }
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const long off = base + (long)(k_start + ty * 4 + j) * row_stride + tx * DPT;
#pragma unroll
    for (int d = 0; d < DPT; d += 2) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + d) =
          __floats2bfloat162_rn(dk_acc[j][d], dk_acc[j][d + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + d) =
          __floats2bfloat162_rn(dv_acc[j][d], dv_acc[j][d + 1]);
    }
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dk, void* dv,
                   int B, int S, int H, int window, float scale,
                   cudaStream_t stream) {
  const int smem = smem_floats<HD>() * (int)sizeof(float);
  static bool configured = false;  // the attribute is per function
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkdv_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  dim3 grid(S / BK, B * H);
  flash_bwd_dkdv_kernel<HD><<<grid, NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), S, H, window, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, dout, dk, dv: [B, S, H, HD] bf16 (contiguous, full heads);
// lse, delta: [B*H, S] float32. S % 64 == 0, HD in {64, 128}, window >= 0
// (0 = full causal). Returns the launch's cudaError_t (0 on success).
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
