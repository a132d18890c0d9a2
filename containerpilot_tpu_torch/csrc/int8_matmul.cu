// Weight-only int8 dequant GEMM: out[m, n] = (x[m, k] @ w_q[k, n]) *
// scales[n], x and out bf16, w_q int8, scales float32. Kernel K2 of the
// port.
//
// Replaces: containerpilot_tpu/ops/quant.py:_int8_matmul_kernel
// (launched by int8_matmul_pallas' pl.pallas_call, reached through
// int8_matmul_padded), the TPU kernel behind every decode projection of
// an --int8 model.
//
// What bounds it on the H100: bytes. In decode m is the batch (1 to 16
// rows), so each weight byte is used m times: the least time is the
// int8 weight matrix (k * n bytes) over the 3.35 TB/s of device memory.
//
// What this simple design does about it: weights are read exactly once
// from device memory per 4 rows of x, as int8, 16 bytes (16 columns) per
// thread per load, and upcast to float32 in registers (device memory
// never sees a dequantized weight). Each block owns a strip of 16 output
// columns and loops over all of k, its 256 threads taking interleaved
// rows of k; the strip is narrow so that even n = 2048 gives 128 blocks
// for the 132 SMs. Up to 4 rows of x (1 when m is 1) are staged in
// shared memory as bf16; larger m loops over 4-row chunks (later chunks re-read the
// strip, from L2 in practice). Partial sums are reduced with warp
// shuffles, then across the 8 warps in shared memory; the column scale
// multiplies once at the end, as in the reference, and the result is
// rounded to bf16 once. Any m from 1 to 256, no padding.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;   // threads per block, all along k
constexpr int COLS = 16;  // output columns per block (16 int8 = 16 bytes)
constexpr int MT_MAX = 4; // rows of x per pass (1 when m == 1)

__device__ __forceinline__ float byte_at(uint32_t word, int i) {
  return static_cast<float>(static_cast<int8_t>((word >> (8 * i)) & 0xffu));
}

template <int MT>
__global__ void __launch_bounds__(NT)
int8_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                   const int8_t* __restrict__ w,
                   const float* __restrict__ scales,
                   __nv_bfloat16* __restrict__ out, int m, int k, int n) {
  extern __shared__ unsigned char smem_raw[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [MT][k]
  __shared__ float red[NT / 32][MT * COLS];

  const int t = threadIdx.x;
  const int lane = t % 32;
  const int warp = t / 32;
  const int col0 = blockIdx.x * COLS;

  for (int m0 = 0; m0 < m; m0 += MT) {
    const int rows = min(MT, m - m0);
    __syncthreads();  // the previous pass is done with xs and red
    for (int idx = t; idx < MT * k; idx += NT) {
      const int i = idx / k;
      const int kk = idx % k;
      xs[idx] = i < rows ? x[(long)(m0 + i) * k + kk] : __float2bfloat16(0.f);
    }
    __syncthreads();

    float acc[MT][COLS];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int c = 0; c < COLS; ++c) acc[i][c] = 0.f;

#pragma unroll 4
    for (int kk = t; kk < k; kk += NT) {
      const uint4 raw =
          *reinterpret_cast<const uint4*>(w + (long)kk * n + col0);
      const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
      float wf[COLS];
#pragma unroll
      for (int c = 0; c < COLS; ++c) wf[c] = byte_at(words[c / 4], c % 4);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const float xv = __bfloat162float(xs[i * k + kk]);
#pragma unroll
        for (int c = 0; c < COLS; ++c) acc[i][c] = fmaf(xv, wf[c], acc[i][c]);
      }
    }

#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        float vsum = acc[i][c];
#pragma unroll
        for (int off = 16; off >= 1; off >>= 1)
          vsum += __shfl_xor_sync(0xffffffffu, vsum, off);
        if (lane == 0) red[warp][i * COLS + c] = vsum;
      }
    __syncthreads();
    if (t < MT * COLS) {
      const int i = t / COLS;
      const int c = t % COLS;
      if (i < rows) {
        float total = 0.f;
#pragma unroll
        for (int wp = 0; wp < NT / 32; ++wp) total += red[wp][t];
        out[(long)(m0 + i) * n + col0 + c] =
            __float2bfloat16(total * scales[col0 + c]);
      }
    }
  }
}

template <int MT>
cudaError_t launch(const void* x, const void* w_q, const void* scales,
                   void* out, int m, int k, int n, void* stream) {
  const int smem = MT * k * (int)sizeof(__nv_bfloat16);
  static int configured = 0;  // largest dynamic smem allowed so far
  if (smem > configured) {
    cudaError_t err = cudaFuncSetAttribute(
        int8_matmul_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    configured = smem;
  }
  int8_matmul_kernel<MT><<<n / COLS, NT, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w_q),
      static_cast<const float*>(scales), static_cast<__nv_bfloat16*>(out), m,
      k, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: [m, k] bf16, w_q: [k, n] int8, scales: [n] float32, out: [m, n]
// bf16, all contiguous; 1 <= m, n % 16 == 0. Returns the launch's
// cudaError_t (0 on success).
int int8_matmul_bf16(const void* x, const void* w_q, const void* scales,
                     void* out, int m, int k, int n, void* stream) {
  if (m < 1 || k < 1 || n % COLS != 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = m == 1 ? launch<1>(x, w_q, scales, out, m, k, n, stream)
                           : launch<MT_MAX>(x, w_q, scales, out, m, k, n, stream);
  return (int)err;
}

const char* int8_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
