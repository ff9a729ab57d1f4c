// LSTM time recurrence, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel dotaclient_tpu/ops/lstm.py::_lstm_kernel
// (launched by _pallas_forward, pl.pallas_call at ops/lstm.py:138).
// Computes, for every batch row b and step t (gates i, f, g, o are the
// four H-wide column blocks of z):
//
//     z_t = x_proj[b, t] + rnd(h_{t-1}) @ W_h          (f32 accumulation)
//     c_t = sigmoid(f + 1) * c_{t-1} + sigmoid(i) * tanh(g)
//     h_t = sigmoid(o) * tanh(c_t)
//
// where rnd() rounds h to the compute dtype of W_h (bf16 in the flagship
// policy, identity for f32). Writes h_seq and c_seq [B, T, H] f32 (c_seq
// is what the recompute backward will need) and the final c_T, h_T [B, H].
// Layout is the port's public [B, T, ...]; the TPU kernel's time-major
// transpose is not carried over.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16): at the learner's
// flagship shape B=256, T=17, H=128 in bf16 the call must move ~9.6 MB
// (x_proj 4.46 MB in, h_seq + c_seq 2 x 2.23 MB out, W_h 0.13 MB, carries
// 0.52 MB), ~2.9 us at the memory rate; its 0.57 GFLOP take ~0.6 us on the
// tensor cores. So the floor is memory, and the 17 dependent steps make
// latency the real limit: every step needs the whole previous h of its
// row. In f32 the same products are 0.57 GFLOP at 67 TFLOP/s (~8.5 us), so
// there the floor is arithmetic.
//
// Design: one CTA per slab of `rows` batch rows runs the whole time loop.
// - W_h lives in dynamic shared memory for the whole launch when it fits
//   (bf16 at H=128: 128 KiB); otherwise (f32 at H=128 is 256 KiB, over
//   the 227 KB a block may use) the dot loop reads it from global memory,
//   where the L1/L2 caches hold it after the first step.
// - Thread (j, r) owns hidden unit j of slab row r and computes the four
//   dot products for columns j, H+j, 2H+j, 3H+j, so the gate tail needs
//   no exchange between threads; c stays in a register.
// - h, rounded to the compute dtype, is double-buffered in shared memory
//   so every thread of the row sees the whole previous h; one barrier per
//   step separates a step's reads from the next step's writes.
// Loads of x_proj and stores of h_seq/c_seq are coalesced along j.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) { return __float2bfloat16_rn(v); }

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

template <typename T, bool W_SMEM>
__global__ void lstm_fwd_kernel(const T* __restrict__ xp, const T* __restrict__ wh,
                                const float* __restrict__ c0, const float* __restrict__ h0,
                                float* __restrict__ hseq, float* __restrict__ cseq,
                                float* __restrict__ cT, float* __restrict__ hT, int B, int T_steps,
                                int H) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int H4 = 4 * H;
    const int R = blockDim.y;
    const int j = threadIdx.x;
    const int r = threadIdx.y;
    const int b = blockIdx.x * R + r;
    const bool live = b < B;
    const size_t w_bytes = W_SMEM ? (size_t)H * H4 * sizeof(T) : 0;
    T* h_s = reinterpret_cast<T*>(smem + w_bytes);  // [2][R][H]

    const T* w = wh;
    if (W_SMEM) {
        T* w_s = reinterpret_cast<T*>(smem);
        const int tid = r * H + j;
        const int nthreads = R * H;
        // 16-byte vector copy when W_h is 16-byte aligned, scalar tail/else
        const size_t n16 = (reinterpret_cast<uintptr_t>(wh) % 16 == 0) ? w_bytes / 16 : 0;
        const int4* src = reinterpret_cast<const int4*>(wh);
        int4* dst = reinterpret_cast<int4*>(w_s);
        for (size_t i = tid; i < n16; i += nthreads) dst[i] = src[i];
        const size_t n = (size_t)H * H4;
        for (size_t i = n16 * 16 / sizeof(T) + tid; i < n; i += nthreads) w_s[i] = wh[i];
        w = w_s;
    }

    float c = live ? c0[(size_t)b * H + j] : 0.0f;
    float h = live ? h0[(size_t)b * H + j] : 0.0f;
    h_s[r * H + j] = from_f32<T>(h);
    __syncthreads();

    for (int t = 0; t < T_steps; ++t) {
        float x0 = 0.0f, x1 = 0.0f, x2 = 0.0f, x3 = 0.0f;
        if (live) {
            const T* xr = xp + ((size_t)b * T_steps + t) * H4;
            x0 = to_f32(xr[j]);
            x1 = to_f32(xr[H + j]);
            x2 = to_f32(xr[2 * H + j]);
            x3 = to_f32(xr[3 * H + j]);
        }
        const T* hp = h_s + (t & 1) * R * H + r * H;
        float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll 4
        for (int k = 0; k < H; ++k) {
            const float hk = to_f32(hp[k]);
            const T* wr = w + (size_t)k * H4 + j;
            a0 = fmaf(hk, to_f32(wr[0]), a0);
            a1 = fmaf(hk, to_f32(wr[H]), a1);
            a2 = fmaf(hk, to_f32(wr[2 * H]), a2);
            a3 = fmaf(hk, to_f32(wr[3 * H]), a3);
        }
        const float ig = sigmoid(x0 + a0);
        const float fg = sigmoid((x1 + a1) + 1.0f);
        const float gg = tanhf(x2 + a2);
        const float og = sigmoid(x3 + a3);
        c = fg * c + ig * gg;
        h = og * tanhf(c);
        if (live) {
            const size_t o = ((size_t)b * T_steps + t) * H + j;
            hseq[o] = h;
            cseq[o] = c;
        }
        h_s[((t + 1) & 1) * R * H + r * H + j] = from_f32<T>(h);
        __syncthreads();
    }
    if (live) {
        cT[(size_t)b * H + j] = c;
        hT[(size_t)b * H + j] = h;
    }
}

template <typename T, bool W_SMEM>
cudaError_t launch(const void* xp, const void* wh, const void* c0, const void* h0, void* hseq,
                   void* cseq, void* cT, void* hT, int B, int T_steps, int H, int rows,
                   size_t smem, cudaStream_t stream) {
    auto kernel = lstm_fwd_kernel<T, W_SMEM>;
    if (smem > 48 * 1024) {
        cudaError_t e =
            cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return e;
    }
    dim3 block(H, rows);
    dim3 grid((B + rows - 1) / rows);
    kernel<<<grid, block, smem, stream>>>(
        static_cast<const T*>(xp), static_cast<const T*>(wh), static_cast<const float*>(c0),
        static_cast<const float*>(h0), static_cast<float*>(hseq), static_cast<float*>(cseq),
        static_cast<float*>(cT), static_cast<float*>(hT), B, T_steps, H);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x_proj and w_h share it). Returns a
// cudaError_t: 0 on a successful launch. Launches on `stream`, does not
// synchronise and allocates nothing.
int lstm_recurrence_fwd(const void* xp, const void* wh, const void* c0, const void* h0, void* hseq,
                        void* cseq, void* cT, void* hT, int B, int T_steps, int H, int dtype,
                        int rows, void* stream) {
    if (B <= 0 || T_steps < 0 || H <= 0 || rows <= 0 || rows * H > 1024 || (dtype != 0 && dtype != 1))
        return (int)cudaErrorInvalidValue;
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    int optin = 0;
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return (int)e;
    const size_t elt = dtype == 1 ? 2 : 4;
    const size_t h_bytes = 2 * (size_t)rows * H * elt;
    const size_t w_bytes = (size_t)H * 4 * H * elt;
    const bool w_smem = w_bytes + h_bytes <= (size_t)optin;
    const size_t smem = (w_smem ? w_bytes : 0) + h_bytes;
    if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 1) {
        return (int)(w_smem ? launch<__nv_bfloat16, true>(xp, wh, c0, h0, hseq, cseq, cT, hT, B, T_steps, H, rows, smem, s)
                            : launch<__nv_bfloat16, false>(xp, wh, c0, h0, hseq, cseq, cT, hT, B, T_steps, H, rows, smem, s));
    }
    return (int)(w_smem ? launch<float, true>(xp, wh, c0, h0, hseq, cseq, cT, hT, B, T_steps, H, rows, smem, s)
                        : launch<float, false>(xp, wh, c0, h0, hseq, cseq, cT, hT, B, T_steps, H, rows, smem, s));
}

const char* lstm_recurrence_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
