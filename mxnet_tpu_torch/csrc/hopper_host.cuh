// Host-side helpers of the Hopper kernels of this package: the TMA tensor
// maps the wgmma kernels read their tiles through (hopper_wgmma.cuh), and
// a kernel's dynamic shared-memory limit.
//
// A tensor map is encoded on the host for each call and passed to the
// kernel by value as a __grid_constant__ parameter, so a CUDA graph that
// captures the launch keeps it.  cuTensorMapEncodeTiled belongs to the
// CUDA driver API; it is reached through the runtime's
// cudaGetDriverEntryPoint, so that a library links against the runtime
// alone.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

namespace hhost {

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline cudaError_t encode_tiled(EncodeTiled* out) {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* sym = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &sym, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &sym, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || sym == nullptr)
      return cudaErrorSymbolNotFound;
    fn = reinterpret_cast<EncodeTiled>(sym);
  }
  *out = fn;
  return cudaSuccess;
}

// the map of a bf16 [bh][rows][d] tensor read in boxes of ``box_rows`` rows
// of ``box_cols`` columns, swizzled at the box's row width
inline CUresult encode_bf16(EncodeTiled fn, CUtensorMap* map,
                            const void* base, int bh, int rows, int d,
                            int box_cols, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows,
                              (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2,
                                 (cuuint64_t)rows * d * 2};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const int row_bytes = box_cols * 2;
  const CUtensorMapSwizzle swizzle =
      row_bytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
      : row_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                        : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// the map of an fp32 [bh][rows][d] tensor read in boxes of ``box_rows``
// rows of ``box_cols`` columns, swizzled at the box's row width: 32
// columns (128 bytes) a box at d >= 32, so d = 64 is read as two column
// blocks and d = 128 as four; 16 columns (64 bytes) at d = 16.  fp32 K1
// reads its Q, K and V tiles through these and splits them into TF32
// parts in shared memory.
inline CUresult encode_f32(EncodeTiled fn, CUtensorMap* map, const void* base,
                           int bh, int rows, int d, int box_cols,
                           int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows,
                              (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 4,
                                 (cuuint64_t)rows * d * 4};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle = box_cols == 32
                                         ? CU_TENSOR_MAP_SWIZZLE_128B
                                         : CU_TENSOR_MAP_SWIZZLE_64B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(base),
            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// the rank-1 map of ``n`` fp32 values read in boxes of ``box`` values (a
// multiple of 4: 16 bytes), unswizzled
inline CUresult encode_f32_rows(EncodeTiled fn, CUtensorMap* map,
                                const void* base, long long n, int box) {
  const cuuint64_t dims[1] = {(cuuint64_t)n};
  // a rank-1 map reads no stride; a valid array all the same
  const cuuint64_t strides[1] = {((cuuint64_t)n * 4 + 15) / 16 * 16};
  const cuuint32_t boxes[1] = {(cuuint32_t)box};
  const cuuint32_t step[1] = {1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<void*>(base),
            dims, strides, boxes, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// raises a kernel's dynamic shared-memory limit once per device (``raised``
// is the kernel's own): at BERT's seq 128 the call's host time is the
// kernel's time
template <typename K>
cudaError_t allow_smem(K kernel, int smem, bool (&raised)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64 || !raised[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    if (dev >= 0 && dev < 64) raised[dev] = true;
  }
  return cudaSuccess;
}

}  // namespace hhost
