// Standalone frame deblock for Hopper (sm_90a): the row wavefront of
// deblock_wavefront.cuh over one picture's PAD-padded int32 planes.
//
// Replaces the Pallas TPU kernel deblock_frame_pl / _kernel of
// hartallo_tpu/ops/deblock_pallas.py.  The Mosaic layout of that kernel
// (edge-major tiles, the skew and the row/column transposes, the lane
// shifts) was a TPU register-layout device and is not carried over: the
// kernel filters the natural planes in place.  Its parameters are the
// per-MB `aux` rows of hartallo_tpu_torch/ops/deblock.edge_params (the
// pre-gather of _edge_params), as int16.
//
// What bounds it on the H100: bytes (the planes read and written once,
// about 13.6 MB a 720p frame with aux, 4 us); the design that meets
// latency instead (one warp per MB row, a lag of two MBs between rows,
// each MB filtered in shared memory) is described in
// deblock_wavefront.cuh.
#include <cstdint>
#include <cuda_runtime.h>

#include "deblock_wavefront.cuh"

// Plain C entry point (loaded with ctypes).  aux (gh, gw, NAUX) int16,
// the planes Y (16 gh + 64, 16 gw + 64), U and V (8 gh + 64, 8 gw + 64)
// int32 and prog (gh zeroed ints) are device memory the caller allocated
// and checked; the planes are filtered in place.  Returns 0 or the CUDA
// error code of the launch.
extern "C" int hl_deblock_frame(const int16_t* aux, int32_t* py, int32_t* pu,
                                int32_t* pv, int* prog, int gw, int gh,
                                cudaStream_t stream) {
  return (int)hl::launch_deblock(aux, py, pu, pv, prog, gw, gh, stream);
}
