// One thread writes the card's %globaltimer (ns) into a slot of a buffer.
//
// Replaces no TPU kernel: it times parts of a step from inside a CUDA
// graph. A timing event recorded inside a graph is re-recorded by the
// next replay, which at pipeline depth 2 is launched before the host has
// read the last one; a stamp is written into a buffer that the step
// returns with its outputs (ops/stamp.py), so each replay's stamps are
// read with its own results, whatever replays came after it.
//
// What bounds it: nothing it computes. One 8-byte store; its time is a
// launch's (a few us inside a graph). Stream order puts the stamp after
// every kernel enqueued before it and before every kernel enqueued after
// it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void stamp_kernel(uint64_t* out, int i) {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  out[i] = t;
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns the CUDA error (0 = ok).
int stamp_launch(void* out, int i, void* stream) {
  stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint64_t*>(out), i);
  return (int)cudaGetLastError();
}

}  // extern "C"
