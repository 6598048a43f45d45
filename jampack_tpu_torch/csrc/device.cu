// The library's current device, set before each launch.
//
// The kernels are linked against a static CUDA runtime of their own, whose
// current device is not PyTorch's: it starts at device 0 in every host
// thread.  Kernel.launch (kernels/_build.py) calls jt_set_device with the
// index of the tensors' card before it enqueues, so that a launch lands on
// the card that holds its stream and buffers.  The setting is per host
// thread, as the runtime keeps it.
#include "common.cuh"

JT_EXPORT int jt_set_device(int device) {
  return static_cast<int>(cudaSetDevice(device));
}
