"""jampack_tpu_torch: the PyTorch/CUDA port of the jampack_tpu block codec.

Decodes JAM, JTX and JT3 block archives and encodes them (-m0..-m3,
-f0/-f1/-f2, any Lpx span count, -Sa) on an NVIDIA H100.  The serial loops
and the histogram of the chains are CUDA kernels written by hand for
sm_90a (csrc/); the LZ match finders of -m0/-m1/-m2 run on the host
(native/, a copy of the native engine's C++ built by g++); the rest is
plain PyTorch.  The package stands alone: it imports torch and numpy,
never jax and never jampack_tpu, and keeps its own copies of the format
(format/), the options record (runtime/options.py), the host-side stage
framing (stages/) and the LZ sources (native/src/).  jampack_tpu stays the reference this
package is held against in the tests.
"""

__version__ = "0.1.0"
