"""The byte format the port reads and writes: constants, coder tables,
varints, the block checksum and the block framing.  Copies of
jampack_tpu/format/ (numpy only), so that the port imports nothing of the
JAX package; tests/test_torch_standalone.py holds each copy equal to its
original."""
