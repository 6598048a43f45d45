"""The spec stages of the codec, in Python and numpy: copies of
jampack_tpu/stages/ (ans, bwt, filters, lpx, lz77, lz77_mf, models, rank,
rans, rle0), held byte for byte equal to their originals by
tests/test_torch_standalone.py.  The spec engine (runtime/pipeline.Engine)
runs them; the per-stage GPU engine inherits the ones the JAX per-stage
engine inherits."""
