"""Host-side pieces of the codec stages that the port needs: chunk-header
and LZ-token framing, and the float64 filter spec scorers.  Copies of the
numpy code in jampack_tpu/stages/."""
