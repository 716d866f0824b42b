"""Command-line apps of the port (counterpart of svt_av1_tpu.app: ref
Source/App SvtAv1EncApp).  Only the encoder is ported so far."""
