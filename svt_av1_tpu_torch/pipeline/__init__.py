"""Frame encode orchestration: intra wavefront (intra_encoder), P-frame
step (inter_encoder), host entropy tiles (tile), the Encoder."""
