"""Host-side entropy coding (copy of svt_av1_tpu.entropy): range coder, CDF model, symbol layer, OBU mux.

The reference runs these in the EntropyCoding/Packetization pipeline stages
(EbEntropyCodingProcess.c, EbPacketizationProcess.c).  In the TPU build they
are a host stage fed by device-computed coefficient/mode planes, tile-
parallel across host cores (AV1 tiles are entropy-independent).
"""
