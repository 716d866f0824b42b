"""Device ops in PyTorch (transforms, quant, intra, deblock, CDEF, ME,
MC) and the CUDA tile gather — each a batched function over all blocks
of a frame, on the tensors' device."""
