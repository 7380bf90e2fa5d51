"""HDC audio: the host codec (numpy copies of the reference package's
parse, filterbank and SBR) and the batched HDC -> PCM decoder, whose
device stage runs on four hand-written CUDA kernels."""
