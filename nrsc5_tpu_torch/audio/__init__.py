"""HDC audio: the host codec (numpy copies of the reference package's
parse, filterbank and SBR; the parse native where the host library is
built), the batched HDC -> PCM decoder, whose device stage runs on four
hand-written CUDA kernels, and the fleet decoder on a receiver's events
(``fleet.FleetAudioDecoder``)."""
