"""PyTorch + CUDA port of the nrsc5_tpu FM and AM receive chains.

The JAX package ``nrsc5_tpu`` is the reference and stays untouched; this
package imports nothing of it and nothing of JAX.  Its layout mirrors the
reference (``ops/``, ``pipeline/``, ``serve.py``, ``tx/``) so each function
has an obvious counterpart.  The FM chain runs from the cu8 wire to
decoded P1/PIDS/PX bits (:func:`nrsc5_tpu_torch.serve.chain_step`, after
:func:`nrsc5_tpu_torch.serve.cold_start`), the AM chain from the cs16 wire
to P1/P3/PIDS bits (:func:`nrsc5_tpu_torch.serve.chain_step_am`); their
device functions are hand-written CUDA kernels for Hopper (``csrc/``),
each beside a plain PyTorch version of the same function.

Entry points take ``device=`` and default to ``"cuda"``: with no card
they raise unless the caller asks for ``device="cpu"``.
"""
