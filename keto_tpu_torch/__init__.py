"""keto_tpu_torch: the PyTorch + CUDA port of keto-tpu, for one NVIDIA H100.

It answers ``Check`` the way ``keto_tpu`` does — tuples are interned into a
bucketed reverse-ELL graph snapshot, a batch of queries runs as one
bit-packed breadth-first fixpoint on the card, and ``/check`` is served
over REST — with the device programs written by hand in CUDA C++
(``csrc/check_kernels.cu``). ``keto_tpu`` stays the reference: the tests
hold this package against it word for word on the CPU, where every kernel
wrapper takes its plain PyTorch version.

This package imports ``torch`` and ``numpy``, never ``jax``, and nothing of
``keto_tpu``: what it needs from the reference it keeps as its own copy.
Modules mirror ``keto_tpu``'s layout so each counterpart is easy to find.
"""

__version__ = "0.1.0"
