"""Probes: measurements of one question on the card, run as scripts.

* :mod:`celerite2_torch.probes.transpose`: what moving planes into the
  fused slab's (sublane, lane) layout costs beside a copy and PyTorch's
  own transposes (the counterpart of ``benchmarks/probe_transpose_tpu.py``).

A probe is not a benchmark: it prints its readings and returns them to its
caller, and nothing of the library calls it.
"""
