"""Measurements of the port's kernels on the card, beyond ``chip_smoke.py``:
each module runs on a CUDA card with ``python -m repro_torch.probes.<name>``
(``PYTHONPATH=src``, from the repository root) and prints JSON.

  * `gemv_phases`: where a block of the fused chain's GEMV kernels spends
    its time, from ``%globaltimer`` stamps at the ``// phase-stamp``
    marks of ``kernels/csrc/fused_decode.cu``.
  * `read_pattern`: how fast the card reads a GEMV's weights, for blocks
    that stream column strips of several widths, against the port's
    out_residual kernel and ``torch.addmm``.
  * `ssd_phases`: where a block of the bf16 SSD scan spends its time, from
    SM clock stamps at the ``// phase-stamp`` marks of
    ``kernels/csrc/ssd_scan.cu``, and what splitting its y products' W and
    S operands into bf16 hi + lo costs in time and saves in error.
  * `lm_pipe_lanes`: where a pipelined training run's time goes, by the
    number of lane threads, beside ``overlap=False`` and the sequential
    oracle, with what the caching allocator did meanwhile.
  * `busy`: the device's busy time in a profiler trace (the union of its
    kernel intervals over all streams), shared with ``chip_smoke.py``.

Nothing here is imported by the package or runs on the serving path.
"""
