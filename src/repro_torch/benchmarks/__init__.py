"""The paper's tables and figures and the single-device benchmarks
(counterpart of the repository's top-level ``benchmarks/``).

Each module exposes ``rows()`` (or ``rows_blocksize()`` and
``rows_writes()``), ``headline()`` where the paper states a value, and
``main()`` printing CSV. ``run`` drives them all:

  python -m repro_torch.benchmarks.run [--fast] [--device cuda|cpu] \\
      [--out-dir DIR]

The pimsim-backed modules (``soi_sizes``, ``area``, ``dse``, ``speedup``,
``energy``, ``mapping_impact``) print the model's numbers; ``soi_precision``
and ``inv_convergence`` are NumPy; ``kernel_bench``, ``kfac_convergence``,
``precision_ladder``, ``wu_fusion``, ``serve_engine``, ``serve_scale`` and
``obs_overhead`` run on the device they are given (``--device``), the
CUDA kernels on the card. A module's ``main(argv)`` writes its artifact
to ``--out`` (default ``bench_out/BENCH_<name>.json``), never to the
repository root.
"""
