"""The reference's examples (counterpart of the repository's top-level
``examples/``), each a module that does nothing when imported:

  python -m repro_torch.examples.quickstart [--device cuda|cpu]
  python -m repro_torch.examples.precision_inv_demo [--device cuda|cpu]
  python -m repro_torch.examples.serve_batched [--device cuda|cpu]
  python -m repro_torch.examples.train_kfac_100m [--smoke] [--device ...]

``--device`` defaults to ``cuda`` and raises without CUDA; ``cpu`` runs
the kernels' plain versions.
"""
