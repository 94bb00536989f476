"""The paper's model of the RePAST accelerator (counterpart of
``repro.pimsim``; pure Python, copied with its imports renamed, so every
number is the reference's bit for bit).

  arch      ``RePASTConfig``: crossbar, sub-tile, tile and chip
            parameters, the area breakdown (Table II)
  crossbar  cycle and energy counts of one VMM or INV crossbar
            (Eqns. 10 and 14)
  nets      the benchmark networks' layer tables and SOI factor sizes
  mapping   the Sec. V mapping scheme (Fig. 9) and SOI crossbar
            occupation
  perf      epoch time and energy of RePAST, PipeLayer and the GPU
            baselines (Figs. 11-13)

Every number this package gives is the model's, from the paper's ReRAM
constants. ``perf.GPUModel`` is the paper's V100 baseline (125 TFLOP/s,
efficiencies 0.10 and 0.007), not a measurement of any card this port
runs on.
"""
