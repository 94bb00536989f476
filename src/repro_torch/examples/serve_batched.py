"""Serving example (counterpart of ``examples/serve_batched.py``): the
continuous-batching engine on a mixed-length trace, run twice to check
that greedy decode is deterministic, then the static fixed-batch path,
on the reduced qwen2-family model, through the serving CLI
(``launch.serve.main``).

  python -m repro_torch.examples.serve_batched [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.launch.serve import main as serve_main


def run(device="cuda") -> dict:
    """The three CLI calls; returns each call's ``(summary, output)``."""
    dev = ["--device", str(device)]
    # continuous batching: 6 requests over 2 slots, staggered arrivals
    engine_args = [
        "--arch", "qwen2-0.5b", "--smoke",
        "--requests", "6", "--max-slots", "2",
        "--prompt-len", "24", "--gen", "8", "--decode-chunk", "4",
    ] + dev
    engine = serve_main(engine_args)
    again = serve_main(engine_args)
    # the fixed-batch path (A/B reference)
    static = serve_main([
        "--arch", "qwen2-0.5b", "--smoke", "--static",
        "--batch", "4", "--prompt-len", "32", "--gen", "12",
    ] + dev)
    return {"engine": engine, "engine_again": again, "static": static}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without CUDA) or cpu")
    out = run(ap.parse_args(argv).device)
    summary, done = out["engine"]
    assert summary["requests"] == 6
    # every request produced within its budget (trace budgets <= --gen)
    assert all(1 <= len(f.tokens) <= 8 for f in done.values())
    # deterministic greedy decode => re-running must reproduce
    _, done2 = out["engine_again"]
    for rid in done:
        assert done[rid].tokens == done2[rid].tokens, \
            "greedy decode must be deterministic"
    _, gen = out["static"]
    assert gen.shape == (4, 12)
    assert np.all(gen >= 0)
    print("serve_batched OK")
    return out


if __name__ == "__main__":
    main()
