"""Paper Table I: min/max SOI matrix sizes per benchmark network,
in the paper's ``bB+r`` format (b blocks of 1024 + one r x r rest)."""

from __future__ import annotations

from repro_torch.pimsim import nets
from repro_torch.benchmarks.common import print_csv

# paper Table I reference values: net -> (min_layer, max_layer) with
# (A_blocks, A_rest, G_blocks, G_rest)
PAPER = {
    "vgg19": ((0, 27, 0, 64), (4, 512, 0, 512)),
    "msra2": ((0, 147, 0, 96), (4, 512, 0, 512)),
    "resnet50": ((0, 64, 0, 64), (4, 512, 0, 512)),
    "bert": ((0, 768, 0, 64), (3, 0, 0, 768)),
}


def rows(block: int = 1024):
    out = []
    for name, make in nets.NETS.items():
        net = make()
        sized = []
        for layer in net:
            a, g = nets.soi_factors(layer)
            sized.append((a * a + g * g, layer, a, g))
        sized.sort()
        for tag, (_, layer, a, g) in (("min", sized[0]),
                                      ("max", sized[-1])):
            ab, ar = nets.soi_blocks(a, block)
            gb, gr = nets.soi_blocks(g, block)
            out.append({
                "net": name, "which": tag,
                "layer": f"{layer[0]}{layer[1][:2]}",
                "A": f"{ab}B+{ar}", "G": f"{gb}B+{gr}",
                "paper_A": _paper(name, tag, 0),
                "paper_G": _paper(name, tag, 1),
            })
    return out


def _paper(name, tag, side):
    if name not in PAPER:
        return ""
    vals = PAPER[name][0 if tag == "min" else 1]
    b, r = vals[2 * side], vals[2 * side + 1]
    return f"{b}B+{r}"


def main():
    print_csv("table1_soi_sizes", rows())


if __name__ == "__main__":
    main()
