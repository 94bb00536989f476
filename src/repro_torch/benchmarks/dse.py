"""Paper Fig. 10: design-space exploration of the VMM:INV crossbar
ratio per sub-tile, metric = average computational efficiency
(GOPS/mm^2) across the benchmark nets. Paper optimum: 28 VMM / 1 INV
(722.1 GOPS/mm^2)."""

from __future__ import annotations

import dataclasses

from repro_torch.pimsim import nets, perf
from repro_torch.pimsim.arch import RePASTConfig
from repro_torch.benchmarks.common import print_csv


def _gops_per_mm2(cfg: RePASTConfig) -> float:
    total = 0.0
    for name, make in nets.NETS.items():
        net = make()
        rp = perf.RePASTModel(cfg)
        t = rp.step_time(net)
        ops = sum(2 * 3 * nets.layer_flops(l) for l in net) * perf.BATCH
        total += ops / t / 1e9
    avg = total / len(nets.NETS)
    return avg / (cfg.n_chips * cfg.chip_area())


def _feasible(cfg: RePASTConfig) -> bool:
    """Paper Fig. 10: "when #VMM/#INV is larger than 32, the INV
    crossbar number is not large enough to arrange large NNs, e.g.
    VGG-19". At a fixed chip-area budget, fatter sub-tiles mean fewer
    tiles, hence fewer INV crossbars; the chip must still host the
    largest net's SOI occupation concurrently."""
    from repro_torch.pimsim import mapping

    budget = RePASTConfig().chip_area()      # paper's 87.1 mm^2 budget
    tiles = max(int((budget - cfg.area_ht) / cfg.tile_area()), 1)
    inv_total = cfg.n_chips * tiles * cfg.inv_xbars_per_tile
    # A and G factors both resident (Sec. VI-A keeps SOI programmed);
    # A_H spans k=2 chained 4-bit crossbars per position (Sec. III)
    need = 2 * (
        sum(mapping.soi_xbar_occupation(cfg, l, 1024, True)
            for l in nets.vgg19())
        + sum((-(-g // cfg.xbar)) ** 2 for _, g in
              (nets.soi_factors(l) for l in nets.vgg19())))
    # one calibrated constant: Sec. IV-A's block-size flexibility lets
    # ~20% of the SOI occupancy be trimmed to fit ("we can always use
    # the proper SOI matrix sizes to fulfill the limitation")
    return inv_total >= 0.8 * need


def rows():
    out = []
    for n_vmm in (4, 8, 12, 16, 20, 24, 28, 32, 40, 48):
        cfg = dataclasses.replace(RePASTConfig(), vmm_per_subtile=n_vmm)
        budget = RePASTConfig().chip_area()
        tiles = max(int((budget - cfg.area_ht) / cfg.tile_area()), 1)
        cfg = dataclasses.replace(cfg, tiles_per_chip=tiles)
        feasible = _feasible(cfg)
        out.append({"vmm_per_inv": n_vmm,
                    "tiles_at_area_budget": tiles,
                    "feasible_vgg19": feasible,
                    "gops_per_mm2":
                        round(_gops_per_mm2(cfg), 1) if feasible
                        else ""})
    return out


def headline(rs=None):
    rs = rs or rows()
    cands = [r for r in rs if r["feasible_vgg19"]]
    best = max(cands, key=lambda r: r["gops_per_mm2"])
    return {"name": "fig10_best_vmm_per_inv",
            "value": best["vmm_per_inv"], "paper": 28,
            "gops_mm2": best["gops_per_mm2"], "paper_gops_mm2": 722.1}


def main():
    rs = rows()
    print_csv("fig10_dse", rs)
    print_csv("fig10_headline", [headline(rs)])


if __name__ == "__main__":
    main()
