"""Paper Table II: RePAST area breakdown (mm^2). Paper chip total:
87.1 mm^2 (22 tiles x (16 sub-tiles x (1 INV + 28 VMM)) + HyperTr.)."""

from __future__ import annotations

from repro_torch.pimsim.arch import RePASTConfig
from repro_torch.benchmarks.common import print_csv

PAPER = {"vmm_xb": 0.0879 / 28, "inv_xb": 0.0161,
         "subtile": 0.0879 + 0.0161 + 0.004 + 0.002 + 0.0006
         + 0.00174 + 0.0006,
         "tile": 1.80, "chip": 87.1}


def rows():
    cfg = RePASTConfig()
    bd = cfg.area_breakdown()
    out = []
    for k, v in bd.items():
        out.append({"component": k, "mm2": round(v, 4),
                    "paper_mm2": round(PAPER.get(k, float("nan")), 4)})
    return out


def headline(rs=None):
    cfg = RePASTConfig()
    return {"name": "table2_chip_area_mm2",
            "value": round(cfg.chip_area(), 1), "paper": 87.1}


def main():
    rs = rows()
    print_csv("table2_area", rs)
    print_csv("table2_headline", [headline(rs)])


if __name__ == "__main__":
    main()
