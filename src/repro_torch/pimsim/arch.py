"""RePAST architecture model: tiles, sub-tiles, crossbars, area, energy.

Constants follow the paper's evaluation setup (Sec. VI-A/B, Table II):
256x256 crossbars, 4-bit cells, 8-bit ADC / 4-bit DAC, 1 INV + 28 VMM
crossbars per sub-tile, 16 sub-tiles per tile (=> max 1024x1024 INV
block), 22 tiles per chip, 8 chips, 100 ns crossbar cycle, eDRAM 512 kB
per tile. Energy constants are drawn from the cited component papers
([26] ADC, [40] DAC, [21] crossbar, [37] OpAmp, CACTI for eDRAM) scaled
to 28 nm — the same sources the paper uses.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RePASTConfig:
    xbar: int = 256                  # crossbar rows/cols
    cell_bits: int = 4
    adc_bits: int = 8
    dac_bits: int = 4
    q_bits: int = 16                 # SOI matrix/vector precision
    n_taylor: int = 18               # Loop A iterations (Fig. 4b)
    vmm_per_subtile: int = 28        # DSE optimum (Fig. 10)
    inv_per_subtile: int = 1
    subtiles_per_tile: int = 16      # => INV group up to 1024x1024
    tiles_per_chip: int = 22
    n_chips: int = 8
    cycle_ns: float = 100.0
    edram_kb: int = 512
    bus_bits: int = 256
    # Fraction of VMM crossbars concurrently active: ADC sharing, power
    # envelope and pipeline bubbles (calibrated so the PipeLayer substrate
    # lands at its reported GPU-relative speedup, [44]).
    vmm_utilization: float = 0.07

    # ---- area (mm^2), Table II ----
    area_adc: float = 0.00236        # 8b 1.2 GS/s, 256 units
    area_dac: float = 0.00068        # 4b, 256 units
    area_xbar: float = 0.0001        # one 256x256 array
    area_opamp_grp: float = 0.0128   # 512 OpAmps
    area_vmm_xb: float = 0.0879 / 28  # per VMM crossbar incl. periphery
    area_inv_xb: float = 0.0161
    area_ir: float = 0.004
    area_or: float = 0.002
    area_act: float = 0.0006
    area_sa: float = 0.00174
    area_mul: float = 0.0006
    area_edram: float = 0.898
    area_bus: float = 0.218
    area_ht: float = 22.9

    # ---- energy (pJ) ----
    e_adc_conv: float = 2.6          # [26]: 3.1 mW @ 1.2 GS/s
    e_dac_conv: float = 0.12         # [40] 4-bit cap DAC
    e_xbar_read_row: float = 0.4     # [21] per-row dot-product activation
    e_xbar_write_cell: float = 3.0   # ReRAM SET/RESET
    e_opamp_cycle: float = 1.1       # [37] per OpAmp per settle
    e_edram_bit: float = 0.05        # CACTI 7, 28 nm
    e_bus_bit: float = 0.02
    e_ht_bit: float = 1.4            # HyperTransport, [41]

    @property
    def vmm_xbars_per_tile(self) -> int:
        return self.vmm_per_subtile * self.subtiles_per_tile

    @property
    def inv_xbars_per_tile(self) -> int:
        return self.inv_per_subtile * self.subtiles_per_tile

    @property
    def max_inv_block(self) -> int:
        import math
        g = int(math.isqrt(self.inv_xbars_per_tile))
        return g * self.xbar

    def subtile_area(self) -> float:
        return (self.vmm_per_subtile * self.area_vmm_xb
                + self.inv_per_subtile * self.area_inv_xb
                + self.area_ir + self.area_or + self.area_act
                + self.area_sa + self.area_mul)

    def tile_area(self) -> float:
        return (self.subtiles_per_tile * self.subtile_area()
                + self.area_edram + self.area_bus)

    def chip_area(self) -> float:
        return self.tiles_per_chip * self.tile_area() + self.area_ht

    def area_breakdown(self) -> dict:
        return {
            "vmm_xb": self.area_vmm_xb,
            "inv_xb": self.area_inv_xb,
            "subtile": self.subtile_area(),
            "tile": self.tile_area(),
            "chip": self.chip_area(),
        }

    # ---- per-op energies (nJ) ----
    def e_vmm_op(self) -> float:
        """One 256x256 crossbar VMM pass (256 DAC + read + 256 ADC)."""
        n = self.xbar
        return (n * self.e_dac_conv + n * self.e_xbar_read_row
                + n * self.e_adc_conv) * 1e-3

    def e_inv_op(self, n_xbars: int = 1) -> float:
        """One INV settle across an n_xbars group (OpAmps + converters)."""
        n = self.xbar
        return (n_xbars * (2 * n * self.e_opamp_cycle
                           + n * self.e_xbar_read_row)
                + n * self.e_dac_conv + n * self.e_adc_conv) * 1e-3

    def e_write_xbar(self) -> float:
        """Program one full crossbar (nJ)."""
        return self.xbar * self.xbar * self.e_xbar_write_cell * 1e-3
