"""``repro_torch.pimsim`` against the reference's ``repro.pimsim``.

The port is the reference's pure-Python model copied with its imports
renamed, so every comparison here is exact (``==``): the reference's
own closed-form checks (``tests/test_kfac.py``: Eqn. 10/14 cycles, the
Fig. 9 mapping cases, occupation invariance) run against the port, and
every net's layer table, SOI factors, blocks and FLOPs, every
``perf.evaluate`` dict (also under changed ``RePASTConfig`` fields), the
Sec. V mapping choices and the pipeline bubble equal the reference's.
"""

from __future__ import annotations

import dataclasses
import importlib

import pytest

from repro.pimsim import arch as j_arch
from repro.pimsim import crossbar as j_xb
from repro.pimsim import mapping as j_mapping
from repro.pimsim import nets as j_nets
from repro.pimsim import perf as j_perf
from repro_torch.pimsim import arch as t_arch
from repro_torch.pimsim import crossbar as t_xb
from repro_torch.pimsim import mapping as t_mapping
from repro_torch.pimsim import nets as t_nets
from repro_torch.pimsim import perf as t_perf

NETS = sorted(j_nets.NETS)
# RePASTConfig fields the DSE and ablations move: crossbar ratio, tile
# count, converter widths, Loop-A iterations, crossbar size, utilization
CONFIGS = [
    {},
    dict(vmm_per_subtile=16, tiles_per_chip=30),
    dict(adc_bits=6, dac_bits=2, n_taylor=24),
    dict(xbar=128, cell_bits=2, vmm_utilization=0.2),
]


def _cfgs(kw):
    return (dataclasses.replace(j_arch.RePASTConfig(), **kw),
            dataclasses.replace(t_arch.RePASTConfig(), **kw))


# the reference's pimsim tests (tests/test_kfac.py), on the port

def test_eqn10_eqn14_cycles():
    c = t_arch.RePASTConfig()
    # Eqn. 10 with Q=16, Rdac=4, Radc=8, N=18: 18*(2*4*2 + 4) = 360
    assert t_xb.inv_cycles(c) == 360
    # Eqn. 14: 18*(2*4*2 + 2*4) = 432
    assert t_xb.inv_fused_cycles(c) == 432


def test_mapping_matches_paper_cases():
    """Fig. 9: a (1024, 256) -> fuse (8 xbars vs 16); a (256, 1024) ->
    materialize (1 xbar vs 8)."""
    c = t_arch.RePASTConfig()
    tall = t_mapping.mm_inv_choice(c, 1024, 256, block=1024)
    assert tall.fuse and tall.xbars == 8
    wide = t_mapping.mm_inv_choice(c, 256, 1024, block=1024)
    assert not wide.fuse and wide.xbars == 1


def test_occupation_block_invariance():
    """Sec. VI-E: with the mapping scheme, SOI crossbar occupation is
    asymptotically independent of block size."""
    c = t_arch.RePASTConfig()
    layer = ("conv", (512, 512, 3, 14, 14))    # cin k^2 = 4608, hw=196
    occ = [t_mapping.soi_xbar_occupation(c, layer, b) for b in
           (512, 1024, 2048, 4608)]
    assert max(occ) <= 2 * min(occ) + 1
    occ_nomap = [t_mapping.soi_xbar_occupation(c, layer, b, False)
                 for b in (512, 1024, 2048, 4608)]
    assert occ_nomap[-1] > 4 * occ_nomap[0]    # quadratic blowup


# the port against the reference, exactly

@pytest.mark.parametrize("name", NETS)
def test_net_tables_equal_reference(name):
    layers = t_nets.NETS[name]()
    assert layers == j_nets.NETS[name]()
    for layer in layers:
        a, g = t_nets.soi_factors(layer)
        assert (a, g) == j_nets.soi_factors(layer)
        for block in (256, 1024):
            assert t_nets.soi_blocks(a, block) == j_nets.soi_blocks(a, block)
            assert t_nets.soi_blocks(g, block) == j_nets.soi_blocks(g, block)
        assert t_nets.layer_flops(layer) == j_nets.layer_flops(layer)


@pytest.mark.parametrize("kw", CONFIGS, ids=lambda kw: "-".join(kw) or
                         "default")
@pytest.mark.parametrize("name", NETS)
def test_evaluate_equals_reference(name, kw):
    jc, tc = _cfgs(kw)
    assert t_perf.evaluate(name, tc) == j_perf.evaluate(name, jc)


@pytest.mark.parametrize("block,use_mapping", [(64, True), (256, False),
                                               (4608, True)])
def test_evaluate_block_and_mapping_equal_reference(block, use_mapping):
    for name in NETS:
        assert (t_perf.evaluate(name, block=block, use_mapping=use_mapping)
                == j_perf.evaluate(name, block=block,
                                   use_mapping=use_mapping))


@pytest.mark.parametrize("kw", CONFIGS, ids=lambda kw: "-".join(kw) or
                         "default")
def test_config_derived_values_equal_reference(kw):
    jc, tc = _cfgs(kw)
    assert tc.area_breakdown() == jc.area_breakdown()
    assert (tc.chip_area(), tc.tile_area()) == (jc.chip_area(),
                                                jc.tile_area())
    assert (t_xb.vmm_cycles(tc), t_xb.inv_cycles(tc),
            t_xb.inv_fused_cycles(tc)) == (j_xb.vmm_cycles(jc),
                                           j_xb.inv_cycles(jc),
                                           j_xb.inv_fused_cycles(jc))
    for block in (128, 512, 1024):
        assert (t_xb.inv_group_xbars(tc, block)
                == j_xb.inv_group_xbars(jc, block))


@pytest.mark.parametrize("name", NETS)
def test_mapping_choices_equal_reference(name):
    jc, tc = _cfgs({})
    for layer in t_nets.NETS[name]():
        assert (dataclasses.asdict(t_mapping.wu_choice(tc, layer))
                == dataclasses.asdict(j_mapping.wu_choice(jc, layer)))
        for block in (256, 1024):
            for use in (True, False):
                assert (t_mapping.soi_xbar_occupation(tc, layer, block, use)
                        == j_mapping.soi_xbar_occupation(jc, layer, block,
                                                         use))


def test_mm_inv_choice_grid_equals_reference():
    jc, tc = _cfgs({})
    for m in (64, 256, 1000, 1024, 4608):
        for n in (27, 256, 1024, 3072):
            for block in (256, 1024):
                assert (dataclasses.asdict(t_mapping.mm_inv_choice(
                    tc, m, n, block=block))
                        == dataclasses.asdict(j_mapping.mm_inv_choice(
                            jc, m, n, block=block)))


def test_pipeline_bubble_fraction_grid():
    for s in range(1, 9):
        for m in (1, 2, 3, 4, 8, 16, 64):
            assert (t_perf.pipeline_bubble_fraction(s, m)
                    == j_perf.pipeline_bubble_fraction(s, m)
                    == (s - 1) / (m + s - 1))
    for bad in ((0, 4), (4, 0)):
        with pytest.raises(ValueError, match="n_stages"):
            t_perf.pipeline_bubble_fraction(*bad)


@pytest.mark.parametrize("module", ["arch", "crossbar", "nets", "mapping",
                                    "perf"])
def test_module_is_the_reference_with_imports_renamed(module):
    """The copy differs from the reference's source only in the package
    its imports name."""
    def source(mod):
        with open(mod.__file__) as f:
            return f.read()

    j_src = source(importlib.import_module(f"repro.pimsim.{module}"))
    t_src = source(importlib.import_module(f"repro_torch.pimsim.{module}"))
    assert t_src == j_src.replace("repro.pimsim", "repro_torch.pimsim")
