"""The port's closed-form FLOP and byte model (``repro_torch.launch
.analytic``) and ``registry.all_cells`` against the JAX reference's, on
the CPU: every number equal (closed forms on the same config and the
same parameter count), for every (arch x shape) cell.
"""
import pytest

from repro.configs import registry as jax_registry
from repro.launch import analytic as jax_analytic
from repro.models import model_zoo as jax_zoo
from repro_torch.configs import registry
from repro_torch.launch import analytic
from repro_torch.models import model_zoo

CELLS = registry.all_cells()


def test_all_cells_match_reference():
    ref = jax_registry.all_cells()
    assert len(CELLS) == len(ref) == len(registry.ARCH_IDS) * 4
    for (a, cell, ok, why), (ra, rcell, rok, rwhy) in zip(CELLS, ref):
        assert (a, cell.name, cell.seq_len, cell.global_batch, cell.kind,
                ok, why) == (ra, rcell.name, rcell.seq_len,
                             rcell.global_batch, rcell.kind, rok, rwhy)


@pytest.mark.parametrize("arch_id", registry.ARCH_IDS)
def test_count_params_matches_reference(arch_id):
    assert model_zoo.count_params(registry.get(arch_id)) == \
        jax_zoo.count_params(jax_registry.get(arch_id))


@pytest.mark.parametrize("arch_id", registry.ARCH_IDS)
def test_analytic_matches_reference_for_every_cell(arch_id):
    cfg, jcfg = registry.get(arch_id), jax_registry.get(arch_id)
    cells = [c for a, c, _, _ in CELLS if a == arch_id]
    ref_cells = [c for a, c, _, _ in jax_registry.all_cells()
                 if a == arch_id]
    assert len(cells) == 4
    for cell, rcell in zip(cells, ref_cells):
        for fn in ("hlo_flops", "model_flops", "hbm_bytes"):
            got = getattr(analytic, fn)(cfg, cell)
            assert isinstance(got, float) and got > 0, (fn, cell.name)
            assert got == getattr(jax_analytic, fn)(jcfg, rcell), \
                (fn, cell.name)
        assert analytic._cache_bytes(cfg, cell.global_batch,
                                     cell.seq_len) == \
            jax_analytic._cache_bytes(jcfg, rcell.global_batch,
                                      rcell.seq_len)


def test_optimized_presets_keep_the_model_flops():
    """``get_optimized`` changes the MoE's dispatch and capacity, not the
    parameters: MODEL_FLOPS is the baseline's; the engineering FLOPs
    follow the capacity, as the reference's."""
    for arch_id in ("deepseek-v2-lite-16b", "kimi-k2-1t-a32b"):
        base, opt = registry.get(arch_id), registry.get_optimized(arch_id)
        jopt = jax_registry.get_optimized(arch_id)
        for _, cell, _, _ in (c for c in CELLS if c[0] == arch_id):
            assert analytic.model_flops(opt, cell) == \
                analytic.model_flops(base, cell)
            assert analytic.hlo_flops(opt, cell) < \
                analytic.hlo_flops(base, cell)
            assert analytic.hlo_flops(opt, cell) == \
                jax_analytic.hlo_flops(jopt, cell)
