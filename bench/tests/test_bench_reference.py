"""The plain reference against the port's CPU path at ``reduced()``
sizes, on the benchmark's own weights: the full forward's logits, and
one MoE layer in float32, which agrees with the reference only where the
port's expert capacity drops no assignment (the reference, as the
published MoE, drops none)."""
import pytest
import torch

from bench.harness import spec, weights
from bench.reference import model as ref_model
from bench.tests import cpu_cell

ARCHS = ["deepseek-v2-lite-16b", "minicpm3-4b"]


def _small(arch, **moe):
    import dataclasses

    from repro_torch.configs import registry

    cfg = registry.get(arch).reduced()
    if moe and cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **moe))
    conf = spec.load_json(spec.BENCH / "configs" / f"{arch}.json")
    return cfg, dict(conf, **cpu_cell.conf_of(conf, cfg))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_agree(arch):
    """bf16 port against the f32 reference: the median logit within 2 %
    of the logits' spread, every logit within 30 % of it for the dense
    model, and 90 % of the argmaxes equal.  The port routes on bf16
    router logits, so a near-tie between two experts can go the other
    way in one token (the MoE's worst logit moves by the spread);
    the port's capacity is raised here so that it drops no assignment."""
    from repro_torch.models import model_zoo

    cpu_cell.program_env()
    cfg, conf = _small(arch, capacity_factor=4.0)
    params, ref_w = weights.make(cfg, 5, torch.device("cpu"))
    tokens = torch.randint(0, cfg.vocab_size, (3, 40),
                           generator=torch.Generator().manual_seed(5))
    with torch.inference_mode():
        port, _ = model_zoo.forward(cfg, params, {"tokens": tokens})
    ref = ref_model.Reference(conf, ref_w)
    want = ref.logits(tokens, list(range(40)))
    port, spread = port.float(), want.std()
    assert (port - want).abs().median() <= 0.02 * spread
    if cfg.moe is None:
        assert (port - want).abs().max() <= 0.3 * spread
    assert (port.argmax(-1) == want.argmax(-1)).float().mean() >= 0.9


def test_forward_misses_without_the_norm_scales():
    """The same comparison fails for a reference that skips the MLA
    latent norm's scale: the benchmark's norm scales are not ones."""
    from repro_torch.models import model_zoo

    cpu_cell.program_env()
    cfg, conf = _small("minicpm3-4b")
    params, ref_w = weights.make(cfg, 5, torch.device("cpu"))
    tokens = torch.randint(0, cfg.vocab_size, (3, 40),
                           generator=torch.Generator().manual_seed(5))
    with torch.inference_mode():
        port, _ = model_zoo.forward(cfg, params, {"tokens": tokens})
    for layer in ref_w["layers"]:
        layer["kv_norm"] = torch.ones_like(layer["kv_norm"])
    want = ref_model.Reference(conf, ref_w).logits(tokens, list(range(40)))
    assert (port.float() - want).abs().median() > 0.1 * want.std()


@pytest.mark.parametrize("capacity_factor", [4.0, 1.25])
def test_moe_layer_matches_only_without_drops(capacity_factor):
    """At a capacity that holds every assignment (4.0 = E / k here) the
    port's MoE layer is the reference's in float32; at the port's own
    1.25 it drops assignments and misses by far more than rounding."""
    from repro_torch.models import moe as moe_mod

    cfg, conf = _small("deepseek-v2-lite-16b",
                       capacity_factor=capacity_factor)
    assert cfg.moe.n_routed / cfg.moe.top_k == 4.0
    params, ref_w = weights.make(cfg, 3, torch.device("cpu"))
    layer = params["stack"]["groups"][0]["l0"]["ffn"]
    x = torch.randn(4, 24, cfg.d_model,
                    generator=torch.Generator().manual_seed(3))
    with torch.inference_mode():
        port, _ = moe_mod.moe_ffn(layer, x, cfg)
    lw = ref_model._f32(ref_w["layers"][1])
    want = ref_model.Reference(conf, ref_w).moe(x, lw["moe"])
    err = (port - want).abs().max() / want.abs().max()
    if capacity_factor == 4.0:
        assert err <= 1e-5
    else:
        assert err > 0.1


def test_reference_refuses_a_rope_scaling():
    _, conf = _small("minicpm3-4b")
    with pytest.raises(NotImplementedError):
        ref_model.Reference(dict(conf, rope_scaling={"type": "yarn"}), {})


def test_weights_cover_every_leaf_once():
    cfg, _ = _small("deepseek-v2-lite-16b")
    params, ref_w = weights.make(cfg, 1, torch.device("cpu"))
    leaves = [t for _, t in weights._leaves(params)]
    refs = weights._ref_tensors(ref_w)
    assert len(leaves) == len(refs) == len({id(t) for t in refs})
    again, _ = weights.make(cfg, 1, torch.device("cpu"))
    other, _ = weights.make(cfg, 2, torch.device("cpu"))
    a, b, c = (p["stack"]["groups"][0]["l0"]["ffn"]["w_up"]
               for p in (params, again, other))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_fp8_control_rounds():
    a = torch.randn(8, 64, generator=torch.Generator().manual_seed(0))
    b = torch.randn(64, 16, generator=torch.Generator().manual_seed(1))
    err = (ref_model.fp8_matmul(a, b) - a @ b).abs().max() / (a @ b).abs().max()
    assert 1e-3 < err < 0.1
