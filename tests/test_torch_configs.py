"""The port's pure-Python configuration and roofline modules against the
JAX package's: every architecture, its smoke config and every input shape
equal field for field, parameter counts and model FLOPs equal, roofline
terms equal on the same hardware model, and the engine's cost model
seeded from ``repro_torch.roofline.analysis.hash_cost_seed``."""
import dataclasses
import json
import math

import pytest
import torch

import repro.configs as ref_configs
import repro.roofline.analysis as ref_analysis
import repro_torch.configs as configs
import repro_torch.roofline.analysis as analysis
from repro_torch.core.crystal import CrystalGPU

ARCHS = sorted(ref_configs.REGISTRY)
SHAPES = [s.name for s in ref_configs.ALL_SHAPES]


def test_registry_names_equal():
    assert sorted(configs.REGISTRY) == ARCHS
    assert configs.ARCH_NAMES == ref_configs.ARCH_NAMES
    with pytest.raises(KeyError):
        configs.get_config("no-such-arch")


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_arch_config_equal(arch, smoke):
    get = "get_smoke_config" if smoke else "get_config"
    port = getattr(configs, get)(arch)
    ref = getattr(ref_configs, get)(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.param_count() == ref.param_count()
    assert port.active_param_count() == ref.active_param_count()
    assert port.resolved_head_dim == ref.resolved_head_dim


@pytest.mark.parametrize("shape", SHAPES)
def test_shape_equal(shape):
    assert dataclasses.asdict(configs.get_shape(shape)) == \
        dataclasses.asdict(ref_configs.get_shape(shape))


def test_model_flops_equal_for_every_pair():
    for arch in ARCHS:
        for shape in SHAPES:
            assert analysis.model_flops(arch, shape) == \
                ref_analysis.model_flops(arch, shape), (arch, shape)


def _record(arch, shape, n_devices, flops_scaled=None):
    rec = {"arch": arch, "shape": shape, "mesh": "single",
           "n_devices": n_devices,
           "cost": {"flops": 3.1e15, "bytes accessed": 7.4e11},
           "collectives": {"total_wire_bytes": 2.6e10}}
    if flops_scaled is not None:
        rec["flops_scaled"] = flops_scaled
        rec["bytes_scaled"] = 9.9e11
    return rec


@pytest.mark.parametrize("rec", [
    _record("llama3-8b", "train_4k", 1),
    _record("mixtral-8x7b", "prefill_32k", 4, flops_scaled=5.5e16),
    _record("mamba2-1.3b", "decode_32k", 1)], ids=["dense", "moe", "ssm"])
def test_roofline_terms_equal_on_the_port_hw(rec):
    hw = analysis.HW()
    ref_hw = ref_analysis.HW(peak_flops=hw.peak_flops, hbm_bw=hw.hbm_bw,
                             link_bw=hw.link_bw)
    assert analysis.roofline_terms(rec, hw) == \
        ref_analysis.roofline_terms(rec, ref_hw)
    assert analysis.format_table({"r": rec}, hw) == \
        ref_analysis.format_table({"r": rec}, ref_hw)


def test_hw_is_the_h100_data_sheet():
    hw = analysis.HW()
    assert (hw.peak_flops, hw.hbm_bw) == (989e12, 3.35e12)


def test_hash_cost_seed_positive_and_finite():
    assert sorted(analysis.HASH_OPS_PER_BYTE) == ["direct", "gear",
                                                  "sliding"]
    for kind in analysis.HASH_OPS_PER_BYTE:
        seed = analysis.hash_cost_seed(kind)
        assert set(seed) == {"sec_per_byte", "launch_overhead_s"}
        for v in seed.values():
            assert math.isfinite(v) and v > 0, (kind, seed)
    with pytest.raises(KeyError):
        analysis.hash_cost_seed("no-such-kind")


def test_engine_cost_model_starts_from_the_seeds():
    eng = CrystalGPU(devices=[torch.device("cpu")])
    try:
        snap = eng.cost.snapshot()
    finally:
        eng.shutdown()
    assert set(snap) == set(analysis.HASH_OPS_PER_BYTE)
    for kind, row in snap.items():
        seed = analysis.hash_cost_seed(kind)
        assert row["overhead_s"] == seed["launch_overhead_s"]
        assert row["sec_per_byte"] == seed["sec_per_byte"]
        assert row["observations"] == 0


def test_load_records_filters_tags(tmp_path):
    for stem in ("a__train_4k__single", "a__train_4k__single__opt"):
        (tmp_path / f"{stem}.json").write_text(json.dumps({"k": stem}))
    (tmp_path / "notes.txt").write_text("x")
    for tag in ("", "opt"):
        assert analysis.load_records(str(tmp_path), tag) == \
            ref_analysis.load_records(str(tmp_path), tag)
    assert list(analysis.load_records(str(tmp_path))) == \
        ["a__train_4k__single"]
    assert analysis.load_records(str(tmp_path / "missing")) == {}


def test_prefill_flops_and_decode_bytes_count_by_hand():
    cfg = configs.get_config("llama3-8b")
    d, H, K, hd, f, V, L = 4096, 32, 8, 128, 14336, 128256, 32
    B, S = 4, 4096
    per_token = 2 * d * hd * (2 * H + 2 * K) + 2 * 3 * d * f
    pairs = B * S * (S + 1) // 2
    want = L * (per_token * B * S + 4 * H * hd * pairs) + 2 * d * V * B
    assert analysis.prefill_flops(cfg, B, S) == want
    # a sliding window caps the pairs: mixtral's 4096 at S 4097
    mix = configs.get_config("mixtral-8x7b")
    full = analysis.prefill_flops(dataclasses.replace(mix, swa_window=0),
                                  1, 4097)
    assert full - analysis.prefill_flops(mix, 1, 4097) == \
        mix.num_layers * 4 * 32 * 128 * 1
    assert analysis.decode_weight_bytes(cfg, 2) == \
        2 * (cfg.param_count() - V * d)
    tied = configs.get_config("mamba2-1.3b")
    assert analysis.decode_weight_bytes(tied, 4) == 4 * tied.param_count()
    with pytest.raises(ValueError):
        analysis.decode_weight_bytes(mix, 2)


def test_train_step_flops_count_by_hand():
    """minicpm-2b at the chip run's batch 4 x 2048: forward = layers +
    causal attention + the head at the 2047 predicting positions;
    backward twice that; remat one more forward of the layers and
    attention."""
    cfg = configs.get_config("minicpm-2b")
    d, H, hd, f, V, L = 2304, 36, 64, 5760, 122753, 40
    B, S = 4, 2048
    layers = L * (2 * d * hd * 4 * H + 2 * 3 * d * f) * B * S
    attn = L * 4 * H * hd * B * S * (S + 1) // 2
    head = 2 * d * V * B * (S - 1)
    fwd = layers + attn + head
    assert analysis.train_step_flops(cfg, B, S, remat=False) == 3 * fwd
    assert analysis.train_step_flops(cfg, B, S) == 3 * fwd + layers + attn
    # a row longer than one query block recomputes attention once more,
    # with or without remat; a row of CE chunks recomputes the head
    S2 = 4097
    layers2 = L * (2 * d * hd * 4 * H + 2 * 3 * d * f) * S2
    attn2 = L * 4 * H * hd * S2 * (S2 + 1) // 2
    head2 = 2 * d * V * (S2 - 1)
    assert analysis.train_step_flops(cfg, 1, S2) == \
        3 * (layers2 + attn2 + head2) + layers2 + 2 * attn2 + head2
    # a frontend: only the text tokens predict
    vlm = configs.get_config("internvl2-2b")
    F = vlm.frontend_embeds
    assert analysis.train_step_flops(vlm, 1, 300, remat=False) - \
        analysis.train_step_flops(dataclasses.replace(vlm, frontend_embeds=0),
                                  1, 300, remat=False) == \
        3 * 2 * vlm.d_model * vlm.vocab_size * ((300 - F) - 299)
