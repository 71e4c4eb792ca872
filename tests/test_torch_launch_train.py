"""The port's training CLI (``python -m repro_torch.launch.train``) on
the CPU: the JAX package's printed lines, a step-time summary with the
issuing thread's CPU share, a failure injected and recovered from a
content-addressable checkpoint through the offload engine's plain
versions, and the default device (the card) refused without one."""
import pytest
import torch

import repro_torch.core as core
from repro_torch.launch import presets
from repro_torch.launch import train as train_cli
from repro_torch.train import CACheckpointer

SMOKE = ["--arch", "llama3-8b", "--preset", "smoke", "--batch", "2",
         "--seq", "64", "--device", "cpu"]


def test_cli_trains_on_the_cpu(capsys):
    out = train_cli.main(SMOKE + ["--steps", "6", "--ckpt-every", "0"])
    text = capsys.readouterr().out
    assert "arch=llama3-8b preset=smoke params=0.1M" in text
    assert "steps=6 " in text and "restarts=0 stragglers=" in text
    assert "throughput=" in text and "ckpt step=" not in text
    assert "train steps: median" in text and "after 2 warm-up steps " \
        "(host clock)" in text and "of their time" in text
    assert out["checkpointer"] is None and out["store"] is None
    assert len(out["step_s"]) == len(out["host_cpu_s"]) == 6
    assert all(t > 0 for t in out["step_s"])
    assert out["losses"][-1] < out["losses"][0]
    assert out["losses"] == [r["loss"] for r in out["supervisor"].log]
    assert all(g > 0 for g in out["grad_norms"])


def test_cli_restarts_from_a_checkpoint(capsys, monkeypatch):
    """``--fail-at``: one restart from the last checkpoint, which the SAI
    wrote through a CPU ``CrystalGPU`` (4 KiB chunks here, so that the
    plain MD5 stays quick)."""
    small = dict(avg_chunk=4 << 10, min_chunk=1 << 10, max_chunk=8 << 10)
    monkeypatch.setattr(train_cli, "SAIConfig",
                        lambda **kw: core.SAIConfig(**{**kw, **small}))
    out = train_cli.main(SMOKE + ["--steps", "9", "--ckpt-every", "3",
                                  "--fail-at", "7"])
    text = capsys.readouterr().out
    sup = out["supervisor"]
    assert sup.restarts == 1 and "restarts=1 " in text
    steps = [r["step"] for r in sup.log]
    assert steps == [0, 1, 2, 3, 4, 5, 6, 6, 7, 8]
    assert [r["step"] for r in out["checkpointer"].history] == [3, 6, 9]
    assert text.count("ckpt step=") == 3 and "store: {" in text
    # the CLI shut its engine down: a new one reads the store back
    eng = core.CrystalGPU(devices=[torch.device("cpu")])
    try:
        sai = core.SAI(out["store"], core.SAIConfig(ca="cdc-gear", **small),
                       crystal=eng)
        step, state, _ = CACheckpointer(sai).restore()
    finally:
        eng.shutdown()
    assert step == 9
    assert torch.equal(state["params"]["embed"], out["model"].embed.detach())
    assert torch.equal(state["opt"]["mu"]["embed"],
                       out["opt_state"]["mu"]["embed"])


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(SMOKE[:-2] + ["--steps", "1", "--ckpt-every", "0"])


def test_preset_config_is_reexported():
    assert train_cli.preset_config is presets.preset_config
