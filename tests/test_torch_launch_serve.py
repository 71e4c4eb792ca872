"""The port's launch presets equal the JAX package's for every
architecture and preset, and ``python -m repro_torch.launch.serve`` runs
on the CPU when asked (and refuses the default card when there is
none)."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.configs import ARCH_NAMES
from repro.launch.train import preset_config as ref_preset
from repro_torch.launch import serve
from repro_torch.launch.presets import preset_config

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("preset", ["smoke", "100m", "full"])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_preset_config_equal(arch, preset):
    assert dataclasses.asdict(preset_config(arch, preset)) == \
        dataclasses.asdict(ref_preset(arch, preset))


def test_unknown_preset_raises():
    with pytest.raises(ValueError):
        preset_config("llama3-8b", "7b")


def test_serve_cli_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "mixtral-8x7b", "--preset", "smoke", "--batch", "2",
         "--prompt-len", "16", "--new-tokens", "4", "--device", "cpu"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0] == "arch=mixtral-8x7b batch=2 prompt=16 new=4"
    assert lines[1].startswith("prefill: ") and "tok/s" in lines[1]
    assert lines[2].startswith("decode:  ") and "tok/s" in lines[2]
    assert lines[3].startswith("sample continuation: [")
    assert len(eval(lines[3].split(": ", 1)[1])) == 4


def test_serve_param_dtype(capsys):
    serve.main(["--arch", "llama3-8b", "--preset", "smoke", "--batch", "1",
                "--prompt-len", "8", "--new-tokens", "2", "--device", "cpu",
                "--param-dtype", "bfloat16"])
    assert "arch=llama3-8b batch=1 prompt=8 new=2" in capsys.readouterr().out


def test_serve_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--preset", "smoke"])


def test_serve_times_each_step_of_greedy_generate():
    """``serve`` is ``greedy_generate`` after a warm-up: the same tokens,
    one time per decode step, and ``on_step`` called once per token."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import build_model
    from repro_torch.serve.servestep import greedy_generate
    model = build_model(get_smoke_config("llama3-8b"), device="cpu").init(
        torch.Generator().manual_seed(0))
    prompts = torch.randint(0, model.cfg.vocab_size, (2, 12),
                            generator=torch.Generator().manual_seed(1))
    seen = []
    want = greedy_generate(model, prompts, 5,
                           on_step=lambda i, lg: seen.append((i, lg.shape)))
    assert seen == [(i, (2, model.cfg.vocab_size)) for i in range(5)]
    res = serve.serve(model, prompts, 5)
    assert torch.equal(res["tokens"], want)
    assert len(res["step_s"]) == 4 and res["prefill_s"] > 0
    assert all(t > 0 for t in res["step_s"]) and res["host_cpu_s"] >= 0
    assert res["logits"].shape == (2, model.cfg.vocab_size)
